"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts
top-2; the reference's ``repro/configs/jamba_v01_52b.py``. One Jamba block
is 8 layers with a single attention layer (position 4) and MoE on every
other FFN.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe", "dense", "moe",
                 "dense", "moe", "dense", "moe"),
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    ssm_expand=2,
    ssm_state_dim=16,
    conv_kernel=4,
    dispatch_groups=16,
    long_context_window=8192,
)
