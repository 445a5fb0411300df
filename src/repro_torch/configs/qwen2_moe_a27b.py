"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=151936, 60 experts
top-4 with renormalized gates plus 4 always-on shared experts (shared path
d_ff = 4*1408 = 5632); the reference's ``repro/configs/qwen2_moe_a27b.py``:
60 experts do not divide the production mesh's model axis, so each
expert's d_ff is tensor-parallel instead (``expert_tensor_parallel``).
``dispatch_groups=16`` is kept: the capacity is per group, so it decides
which tokens drop.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    block_pattern=("attn",),
    ffn_pattern=("moe",),
    num_experts=60,
    top_k=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    dispatch_groups=16,
    long_context_window=8192,
    expert_tensor_parallel=True,
)
