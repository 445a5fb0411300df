"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905].

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064; the reference's
``repro/configs/phi4_mini_38b.py``, pure data parallel on the production
mesh as there.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    long_context_window=8192,
    pure_data_parallel=True,
)
