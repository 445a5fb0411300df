"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32: full multi-head attention) d_ff=13440
vocab=92416, ``rope_theta`` 1e6; the reference's
``repro/configs/codeqwen15_7b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1000000.0,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    long_context_window=8192,
)
