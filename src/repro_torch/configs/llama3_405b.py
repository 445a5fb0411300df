"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256, with the
reference's two-level remat over 9 groups of 14 superblocks
(``scan_groups=9``); the reference's ``repro/configs/llama3_405b.py``. Its
bf16 weights alone are about 810 GB: the port runs it at its ``-smoke``
size and on the meta device.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    long_context_window=8192,
    scan_groups=9,
)
