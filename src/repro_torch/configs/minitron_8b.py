"""minitron-8b [dense] — pruned nemotron [arXiv:2407.14679].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, squared-ReLU
FFNs with no gate (``ffn_act="relu2"``: ``w_in`` and ``w_out`` only); the
reference's ``repro/configs/minitron_8b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    ffn_act="relu2",
    long_context_window=8192,
)
