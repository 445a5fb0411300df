"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B LM [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655; the reference's
``repro/configs/internvl2_1b.py``. The vision encoder is a stub, as in the
reference: a batch carries 256 precomputed patch embeddings (B, 256,
d_model), which a learned projector (``proj``) maps into the LM space in
front of the token embeddings. The reference's ``pure_data_parallel``
sharding field has no counterpart on one device (ROADMAP.md Queue 1 item
12).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    frontend="vision",
    num_prefix_tokens=256,
    long_context_window=8192,
)
