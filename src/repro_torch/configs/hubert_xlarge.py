"""hubert-xlarge [audio] — encoder-only, w2v2 arch [arXiv:2106.07447].

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-cluster
prediction classes); the reference's ``repro/configs/hubert_xlarge.py``.
Encoder-only: bidirectional attention, layernorm, no decode step. The conv
feature extractor is a stub, as in the reference: a batch carries
precomputed frame embeddings (B, S, d_model), which ``in_proj`` maps in,
and a ``cls`` head gives per-frame logits. The reference's
``pure_data_parallel`` sharding field has no counterpart on one device
(ROADMAP.md Queue 1 item 12).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    block_pattern=("attn",),
    ffn_pattern=("dense",),
    ffn_act="gelu",
    frontend="audio",
    long_context_window=None,
)
