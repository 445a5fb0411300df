"""Federated LM fine-tuning scenario configs (the AsyncFedED regime).

The reference's ``repro/configs/fed_lm.py``: a CPU-trainable dense
transformer that the policy servers fine-tune end to end on a
document-partitioned token corpus (``launch.train --arch fed-lm-smoke``,
pinned by ``tests/golden/fed-lm-smoke.json``), in float32. Its state-space
and mixture-of-experts siblings (``fed-lm-ssm-smoke``,
``fed-lm-moe-smoke``) need the ssm and moe families, which are not ported
(ROADMAP.md Queue 1 item 10c): ``configs.get_config`` raises for them.
"""
from repro_torch.models.config import ModelConfig

CONFIGS = {
    "fed-lm-smoke": ModelConfig(
        name="fed-lm-smoke", family="dense", num_layers=2, d_model=16,
        num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=32,
        block_pattern=("attn",), ffn_pattern=("dense",), dtype="float32",
        param_dtype="float32", remat="none", q_chunk=64, kv_chunk=64,
        pad_vocab_to=32),
}

# the reference's other fed-lm scenarios and the family each needs
UNPORTED = {"fed-lm-ssm-smoke": "ssm", "fed-lm-moe-smoke": "moe"}
