"""Federated LM fine-tuning scenario configs (the AsyncFedED regime).

The reference's ``repro/configs/fed_lm.py``: one CPU-trainable smoke
instance per non-paper token family, which the policy servers fine-tune end
to end on a document-partitioned token corpus (``launch.train --arch
fed-lm-smoke``, pinned by ``tests/golden/fed-lm-smoke.json``), in float32:
a dense transformer, a state-space backbone (mamba mixer) and a
mixture-of-experts FFN. The MoE one keeps its objective row-decoupled, so
the cohort engine's masked padding rows are exact no-ops: capacity_factor
>= E/top_k (no token drops, so each token's output depends only on its own
routing) and router_aux_coef = 0 (the Switch load-balance term sums over
all of a batch's tokens, padded rows included).
"""
from repro_torch.models.config import ModelConfig


def _lm(name: str, family: str, **kw) -> ModelConfig:
    defaults = dict(
        num_layers=2, d_model=16, num_heads=2, num_kv_heads=2, d_ff=32,
        vocab_size=32, block_pattern=("attn",), ffn_pattern=("dense",),
        dtype="float32", param_dtype="float32", remat="none",
        q_chunk=64, kv_chunk=64, pad_vocab_to=32,
    )
    defaults.update(kw)
    return ModelConfig(name=name, family=family, **defaults)


CONFIGS = {
    "fed-lm-smoke": _lm("fed-lm-smoke", "dense"),
    "fed-lm-ssm-smoke": _lm("fed-lm-ssm-smoke", "ssm",
                            block_pattern=("mamba",), ssm_state_dim=8),
    "fed-lm-moe-smoke": _lm("fed-lm-moe-smoke", "moe",
                            ffn_pattern=("moe",), d_ff=0,
                            num_experts=4, top_k=2, moe_d_ff=16,
                            capacity_factor=2.0, router_aux_coef=0.0),
}
