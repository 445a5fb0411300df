"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2; the
reference's ``repro/configs/arctic_480b.py``. Every layer has a dense
residual FFN in parallel with the routed-expert FFN (ffn kind
"moe+dense").
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=("attn",),
    ffn_pattern=("moe+dense",),
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dispatch_groups=16,
    long_context_window=8192,
)
