"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304; the reference's
``repro/configs/xlstm_350m.py``. xLSTM blocks carry their own up/down
projections, so there is no separate FFN (ffn_pattern "none"); the
mLSTM:sLSTM ratio is 3:1, tiled over 24 layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    ffn_pattern=("none", "none", "none", "none"),
    mlstm_proj_factor=2.0,
    slstm_ffn_factor=4.0 / 3.0,
    long_context_window=None,  # recurrent: O(1) state, no window needed
)
