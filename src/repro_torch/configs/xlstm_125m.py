# Copy of src/repro/configs/xlstm_125m.py (commit 9368fdf); imports may differ.
"""xLSTM-125M [arXiv:2405.04517]: mLSTM blocks with an sLSTM every 4th
layer (12 = 3 x (3 mLSTM + 1 sLSTM)). d_ff=0: no separate MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", block="xlstm", n_layers=12,
    d_model=768, n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    slstm_every=4)

SMOKE = CONFIG.scaled(n_layers=4, slstm_every=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_head=16, vocab=512)
