# Copy of src/repro/configs/zamba2_7b.py (commit 9368fdf); imports may differ.
"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + one *shared* attention
block applied every 6 layers (81 = 13x6 + 3 tail). The shared attention
uses a 4096 sliding window so long_500k decode stays O(1) state."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", block="mamba2", n_layers=81,
    d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_headdim=64, attn_every=6)

SMOKE = CONFIG.scaled(n_layers=7, attn_every=3, d_model=64, n_heads=4,
                      n_kv_heads=4, d_head=16, d_ff=128, vocab=512,
                      ssm_state=8, ssm_headdim=16)
