# Copy of src/repro/configs/mixtral_8x7b.py (commit 9368fdf); imports may differ.
"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window 4096."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
    n_experts=8, moe_top_k=2, d_ff_expert=14336, swa_window=4096,
    rope_theta=1e6)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, d_ff_expert=128, vocab=512,
                      swa_window=64)
