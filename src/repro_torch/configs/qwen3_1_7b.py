# Copy of src/repro/configs/qwen3_1_7b.py (commit 9368fdf); imports may differ.
"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family]: qk_norm + GQA, head_dim 128."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=8, d_head=128, d_ff=6144, vocab=151936,
    qk_norm=True, rope_theta=1e6)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512)
