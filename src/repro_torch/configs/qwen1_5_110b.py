# Copy of src/repro/configs/qwen1_5_110b.py (commit 9368fdf); imports may differ.
"""Qwen1.5-110B [hf:Qwen family]: QKV bias, GQA kv=8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064,
    qkv_bias=True, rope_theta=1e6)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=192, vocab=512)
