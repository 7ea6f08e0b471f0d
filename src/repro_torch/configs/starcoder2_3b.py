# Copy of src/repro/configs/starcoder2_3b.py (commit 9368fdf); imports may differ.
"""StarCoder2-3B [arXiv:2402.19173]: GQA kv=2, RoPE, GELU MLP."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    act="gelu", rope_theta=1e5, qkv_bias=True)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512)
