# Copy of src/repro/configs/qwen2_vl_72b.py (commit 9368fdf); imports may differ.
"""Qwen2-VL-72B backbone [arXiv:2409.12191]. Vision frontend is a stub:
input_specs() supplies precomputed patch embeddings; M-RoPE implemented."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
    qkv_bias=True, m_rope=True, rope_theta=1e6)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=128, vocab=512)
