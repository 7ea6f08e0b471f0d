# Copy of src/repro/configs/deepseek_moe_16b.py (commit 9368fdf); imports may differ.
"""DeepSeek-MoE-16B [arXiv:2401.06066]: 2 shared + 64 routed experts,
top-6, fine-grained (d_ff_expert=1408)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, moe_top_k=6, d_ff_expert=1408,
    rope_theta=1e4)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      d_head=16, d_ff=96, d_ff_expert=96, n_experts=8,
                      moe_top_k=2, vocab=512)
