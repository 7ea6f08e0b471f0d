# Copy of src/repro/configs/whisper_medium.py (commit 9368fdf); imports may differ.
"""Whisper-medium [arXiv:2212.04356]: 24-layer encoder + 24-layer decoder
with cross attention. Conv frontend is a stub (input_specs() provides
precomputed frame embeddings); learned positions are replaced by a
sinusoid (encoder) / RoPE (decoder) stub — noted in DESIGN.md."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", enc_dec=True,
    n_layers=24, n_enc_layers=24, n_frames=1500, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    act="gelu", rope_theta=1e4)

SMOKE = CONFIG.scaled(n_layers=2, n_enc_layers=2, n_frames=16, d_model=64,
                      n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
                      vocab=512)
