# Copy of src/repro/models/config.py (commit 9368fdf); imports may differ.
"""Model configuration for the assigned architecture pool."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    m_rope: bool = False           # qwen2-vl multimodal rotary (3 sections)
    swa_window: Optional[int] = None  # sliding-window attention
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0           # per-expert hidden dim (fine-grained MoE)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    attn_every: int = 0            # hybrid: shared attention block cadence
    slstm_every: int = 0           # xLSTM: sLSTM block cadence
    # encoder-decoder (audio)
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500           # stubbed frontend sequence length
    # misc
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which block stack to build
    block: str = "attn"            # attn | mamba2 | xlstm

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for 6*N*D roofline accounting) -------------
    def param_count(self) -> Tuple[int, int]:
        """(total params, active params per token)."""
        d, dh = self.d_model, self.d_head
        qkv = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) \
            + (self.n_heads * dh) * d
        if self.qkv_bias:
            qkv += (self.n_heads + 2 * self.n_kv_heads) * dh
        if self.block == "mamba2":
            d_in = 2 * d
            heads = d_in // self.ssm_headdim
            blk = d * (2 * d_in + 2 * self.ssm_state + heads) + d_in * d
            blk_active = blk
            attn_blk = qkv if self.attn_every else 0
        elif self.block == "xlstm":
            d_in = 2 * d
            blk = 4 * d * d + d_in * d + d * d_in    # qkv+gates+proj approx
            blk_active = blk
            attn_blk = 0
        else:
            blk = qkv
            blk_active = qkv
            attn_blk = 0
        if self.is_moe:
            dff = self.d_ff_expert or self.d_ff
            expert = 3 * d * dff
            mlp = self.n_experts * expert + self.n_shared_experts * expert
            mlp_active = (self.moe_top_k + self.n_shared_experts) * expert
        elif self.d_ff:
            mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
            mlp_active = mlp
        else:
            mlp = mlp_active = 0
        per_layer = blk + mlp + 2 * d
        per_layer_active = blk_active + mlp_active + 2 * d
        n_l = self.n_layers
        total = n_l * per_layer + 2 * d * self.vocab
        active = n_l * per_layer_active + 2 * d * self.vocab
        if self.attn_every:
            total += attn_blk  # one shared block
            active += attn_blk * (n_l // max(self.attn_every, 1))
        if self.enc_dec:
            # decoder cross-attention + its own stack counted via n_layers;
            # encoder layers:
            enc = self.n_enc_layers * (qkv + mlp + 2 * d)
            cross = self.n_layers * qkv
            total += enc + cross
            active += enc + cross
        return int(total), int(active)
