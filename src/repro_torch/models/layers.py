"""Core neural layers as plain functions over explicit parameter dicts.

Port of ``repro.models.layers``: the same names, shapes and arithmetic on
torch tensors. GQA (+qk_norm, QKV bias), RoPE and M-RoPE, sliding-window
masks, and single-token decode against a KV cache.

What differs from the reference:

* Full self-attention without a window (``attention_fwd``) runs the
  flash-attention kernel (``kernels/flash_attention.py``), the port of the
  TPU kernel the reference names as the target form of that attention.
  Under grad it runs through ``FlashAttention``, whose backward is the
  hand-written backward kernel (the reference differentiates ``_sdpa``
  by XLA instead).
  Its float32 kernel keeps the softmax weights in fp32 for ``P @ V``; the
  bf16 tensor-core kernel rounds them to bf16 as ``_sdpa`` casts them to
  v's dtype, but after the running max, not after the whole softmax, so
  in bf16 the two differ by rounding.
  Windowed attention and decode keep ``_sdpa``, but for zamba2's shared
  attention (``windowed_attention``): while its window covers the prompt,
  that is causal attention, and it runs the kernel. ``_sdpa_chunked`` and
  ``REPRO_ATTN_CHUNK`` have no counterpart: the kernel replaces them.
* ``attention_decode`` writes the new K/V into the cache in place.
* There is no mesh, so ``shard_act`` has no counterpart.
* Initializers draw from an explicit ``torch.Generator`` on its own device
  and move the result to ``device``, scaling the fp32 draw in place (one
  fp32 copy of a leaf at a time); on the ``meta`` device they draw
  nothing and give shapes only (``Model.abstract_params``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    scale = 1.0 / np.sqrt(d_in)
    return _randn(gen, (d_in, d_out), device).mul_(scale).to(dtype)


# ---------------------------------------------------------------- norms ----
def rmsnorm_init(d: int, dtype, device) -> Dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
               m_rope: bool = False) -> torch.Tensor:
    """x: [B, S, H, dh]; pos: [B, S] (or [3, B, S] for M-RoPE sections)."""
    dh = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(dh, theta), dtype=torch.float32,
                            device=x.device)                 # [dh/2]
    if m_rope:
        # M-RoPE (Qwen2-VL): the rotary dims are split into 3 sections
        # (temporal / height / width), each rotated by its own position id.
        if pos.dim() == 2:
            pos = torch.stack([pos, pos, pos], dim=0)
        n = freqs.shape[0]
        s1, s2 = n - 2 * (n // 3), n // 3
        sec = torch.cat([
            torch.zeros((s1,), dtype=torch.long),
            torch.ones((s2,), dtype=torch.long),
            torch.full((n - s1 - s2,), 2, dtype=torch.long)]).to(x.device)
        pos_sec = pos.permute(1, 2, 0)[..., sec]         # [B, S, dh/2]
        ang = pos_sec.float() * freqs                    # [B, S, dh/2]
    else:
        ang = pos.float()[..., None] * freqs             # [B, S, dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def attention_init(gen: torch.Generator, cfg: ModelConfig,
                   device) -> Dict:
    dt = _dtype(cfg)
    d, dh = cfg.d_model, cfg.d_head
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dt, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads * dh,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.n_kv_heads * dh,), dtype=dt,
                              device=device)
        p["bv"] = torch.zeros((cfg.n_kv_heads * dh,), dtype=dt,
                              device=device)
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(dh, dt, device)
        p["knorm"] = rmsnorm_init(dh, dt, device)
    return p


def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
         pos: Optional[torch.Tensor], rope: bool = True):
    B, S, _ = x.shape
    dh = cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    if rope and pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta, cfg.m_rope)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.m_rope)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped-query attention core. q: [B,S,H,dh]; k,v: [B,T,Hkv,dh]."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    q = q.reshape(B, S, k.shape[2], G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H * dh)


def causal_mask(S: int, T: int, window: Optional[int], offset: int = 0,
                device=None) -> torch.Tensor:
    """[1,1,1,S,T] mask; query i attends key j iff j <= i+offset and, with a
    sliding window, j > i+offset-window."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > (qi - window)
    return m[None, None, None]


def flash_sdpa(q, k, v, causal: bool = True) -> torch.Tensor:
    """``_sdpa`` without a mask or with the causal one, through the flash
    kernel, differentiable (``flash_attention`` takes ``FlashAttention``
    under grad). q: [B,S,H,dh]; k,v: [B,S,Hkv,dh] -> [B,S,H*dh]. Heads
    move to the front for the kernel's ``[B*H, S, dh]`` and back after
    it."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    out = flash_attention(q.transpose(1, 2).reshape(B * H, S, dh),
                          k.transpose(1, 2).reshape(B * Hkv, S, dh),
                          v.transpose(1, 2).reshape(B * Hkv, S, dh), causal)
    return out.reshape(B, H, S, dh).transpose(1, 2).reshape(B, S, H * dh)


def attention_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  pos: torch.Tensor, window: Optional[int] = None,
                  causal: bool = True) -> torch.Tensor:
    """Full self-attention (training / prefill)."""
    q, k, v = _qkv(p, cfg, x, pos)
    w = window if window else cfg.swa_window
    if w is None:
        out = flash_sdpa(q, k, v, causal)
    else:
        mask = causal_mask(x.shape[1], x.shape[1], w, device=x.device) \
            if causal else None
        out = _sdpa(q, k, v, mask, cfg)
    return out @ p["wo"]


def windowed_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                       pos: torch.Tensor, window: int
                       ) -> Tuple[torch.Tensor, ...]:
    """Causal self-attention over a sliding window of ``window`` keys
    (prefill / full forward), as the reference's zamba2 shared attention
    computes it with ``causal_mask(S, S, window)``. Returns (out, k, v),
    k and v for a prefill's cache. While ``S <= window`` the window masks
    nothing the causal mask does not, so it runs the flash kernel
    (``flash_sdpa``); past it, the masked ``_sdpa``."""
    q, k, v = _qkv(p, cfg, x, pos)
    S = x.shape[1]
    if S <= window:
        out = flash_sdpa(q, k, v)
    else:
        out = _sdpa(q, k, v, causal_mask(S, S, window, device=x.device), cfg)
    return out @ p["wo"], k, v


def cross_attention_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                        kv_src: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention (no mask, no rope)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, dh)
    k = (kv_src @ p["wk"]).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    v = (kv_src @ p["wv"]).reshape(B, kv_src.shape[1], cfg.n_kv_heads, dh)
    out = _sdpa(q, k, v, None, cfg)
    return out @ p["wo"]


def attention_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor,
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """One-token decode. x: [B,1,d]; cache_[kv]: [B,T,Hkv,dh]; pos: [B,1].
    Writes the new K/V into the caches in place and returns
    (out, cache_k, cache_v)."""
    q, k, v = _qkv(p, cfg, x, pos)
    # M-RoPE positions are [3, B, 1]; the temporal section indexes the cache
    pos_t = pos[0] if pos.dim() == 3 else pos
    T = cache_k.shape[1]
    slot = pos_t[0, :1] % T  # ring buffer for windowed caches
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    kj = torch.arange(T, device=x.device)[None, :]
    w = window if window else cfg.swa_window
    if w is not None and T <= w:
        # ring buffer: once pos >= T every slot is a valid in-window entry
        valid = (kj <= pos_t[:, :1]) | (pos_t[:, :1] >= T)
    else:
        valid = kj <= pos_t[:, :1]
    mask = valid[:, None, None, None, :]
    out = _sdpa(q, cache_k, cache_v, mask, cfg)
    return out @ p["wo"], cache_k, cache_v


# ------------------------------------------------------------------ mlp ----
def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Dict:
    dt = _dtype(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "silu":
        return {"wi": dense_init(gen, d, f, dt, device),
                "wg": dense_init(gen, d, f, dt, device),
                "wo": dense_init(gen, f, d, dt, device)}
    return {"wi": dense_init(gen, d, f, dt, device),
            "wo": dense_init(gen, f, d, dt, device)}


def mlp_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        h = F.silu(x @ p["wi"]) * (x @ p["wg"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


# ------------------------------------------------------------ embedding ----
def embed_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = _dtype(cfg)
    p = {"tok": _randn(gen, (cfg.vocab, cfg.d_model), device).mul_(0.02)
         .to(dt)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, cfg.d_model, cfg.vocab, dt, device)
    return p


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.to(p["tok"].device, torch.long)]


def unembed(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w
