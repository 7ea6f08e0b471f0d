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
  Causal attention under a sliding window (mixtral's ``swa_window``,
  zamba2's shared attention) runs the kernel too while the window covers
  the prompt: there the window masks nothing the causal mask does not
  (``self_attend``). Past it, and in a decode step, it keeps the masked
  ``_sdpa``: the reference's kernel has no window. ``_sdpa_chunked`` and
  ``REPRO_ATTN_CHUNK`` have no counterpart: the kernel replaces them.
* ``attention_decode`` writes the new K/V into the cache in place.
* ``shard_act`` has no counterpart. The ``tp_*`` functions (tensor
  parallelism over the ``model`` axis) do what GSPMD does at its sites:
  ``q`` split by heads, ``k`` and ``v`` gathered whole on every shard
  (``layers.py:169-170`` of the reference), the MLP hidden split
  (``:236``) and the vocab split (``:258``); ``tp_cross_attention`` is
  the cross-attention's, ``tp_rmsnorm`` a norm over an axis the shards
  split (each shard's sum of squares, summed), ``tp_columns`` a shard's
  columns of a column-split product. Under a sequence-split K/V cache
  (the reference's ``REPRO_KV_SHARD=seq``) each shard attends every
  query head to its slots (``seq_partial``) and the shards' partial
  softmaxes join on shard 0 (``Group.join``, ``seq_attend``).
* Initializers draw from an explicit ``torch.Generator`` on its own device
  and move the result to ``device``, scaling the fp32 draw in place (one
  fp32 copy of a leaf at a time); on the ``meta`` device they draw
  nothing and give shapes only (``Model.abstract_params``). The stacks'
  inits put what they draw ``into`` a place (``Whole``: kept whole;
  ``distributed.sharding.init_sharded``: into its blocks on a mesh).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from .config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Whole:
    """Where an init puts what it draws: each leaf whole, where it was
    drawn (``Model.init``). ``distributed.sharding.init_sharded`` puts
    each into its blocks on a mesh instead, through the same calls:
    ``at(key)`` the place of a subtree, ``put(tree)`` a tree drawn whole,
    ``stack(layer, n)`` the ``[n, ...]`` leaves of n layers shaped like
    ``layer`` and ``write(out, layer, i)`` layer i into them."""

    def at(self, key) -> "Whole":
        return self

    def put(self, tree):
        return tree

    def stack(self, layer, n: int):
        if isinstance(layer, dict):
            return {k: self.stack(v, n) for k, v in layer.items()}
        return layer.new_empty((n,) + tuple(layer.shape))

    def write(self, out, layer, i: int) -> None:
        if isinstance(out, dict):
            for k in out:
                self.write(out[k], layer[k], i)
        else:
            out[i].copy_(layer)


WHOLE = Whole()


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
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


def _proj(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """The Q, K and V projections ``[B, S, cols]`` (biases added), over
    whatever columns ``p``'s leaves hold."""
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _qkv(p: Dict, cfg: ModelConfig, x: torch.Tensor,
         pos: Optional[torch.Tensor], rope: bool = True):
    return _heads(p, cfg, *_proj(p, cfg, x), pos, rope)


def _heads(p: Dict, cfg: ModelConfig, q, k, v, pos: Optional[torch.Tensor],
           rope: bool = True):
    """Projections ``[B, S, n * dh]`` of whole heads, any number of them,
    as heads ``[B, S, n, dh]``, normed and rotated."""
    B, S, _ = q.shape
    dh = cfg.d_head
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
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


def self_attend(q, k, v, cfg: ModelConfig, window: Optional[int],
                causal: bool = True) -> torch.Tensor:
    """A prompt's self-attention under ``window`` (None: none) -> [B, S,
    H*dh]: the flash kernel (``flash_sdpa``) without a window, and with
    one while it covers the S keys of a causal prompt (the window then
    masks nothing the causal mask does not); past it the masked
    ``_sdpa``, as without causality (a window with no causal mask masks
    nothing)."""
    S = q.shape[1]
    if window is None or (causal and S <= window):
        return flash_sdpa(q, k, v, causal)
    mask = causal_mask(S, S, window, device=q.device) if causal else None
    return _sdpa(q, k, v, mask, cfg)


def attention_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  pos: torch.Tensor, window: Optional[int] = None,
                  causal: bool = True) -> torch.Tensor:
    """Full self-attention (training / prefill)."""
    q, k, v = _qkv(p, cfg, x, pos)
    out = self_attend(q, k, v, cfg, window if window else cfg.swa_window,
                      causal)
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
    return self_attend(q, k, v, cfg, window) @ p["wo"], k, v


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
    out = decode_attend(cfg, q, k, v, cache_k, cache_v, pos, window)
    return out @ p["wo"], cache_k, cache_v


def decode_attend(cfg: ModelConfig, q, k, v, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, pos: torch.Tensor,
                  window: Optional[int] = None, kv=slice(None)
                  ) -> torch.Tensor:
    """Writes one token's ``k``, ``v`` (the cache's heads) into the caches
    at ``pos``'s slot and attends ``q`` to the caches' KV heads ``kv`` (a
    slice or an index list of the heads' axis) -> ``[B, 1, H_q * dh]``."""
    # M-RoPE positions are [3, B, 1]; the temporal section indexes the cache
    pos_t = pos[0] if pos.dim() == 3 else pos
    T = cache_k.shape[1]
    slot = pos_t[0, :1] % T  # ring buffer for windowed caches
    cache_k.index_copy_(1, slot, k)
    cache_v.index_copy_(1, slot, v)
    kj = torch.arange(T, device=q.device)[None, :]
    w = window if window else cfg.swa_window
    if w is not None and T <= w:
        # ring buffer: once pos >= T every slot is a valid in-window entry
        valid = (kj <= pos_t[:, :1]) | (pos_t[:, :1] >= T)
    else:
        valid = kj <= pos_t[:, :1]
    mask = valid[:, None, None, None, :]
    return _sdpa(q, cache_k[:, :, kv], cache_v[:, :, kv], mask, cfg)


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
def embed_init(gen: torch.Generator, cfg: ModelConfig, device,
               into: Whole = WHOLE) -> Dict:
    """The token embedding and, untied, the unembedding, each put
    ``into`` its place as it is drawn."""
    dt = _dtype(cfg)
    p = {"tok": into.at("tok").put(_randn(
        gen, (cfg.vocab, cfg.d_model), device).mul_(0.02).to(dt))}
    if not cfg.tie_embeddings:
        p["out"] = into.at("out").put(dense_init(gen, cfg.d_model,
                                                 cfg.vocab, dt, device))
    return p


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.to(p["tok"].device, torch.long)]


def unembed(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    return x @ w


# ------------------------------------------------------ tensor parallel ----
# The functions below run one data shard's model shards in turn. ``ps``
# holds each shard's blocks of the parameters (``sharding.param_specs``),
# ``hs`` each shard's copy of a replicated activation, ``pos`` each shard's
# positions, and ``tp`` (``distributed.tensor_parallel.Group``) moves
# tensors between the shards. A leaf the rules split holds its block; one
# the divisibility guard keeps whole holds every column on every shard,
# which then computes the whole product itself. Which is which is read off
# the block's shape.
def block_cols(n: int, full: int, m: int) -> Tuple[int, int]:
    """The range ``[lo, hi)`` of a ``full``-long dimension that shard m's
    block of length ``n`` covers: all of it when the block is whole."""
    return (0, full) if n == full else (m * n, (m + 1) * n)


def _cols(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a leaf: the leaf itself when it is that
    block (or whole and the range is all of it), else its slice."""
    return t if t.shape[-1] == hi - lo else t[..., lo:hi]


def kv_heads(cfg: ModelConfig, h0: int, h1: int):
    """The KV heads that query heads ``[h0, h1)`` use, as an index of the
    heads' axis: a slice when the queries take whole, equal shares of
    them (the group size then stays H / Hkv or smaller), else a list of
    one KV head a query head."""
    G = cfg.n_heads // cfg.n_kv_heads
    idx = [h // G for h in range(h0, h1)]
    uniq = sorted(set(idx))
    n = len(idx) // len(uniq)
    if idx == [e for e in uniq for _ in range(n)]:
        return slice(uniq[0], uniq[-1] + 1)
    return idx


def cache_heads(cfg: ModelConfig, n: int, m: int) -> slice:
    """The KV heads of shard m's cache block of ``n`` heads
    (``cache_specs`` splits them on ``model`` when it can)."""
    return slice(*block_cols(n, cfg.n_kv_heads, m))


def _shift(kv, by: int):
    if isinstance(kv, slice):
        return slice(kv.start - by, kv.stop - by)
    return [i - by for i in kv]


def own_heads(n: int, shards: int, m: int) -> Tuple[int, int]:
    """The heads ``[h0, h1)`` of ``n`` that shard m of ``shards`` runs: an
    equal share where they divide (the cache's state then splits on
    them, ``cache_specs``), else all of them."""
    if n % shards:
        return 0, n
    k = n // shards
    return m * k, (m + 1) * k


def tp_columns(tp, parts, full: int, ranges) -> List[torch.Tensor]:
    """Each shard's columns ``ranges[m] = (a, b)`` of a product whose
    last axis, ``full`` wide, the shards hold as ``parts`` (column blocks
    by the rules, or whole where the guard keeps it whole): the shard's
    own block where that is its range, else a slice of the whole product
    (gathered first where it is split)."""
    n = parts[0].shape[-1]
    if n < full and all(block_cols(n, full, m) == tuple(r)
                        for m, r in enumerate(ranges)):
        return list(parts)
    whole = list(parts) if n == full else tp.gather(parts)
    return [_cols(w, a, b) for w, (a, b) in zip(whole, ranges)]


def tp_rmsnorm(tp, ps, xs, cols, full: int, eps: float
               ) -> List[torch.Tensor]:
    """``rmsnorm`` over a last axis of ``full`` of which shard m holds
    the columns ``cols[m] = (lo, hi)`` in ``xs[m]`` (with its columns of
    the whole ``scale``): each shard's fp32 sum of squares, summed across
    the shards, over ``full``. Where every shard holds every column it is
    each shard's own ``rmsnorm``."""
    if xs[0].shape[-1] == full:
        return [rmsnorm(p, x, eps) for p, x in zip(ps, xs)]
    xf = [x.float() for x in xs]
    ss = tp.sum([x.square().sum(-1, keepdim=True) for x in xf])
    return [(x * torch.rsqrt(s / full + eps)
             * _cols(p["scale"], lo, hi).float()).to(x0.dtype)
            for p, x, s, (lo, hi), x0 in zip(ps, xf, ss, cols, xs)]


def _tp_split_qkv(tp, cfg: ModelConfig, proj, all_q: bool = False):
    """From each shard's ``(q, k, v)`` projections (column blocks, or
    whole where the guard keeps them whole): each shard's ``(q, k, v,
    cols)``, ``k`` and ``v`` every KV head's columns (gathered where
    split, which may cut a head), ``q`` the columns of the query heads
    that cover the columns ``cols = (lo, hi, h0)`` its ``wo`` rows take,
    from head ``h0`` (gathered first where the block cuts a head; every
    head from ``h0 = 0`` with ``all_q``)."""
    H, dh = cfg.n_heads, cfg.d_head

    def whole(i: int, full: int):
        parts = [pr[i] for pr in proj]
        return parts if parts[0].shape[-1] == full else tp.gather(parts)

    ks = whole(1, cfg.n_kv_heads * dh)
    vs = whole(2, cfg.n_kv_heads * dh)
    q_all = None
    out = []
    for m, pr in enumerate(proj):
        lo, hi = block_cols(pr[0].shape[-1], H * dh, m)
        h0, h1 = (0, H) if all_q else (lo // dh, -(-hi // dh))
        q = pr[0]
        if all_q or lo % dh or hi % dh:
            q_all = whole(0, H * dh) if q_all is None else q_all
            q = q_all[m][..., h0 * dh:h1 * dh]
        out.append((q, ks[m], vs[m], (lo, hi, h0)))
    return out


def tp_qkv(tp, ps, cfg: ModelConfig, hs, pos, all_q: bool = False
           ) -> List[Tuple]:
    """Each shard's ``(q, k, v, cols)`` (``_tp_split_qkv``) as heads:
    ``k``, ``v`` ``[B, S, Hkv, dh]``, ``q`` ``[B, S, n, dh]``, normed and
    rotated."""
    proj = [_proj(p, cfg, h) for p, h in zip(ps, hs)]
    return [_heads(p, cfg, q, k, v, pos[m]) + (cols,)
            for m, (p, (q, k, v, cols)) in enumerate(
                zip(ps, _tp_split_qkv(tp, cfg, proj, all_q)))]


def _tp_out(p: Dict, cfg: ModelConfig, o: torch.Tensor, cols) -> torch.Tensor:
    """A shard's attention output of heads from ``h0`` cut to the query
    columns ``[lo, hi)`` its ``wo`` rows take, through ``wo``."""
    lo, hi, h0 = cols
    off = h0 * cfg.d_head
    return o[..., lo - off:hi - off] @ p["wo"]


def _tp_split(ps, cfg: ModelConfig) -> bool:
    return ps[0]["wo"].shape[0] < cfg.n_heads * cfg.d_head


def tp_attention_fwd(tp, ps, cfg: ModelConfig, hs, pos,
                     window: Optional[int] = None, causal: bool = True):
    """Self-attention (training, prefill) of each shard's query heads,
    causal or not, through ``self_attend`` (the flash kernel, the masked
    ``_sdpa`` past a window) -> (outs, kvs, split): each shard's output
    through its ``wo`` rows, partial sums when ``split`` (``wo`` split by
    rows) and the whole output otherwise; ``kvs`` each shard's whole
    ``(k, v)`` for a prefill's cache. ``window`` is
    ``windowed_attention``'s; without one ``cfg.swa_window``'s, as in
    ``attention_fwd``."""
    outs, kvs = [], []
    w = cfg.swa_window if window is None else window
    for p, (q, k, v, cols) in zip(ps, tp_qkv(tp, ps, cfg, hs, pos)):
        kv = kv_heads(cfg, cols[2], cols[2] + q.shape[2])
        o = self_attend(q, k[:, :, kv], v[:, :, kv], cfg, w, causal)
        outs.append(_tp_out(p, cfg, o, cols))
        kvs.append((k, v))
    return outs, kvs, _tp_split(ps, cfg)


def tp_cross_attention(tp, ps, cfg: ModelConfig, hs, srcs):
    """``cross_attention_fwd`` of each shard's query heads to the whole
    K and V that ``srcs[m]`` (the encoder's output, whole on every shard)
    projects -> (outs, split) as ``tp_attention_fwd``."""
    dh = cfg.d_head
    proj = [(h @ p["wq"], s @ p["wk"], s @ p["wv"])
            for p, h, s in zip(ps, hs, srcs)]
    outs = []
    for p, (q, k, v, cols) in zip(ps, _tp_split_qkv(tp, cfg, proj)):
        B, S, _ = q.shape
        F_ = k.shape[1]
        q = q.reshape(B, S, -1, dh)
        kv = kv_heads(cfg, cols[2], cols[2] + q.shape[2])
        o = _sdpa(q, k.reshape(B, F_, -1, dh)[:, :, kv],
                  v.reshape(B, F_, -1, dh)[:, :, kv], None, cfg)
        outs.append(_tp_out(p, cfg, o, cols))
    return outs, _tp_split(ps, cfg)


def tp_attention_decode(tp, ps, cfg: ModelConfig, hs, caches, pos,
                        window: Optional[int] = None):
    """One-token decode -> (outs, split) as ``tp_attention_fwd``;
    ``caches[m] = (k, v)`` shard m's cache blocks, each ``[B, T, n, dh]``.
    Split by KV heads (or whole): each shard writes its block's heads and
    attends its query heads to them. Split by sequence (``tp.kv_slots``
    set, ``REPRO_KV_SHARD=seq``): each shard holds every KV head of slots
    ``[m T, (m + 1) T)`` of a ring of ``tp.kv_slots``; the token's K/V
    goes to the shard that holds slot ``pos % tp.kv_slots``, every shard
    attends every query head to its slots (``seq_partial``), the
    partials join on shard 0 (``Group.join``), and each shard takes its
    heads' columns."""
    seq = tp.kv_slots is not None
    qkv = tp_qkv(tp, ps, cfg, hs, pos, all_q=seq)
    if seq:
        os_ = seq_attend(tp, [seq_partial(cfg, q, k, v, ck, cv, pos[m], m,
                                          tp.kv_slots, window)
                              for m, ((q, k, v, _), (ck, cv)) in enumerate(
                                  zip(qkv, caches))], caches[0][1].dtype)
        return ([_tp_out(p, cfg, o, cols)
                 for p, (_, _, _, cols), o in zip(ps, qkv, os_)],
                _tp_split(ps, cfg))
    outs = []
    for m, (p, (q, k, v, cols), (ck, cv)) in enumerate(
            zip(ps, qkv, caches)):
        c = cache_heads(cfg, ck.shape[2], m)
        kv = _shift(kv_heads(cfg, cols[2], cols[2] + q.shape[2]), c.start)
        o = decode_attend(cfg, q, k[:, :, c], v[:, :, c], ck, cv, pos[m],
                          window, kv=kv)
        outs.append(_tp_out(p, cfg, o, cols))
    return outs, _tp_split(ps, cfg)


def seq_partial(cfg: ModelConfig, q, k, v, cache_k: torch.Tensor,
                cache_v: torch.Tensor, pos: torch.Tensor, m: int,
                slots: int, window: Optional[int] = None):
    """Shard m's part of a decode step over a sequence-split cache: its
    block ``cache_[kv]`` ``[B, T, Hkv, dh]`` holds the global slots
    ``[m T, (m + 1) T)`` of a ring of ``slots``. Writes the token's
    ``k``, ``v`` ``[B, 1, Hkv, dh]`` where its slot ``pos % slots`` lies
    in the block (no write elsewhere, and no sync: the slot is masked),
    then attends ``q`` ``[B, 1, H, dh]`` (every head) to the block's
    valid slots by ``decode_attend``'s rule on the global index ->
    ``(mx, l, o)`` in fp32 for ``Group.join``: the max score ``[B, Hkv,
    G, 1]`` (-inf where no slot is valid yet), the sum of ``exp(score -
    mx)`` and the weighted values ``[B, Hkv, G, dh]``."""
    pos_t = pos[0] if pos.dim() == 3 else pos
    B, T = cache_k.shape[:2]
    lo = m * T
    local = pos_t[0, :1] % slots - lo
    idx = local.clamp(0, T - 1)
    mine = (local >= 0) & (local < T)
    for c, new in ((cache_k, k), (cache_v, v)):
        c.index_copy_(1, idx, torch.where(mine, new, c.index_select(1, idx)))
    kj = lo + torch.arange(T, device=q.device)[None, :]
    w = window if window else cfg.swa_window
    if w is not None and slots <= w:
        valid = (kj <= pos_t[:, :1]) | (pos_t[:, :1] >= slots)
    else:
        valid = kj <= pos_t[:, :1]
    H, dh = q.shape[2], q.shape[3]
    Hkv = cache_k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, cache_k.float()) / math.sqrt(dh)
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0))
    o = torch.einsum("bkgt,btkd->bkgd", p, cache_v.float())
    return mx, p.sum(-1, keepdim=True), o


def seq_attend(tp, parts, dtype) -> List[torch.Tensor]:
    """``Group.join`` of the shards' ``seq_partial`` -> each shard's
    ``[B, 1, H * dh]`` in ``dtype``."""
    return [o.reshape(o.shape[0], 1, -1).to(dtype) for o in tp.join(parts)]


def tp_mlp(ps, cfg: ModelConfig, hs, d_ff: Optional[int] = None):
    """``mlp_fwd`` on each shard over the hidden columns its ``wo`` rows
    take (a whole ``wi`` or ``wg`` is cut to them) -> (outs, split)."""
    f = d_ff or cfg.d_ff
    outs = []
    for m, (p, h) in enumerate(zip(ps, hs)):
        lo, hi = block_cols(p["wo"].shape[0], f, m)
        blk = {k: w if k == "wo" else _cols(w, lo, hi) for k, w in p.items()}
        outs.append(mlp_fwd(blk, cfg, h))
    return outs, ps[0]["wo"].shape[0] < f


def tp_embed(ps, cfg: ModelConfig, tokens):
    """Each shard's rows of ``tok`` for the tokens in its vocab range,
    zero elsewhere (the whole lookup where ``tok`` is whole) -> (parts,
    split); their sum has one non-zero term a token, so it is exact."""
    parts = []
    for m, (p, t) in enumerate(zip(ps, tokens)):
        w = p["tok"]
        n = w.shape[0]
        if n == cfg.vocab:
            parts.append(embed(p, t))
            continue
        t = t.to(w.device, torch.long) - m * n
        rows = w[t.clamp(0, n - 1)]
        inr = ((t >= 0) & (t < n))[..., None]
        parts.append(torch.where(inr, rows, rows.new_zeros(())))
    return parts, ps[0]["tok"].shape[0] < cfg.vocab
