"""Decoder-only model stack: stacked ``[L, ...]`` layers applied in a loop.

Port of the decoder-only branch of ``repro.models.transformer`` (lines
60-160), dense and MoE blocks: ``dense_block_init/fwd``,
``decoder_init/fwd``, ``_ring`` and ``decoder_prefill``. ``scan_layers``
becomes a Python loop over the layer axis of the stacked leaves.
``_remat``'s counterpart: with grad enabled, ``decoder_fwd`` runs each
layer under ``torch.utils.checkpoint`` (non-reentrant), which saves the
layer's input and recomputes the rest in the backward pass (the
reference's ``REPRO_REMAT=min``; its default policy also saves the matrix
products, and ``REPRO_REMAT`` has no counterpart).

One departure from the reference: ``decoder_prefill`` fills caches of the
length ``Tw`` the caller allocated, with prompt token t in slot ``t % Tw``
for the last ``min(S, Tw)`` tokens. The reference's ``_ring`` returns only
``S`` slots when ``S < Tw``, so its first decode step writes slot
``S % S = 0`` over the first prompt token (ROADMAP queue C). For
``S >= Tw`` both give the same cache.

A MoE block (``cfg.is_moe``) runs ``moe.moe_fwd`` in place of the MLP and
returns its auxiliary loss, which ``decoder_fwd`` sums over the layers as
the reference's scan carry does. zamba2 (mamba2), xLSTM and the
encoder-decoder stack are not ported yet (ROADMAP A8) and raise
``NotImplementedError``.

``_stack_init`` allocates each stacked leaf once and fills layer i in
place as it is drawn, so an init holds the parameters plus one layer, not
the parameters twice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import moe as MOE
from .config import ModelConfig

Params = Dict[str, Any]


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.block != "attn" or cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only attention stacks "
            "(dense and MoE); zamba2, xLSTM and encoder-decoder wait for "
            "ROADMAP A8")


def _stack_init(gen: torch.Generator, n: int, init_fn) -> Params:
    """n layers from ``init_fn(gen)``, drawn in order, as stacked
    ``[n, ...]`` leaves allocated once; layer i is copied into row i as it
    is drawn."""
    def empty(t):
        if isinstance(t, dict):
            return {k: empty(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def fill(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = None
    for i in range(n):
        layer = init_fn(gen)
        out = empty(layer) if out is None else out
        fill(out, layer, i)
        del layer      # before the next layer is drawn
    return out


# ------------------------------------------------------- decoder-only ------
def dense_block_init(gen: torch.Generator, cfg: ModelConfig,
                     device) -> Params:
    _decoder_only(cfg)
    dt = L._dtype(cfg)
    p = {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": L.attention_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
    }
    if cfg.is_moe:
        p["moe"] = MOE.moe_init(gen, cfg, device)
    elif cfg.d_ff:
        p["mlp"] = L.mlp_init(gen, cfg, device)
    return p


def _ffn(cfg: ModelConfig, p: Params, h):
    """The block's MoE or MLP on the ln2 output: (out, aux); out is None
    without an MLP, aux None for a dense block."""
    if cfg.is_moe:
        return MOE.moe_fwd(p["moe"], cfg, h)
    return (L.mlp_fwd(p["mlp"], cfg, h) if cfg.d_ff else None), None


def dense_block_fwd(cfg: ModelConfig, p: Params, x, pos,
                    cache: Optional[Tuple] = None):
    """Returns (x, aux), aux the MoE auxiliary loss (None for a dense
    block, whose loss is 0); a cache ``(k, v)`` is updated in place. (The
    reference also returns the cache.)"""
    _decoder_only(cfg)
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cache is None:
        a = L.attention_fwd(p["attn"], cfg, h, pos)
    else:
        a, _, _ = L.attention_decode(p["attn"], cfg, h, cache[0], cache[1],
                                     pos)
    x = x + a
    m, aux = _ffn(cfg, p, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return (x if m is None else x + m), aux


def decoder_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    _decoder_only(cfg)
    return {
        "embed": L.embed_init(gen, cfg, device),
        "layers": _stack_init(gen, cfg.n_layers,
                              lambda g: dense_block_init(g, cfg, device)),
        "lnf": L.rmsnorm_init(cfg.d_model, L._dtype(cfg), device),
    }


def _unstack(params: Params, n: int) -> List[Params]:
    """The n layers' parameters from the stacked leaves, by one ``unbind``
    a leaf, so that the backward pass stacks each leaf's gradient once."""
    if isinstance(params, dict):
        per_key = {k: _unstack(v, n) for k, v in params.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(params))


def decoder_fwd(cfg: ModelConfig, params: Params, x, pos,
                caches: Optional[Tuple] = None):
    """Loop over stacked layers. caches: (k [L,B,T,Hk,dh], v) or None;
    a decode step updates them in place. With grad enabled and no caches,
    each layer runs under ``torch.utils.checkpoint``: its input is all it
    saves, and its recompute routes as the forward did, since it sees the
    same input. Returns (the normed hidden states, the layers' summed MoE
    auxiliary loss)."""
    remat = caches is None and torch.is_grad_enabled()
    layers = _unstack(params["layers"], cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers):
        if remat:
            x, a = checkpoint(dense_block_fwd, cfg, p, x, pos,
                              use_reentrant=False)
        else:
            cache = None if caches is None else (caches[0][i], caches[1][i])
            x, a = dense_block_fwd(cfg, p, x, pos, cache)
        if a is not None:
            aux = aux + a
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps), aux


def _ring(kv: torch.Tensor, S: int, Tw: int) -> torch.Tensor:
    """The ``[B, Tw, ...]`` cache of a length-S prompt: slot j holds the
    token with position = j mod Tw among the last min(S, Tw) tokens; slots
    no token reached are zero."""
    if S >= Tw:
        return torch.roll(kv[:, -Tw:], S % Tw, dims=1)
    out = kv.new_zeros((kv.shape[0], Tw) + tuple(kv.shape[2:]))
    out[:, :S] = kv
    return out


def decoder_prefill(cfg: ModelConfig, params: Params, x, pos,
                    caches: Tuple[torch.Tensor, torch.Tensor]):
    """Forward the prompt once, filling the per-layer K/V ring caches
    ``caches = (k, v)``, each ``[L, B, Tw, Hkv, dh]``, in place. Returns
    the normed hidden states (the MoE auxiliary loss is dropped, as the
    reference's ``Model.prefill`` drops it)."""
    _decoder_only(cfg)
    S = x.shape[1]
    Tw = caches[0].shape[2]
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], cfg, hn, pos)
        if cfg.swa_window is None:
            a = L.flash_sdpa(q, k, v)
        else:
            mask = L.causal_mask(S, S, cfg.swa_window, device=x.device)
            a = L._sdpa(q, k, v, mask, cfg)
        x = x + a @ p["attn"]["wo"]
        m, _ = _ffn(cfg, p, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
        if m is not None:
            x = x + m
        caches[0][i].copy_(_ring(k, S, Tw))
        caches[1][i].copy_(_ring(v, S, Tw))
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)
