"""Model stacks: decoder-only, hybrid (zamba2), xLSTM and
encoder-decoder, with stacked ``[L, ...]`` layers applied in a loop.

Port of ``repro.models.transformer``: the decoder-only branch (lines
60-160), dense and MoE blocks (``dense_block_init/fwd``,
``decoder_init/fwd``, ``_ring``, ``decoder_prefill``), zamba2
(``zamba2_init/fwd``, ``_mamba_layer_*``, ``ZAMBA_WINDOW``; lines
184-300), xLSTM (``xlstm_init/fwd``, ``_xl_layer_init``; lines 304-366)
and the encoder-decoder stack (``encdec_init``, ``encoder_fwd``,
``encdec_fwd``, ``encdec_prefill``; lines 163-179 and 370-444).
``scan_layers`` becomes a Python loop over the layer axis of the stacked
leaves; a group of zamba2 or xLSTM (the reference's super-layer) is a
loop over its inner layers.
``_remat``'s counterpart: with grad enabled, ``decoder_fwd``,
``encoder_fwd``, ``encdec_fwd``, ``zamba2_fwd`` and ``xlstm_fwd`` run each
layer (and zamba2's shared attention) under ``torch.utils.checkpoint``
(non-reentrant), which saves the layer's input and recomputes the rest in
the backward pass (the reference's ``REPRO_REMAT=min``; its default
policy also saves the matrix products, and ``REPRO_REMAT`` has no
counterpart).

One departure from the reference: ``decoder_prefill``, zamba2's prefill
and ``encdec_prefill`` fill caches of the length ``Tw`` the caller
allocated, with prompt token t in slot ``t % Tw`` for the last ``min(S,
Tw)`` tokens. The reference's ``_ring`` returns only ``S`` slots when
``S < Tw`` (its ``decoder_prefill``, its zamba2 ``capture_kv``, lines
262-263, and its ``encdec_prefill``, line 177), so its first decode step
writes slot ``S % S = 0`` over the first prompt token (ROADMAP queue C).
For ``S >= Tw`` both give the same cache.

A MoE block (``cfg.is_moe``) runs ``moe.moe_fwd`` in place of the MLP and
returns its auxiliary loss, which ``decoder_fwd`` sums over the layers as
the reference's scan carry does.

``tp_decoder_fwd`` and ``tp_decoder_prefill`` run the decoder over one
data shard's model shards (tensor parallelism over the ``model`` axis),
and ``tp_zamba2_fwd``, ``tp_xlstm_fwd``, ``tp_encoder_fwd``,
``tp_encdec_fwd`` and ``tp_encdec_prefill`` the other stacks: the same
blocks, each shard on its blocks of the parameters, each row-parallel
product summed across the shards before its residual add. Under grad
each of their layers runs under the reentrant checkpoint
(``_tp_checkpoint``), each scan in its chunks inside it.

The encoder's self-attention is ``attention_fwd(..., causal=False)`` with
no positions (no RoPE), so it runs the flash kernel unmasked; the
decoder's is causal with RoPE, on the flash kernel in a prefill and a
full forward and on ``attention_decode``'s cache in a decode step. Its
cross-attention (``layers.cross_attention_fwd``) projects the encoder's
output to K and V in every layer and at every step, as the reference
does, and runs ``_sdpa``.

zamba2's shared attention runs ``layers.windowed_attention``: the flash
kernel while the prompt fits ``ZAMBA_WINDOW`` (the window then masks
nothing the causal mask does not), the masked ``_sdpa`` past it, as a
decoder's attention under ``cfg.swa_window`` (mixtral) does in a full
forward and in ``decoder_prefill`` (``layers.self_attend``); its
decode keeps ``attention_decode(..., window=ZAMBA_WINDOW)``. The zamba2
and xLSTM forwards take ``cache=None`` for a full forward, a cache for a
prefill (from the initial state; every state leaf and K/V slot of the
cache is written) or, with ``decode=True``, a decode step from the
cache's state, written back in place. Under grad a full forward runs
each of their layers, and each group's shared attention, under
``torch.utils.checkpoint``, and each scan inside a layer in checkpointed
chunks of its own (``ssm.SCAN_CHUNK``).

``_stack_init`` allocates each stacked leaf once and fills layer i in
place as it is drawn, so an init holds the parameters plus one layer (for
nested stacks, one group), not the parameters twice. Each init takes
``into`` (``layers.Whole``), which places each stack and each leaf drawn
outside a stack: ``Model.init`` keeps them whole,
``distributed.sharding.init_sharded`` writes them into their blocks on a
mesh as they are drawn, so that no device holds the whole model.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig

Params = Dict[str, Any]


def _stack_init(gen: torch.Generator, n: int, init_fn,
                into: L.Whole = L.WHOLE) -> Params:
    """n layers from ``init_fn(gen)``, drawn in order, as stacked
    ``[n, ...]`` leaves allocated once (``into.stack``); layer i is
    written into row i as it is drawn (``into.write``)."""
    out = None
    for i in range(n):
        layer = init_fn(gen)
        out = into.stack(layer, n) if out is None else out
        into.write(out, layer, i)
        del layer      # before the next layer is drawn
    return out


# ------------------------------------------------------- decoder-only ------
def dense_block_init(gen: torch.Generator, cfg: ModelConfig,
                     device) -> Params:
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
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cache is None:
        a = L.attention_fwd(p["attn"], cfg, h, pos)
    else:
        a, _, _ = L.attention_decode(p["attn"], cfg, h, cache[0], cache[1],
                                     pos)
    x = x + a
    m, aux = _ffn(cfg, p, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return (x if m is None else x + m), aux


def decoder_init(gen: torch.Generator, cfg: ModelConfig, device,
                 into: L.Whole = L.WHOLE) -> Params:
    return {
        "embed": L.embed_init(gen, cfg, device, into.at("embed")),
        "layers": _stack_init(gen, cfg.n_layers,
                              lambda g: dense_block_init(g, cfg, device),
                              into.at("layers")),
        "lnf": into.at("lnf").put(
            L.rmsnorm_init(cfg.d_model, L._dtype(cfg), device)),
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
    S = x.shape[1]
    Tw = caches[0].shape[2]
    for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
        hn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], cfg, hn, pos)
        a = L.self_attend(q, k, v, cfg, cfg.swa_window)
        x = x + a @ p["attn"]["wo"]
        m, _ = _ffn(cfg, p, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
        if m is not None:
            x = x + m
        caches[0][i].copy_(_ring(k, S, Tw))
        caches[1][i].copy_(_ring(v, S, Tw))
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)


# ------------------------------------------ decoder, tensor parallel ------
# The decoder over a data shard's model shards: ``ps`` holds each shard's
# blocks of the parameters, ``xs`` each shard's copy of the residual stream
# (replicated), ``pos`` each shard's positions, ``tp`` the group
# (``distributed.tensor_parallel.Group``); ``layers.py``'s tensor-parallel
# section says how a shard reads its blocks. Each row-parallel product is
# summed across the shards before its residual add.
def _tp_ffn(cfg: ModelConfig, tp, ps, xs):
    """The residual stream after the block's MoE or MLP: (xs, aux)."""
    hs = [L.rmsnorm(p["ln2"], x, cfg.norm_eps) for p, x in zip(ps, xs)]
    if cfg.is_moe:
        ys, aux = MOE.tp_moe_fwd(tp, [p["moe"] for p in ps], cfg, hs)
    elif cfg.d_ff:
        ys, aux = tp.reduce(*L.tp_mlp([p["mlp"] for p in ps], cfg, hs)), None
    else:
        return xs, None
    return [x + y for x, y in zip(xs, ys)], aux


def tp_block_fwd(cfg: ModelConfig, tp, ps, xs, pos, caches=None):
    """``dense_block_fwd`` over the model shards -> (xs, aux); ``caches``
    each shard's ``(k, v)`` block of a decode step's cache, updated in
    place."""
    hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(ps, xs)]
    attn = [p["attn"] for p in ps]
    if caches is None:
        a, _, split = L.tp_attention_fwd(tp, attn, cfg, hs, pos)
    else:
        a, split = L.tp_attention_decode(tp, attn, cfg, hs, caches, pos)
    xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
    return _tp_ffn(cfg, tp, ps, xs)


def _tp_layers(cfg: ModelConfig, ps, key: str = "layers",
               n: Optional[int] = None) -> List[List[Params]]:
    """Layer i's blocks of the stack ``key``, one a shard, for each
    layer."""
    per = [_unstack(p[key], n or cfg.n_layers) for p in ps]
    return [list(layer) for layer in zip(*per)]


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, (dict, list)):
        vals = tree.values() if isinstance(tree, dict) else tree
        return [t for v in vals for t in _tensors(v)]
    return [tree]


def _refill(tree, it):
    """``tree`` with its tensors, in ``_tensors`` order, taken from
    ``it``."""
    if isinstance(tree, dict):
        return {k: _refill(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_refill(v, it) for v in tree]
    return next(it)


def _tp_checkpoint(fn, xs, tree) -> List[torch.Tensor]:
    """``fn(xs, tree)`` (a list of tensors) under the reentrant
    ``torch.utils.checkpoint``, ``xs`` and every tensor of ``tree`` (the
    layer's blocks of the parameters, and any other input that needs a
    gradient) passed as its inputs, so that their gradients leave through
    it. The non-reentrant one recomputes a layer from whichever device's
    backward thread first unpacks one of its saved tensors, and two
    cards' threads may do so at once; the reentrant one recomputes inside
    its own backward node, once. Its forward runs without grad, so a scan
    inside it runs in one call; the recompute runs with grad, each scan
    in its checkpointed chunks (``ssm._scan``), nested."""
    n = len(xs)

    def run(*args):
        return tuple(fn(list(args[:n]), _refill(tree, iter(args[n:]))))

    return list(checkpoint(run, *xs, *_tensors(tree), use_reentrant=True,
                           preserve_rng_state=False))


def tp_decoder_fwd(cfg: ModelConfig, tp, ps, xs, pos, caches=None):
    """``decoder_fwd`` over the model shards: with grad enabled and no
    caches each layer runs under ``_tp_checkpoint``; ``caches`` each
    shard's ``(k [L, B, T, n, dh], v)`` blocks, updated in place by a
    decode step. Returns (each shard's
    normed hidden states, the MoE auxiliary loss on shard 0's device)."""
    remat = caches is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    n = len(xs)

    def block(ys, lp):
        ys, a = tp_block_fwd(cfg, tp, lp, ys, pos)
        return ys + ([] if a is None else [a])

    for i, lp in enumerate(_tp_layers(cfg, ps)):
        if remat:
            out = _tp_checkpoint(block, xs, lp)
            xs, a = out[:n], (out[n] if len(out) > n else None)
        else:
            xs, a = tp_block_fwd(cfg, tp, lp, xs, pos, None if caches is None
                                 else [(k[i], v[i]) for k, v in caches])
        if a is not None:
            aux = aux + a
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps)
            for p, x in zip(ps, xs)], aux


def _tp_fill(cfg: ModelConfig, tp, caches, i: int, kvs, S: int) -> None:
    """Writes layer i of each shard's ring caches ``caches[m] = (k, v)``,
    each ``[L, B, T, n, dh]``, from its whole ``kvs[m] = (k, v)`` of the
    prompt: the block's KV heads (split on ``model``, or all of them), or
    under a sequence-split cache (``tp.kv_slots``) every head of the
    slots ``[m T, (m + 1) T)`` of ``_ring``'s ``tp.kv_slots``."""
    Tw = tp.kv_slots
    for m, ((k, v), (ck, cv)) in enumerate(zip(kvs, caches)):
        T = ck.shape[2]
        c = L.cache_heads(cfg, ck.shape[3], m)
        t0 = m * T if Tw else 0
        ck[i].copy_(_ring(k[:, :, c], S, Tw or T)[:, t0:t0 + T])
        cv[i].copy_(_ring(v[:, :, c], S, Tw or T)[:, t0:t0 + T])


def tp_decoder_prefill(cfg: ModelConfig, tp, ps, xs, pos, caches):
    """``decoder_prefill`` over the model shards: each shard fills its
    block of the ring caches ``caches[m] = (k, v)``, each ``[L, B, T, n,
    dh]`` (``_tp_fill``: its KV heads where ``cache_specs`` splits them,
    its slots where it splits the sequence, all of it where the cache is
    whole). Returns each shard's normed hidden states."""
    S = xs[0].shape[1]
    for i, lp in enumerate(_tp_layers(cfg, ps)):
        hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
        a, kvs, split = L.tp_attention_fwd(tp, [p["attn"] for p in lp], cfg,
                                           hs, pos)
        xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
        xs, _ = _tp_ffn(cfg, tp, lp, xs)
        _tp_fill(cfg, tp, caches, i, kvs, S)
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]


# ----------------------------------------------------------- zamba2 --------
ZAMBA_WINDOW = 4096  # shared-attention sliding window (long-context safety)


def _groups(cfg: ModelConfig, every: int) -> Tuple[int, int]:
    """(groups, layers past the last group) of a stack in groups of
    ``every`` layers."""
    return cfg.n_layers // every, cfg.n_layers % every


def zamba2_init(gen: torch.Generator, cfg: ModelConfig, device,
                into: L.Whole = L.WHOLE) -> Params:
    inner = cfg.attn_every
    n_super, tail = _groups(cfg, inner)
    dt = L._dtype(cfg)

    def layer(g):
        return _mamba_layer_init(g, cfg, device)

    p = {
        "embed": L.embed_init(gen, cfg, device, into.at("embed")),
        "super": _stack_init(gen, n_super,
                             lambda g: _stack_init(g, inner, layer),
                             into.at("super")),
        "shared_ln": into.at("shared_ln").put(
            L.rmsnorm_init(cfg.d_model, dt, device)),
        "shared_attn": into.at("shared_attn").put(
            L.attention_init(gen, cfg, device)),
        "lnf": into.at("lnf").put(L.rmsnorm_init(cfg.d_model, dt, device)),
    }
    if tail:
        p["tail"] = _stack_init(gen, tail, layer, into.at("tail"))
    return p


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig,
                      device) -> Params:
    dt = L._dtype(cfg)
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device),
        "mamba": SSM.mamba2_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
        "mlp": L.mlp_init(gen, cfg, device),
    }


def _mamba_layer_fwd(cfg: ModelConfig, p: Params, x, state):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    m, state = SSM.mamba2_fwd(p["mamba"], cfg, h, state)
    x = x + m
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.mlp_fwd(p["mlp"], cfg, h), state


def _mamba_layers(cfg: ModelConfig, stacked: Params, n: int, x, states,
                  decode: bool, remat: bool = False):
    """n Mamba layers from stacked ``[n, ...]`` leaves. ``states``, a
    ``[n, B, H, N, P]`` cache leaf or None, receives each layer's final
    state; a decode step starts from it. With ``remat`` (a full forward
    under grad) each layer runs under ``torch.utils.checkpoint``."""
    for i, p in enumerate(_unstack(stacked, n)):
        if remat:
            x = checkpoint(_mamba_layer_fwd, cfg, p, x, None,
                           use_reentrant=False)[0]
            continue
        x, s = _mamba_layer_fwd(cfg, p, x, states[i] if decode else None)
        if states is not None:
            states[i].copy_(s)
    return x


def _shared_attention(cfg: ModelConfig, ln: Params, attn: Params, x, pos):
    """zamba2's shared attention block in a full forward: x plus the
    windowed attention of its norm."""
    a, _, _ = L.windowed_attention(attn, cfg, L.rmsnorm(ln, x, cfg.norm_eps),
                                   pos, ZAMBA_WINDOW)
    return x + a


def zamba2_fwd(cfg: ModelConfig, params: Params, x, pos,
               cache: Optional[Dict] = None, decode: bool = False):
    """Returns the normed hidden states. ``cache``: {"ssm": [n_super,
    inner, B,H,N,P], "tail_ssm": [tail, ...], "ak"/"av": [n_super, B, Tw,
    Hkv, dh]}, or None for a full forward. A prefill (``decode`` False)
    runs from the zero state and writes every leaf of the cache (K/V by
    ``_ring``, all Tw slots); a decode step runs from the cache and
    updates it in place. A full forward under grad runs each Mamba layer,
    and each group's shared attention, under ``torch.utils.checkpoint``
    (the reference remats each group); the shared attention's leaves
    then take one gradient a group, summed."""
    inner = cfg.attn_every
    n_super, _ = _groups(cfg, inner)
    S = x.shape[1]
    remat = cache is None and torch.is_grad_enabled()
    ssm = None if cache is None else cache["ssm"]
    for g, pg in enumerate(_unstack(params["super"], n_super)):
        x = _mamba_layers(cfg, pg, inner, x,
                          None if ssm is None else ssm[g], decode, remat)
        # shared attention block (weights shared across groups)
        if remat:
            x = checkpoint(_shared_attention, cfg, params["shared_ln"],
                           params["shared_attn"], x, pos,
                           use_reentrant=False)
            continue
        hn = L.rmsnorm(params["shared_ln"], x, cfg.norm_eps)
        if decode:
            a, _, _ = L.attention_decode(params["shared_attn"], cfg, hn,
                                         cache["ak"][g], cache["av"][g],
                                         pos, window=ZAMBA_WINDOW)
        else:
            a, k, v = L.windowed_attention(params["shared_attn"], cfg, hn,
                                           pos, ZAMBA_WINDOW)
            if cache is not None:
                Tw = cache["ak"].shape[2]
                cache["ak"][g].copy_(_ring(k, S, Tw))
                cache["av"][g].copy_(_ring(v, S, Tw))
        x = x + a
    if "tail" in params:
        nt = params["tail"]["ln1"]["scale"].shape[0]
        x = _mamba_layers(cfg, params["tail"], nt, x,
                          None if cache is None else cache["tail_ssm"],
                          decode, remat)
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)


# ------------------------------------------------------------ xlstm --------
def xlstm_init(gen: torch.Generator, cfg: ModelConfig, device,
               into: L.Whole = L.WHOLE) -> Params:
    inner = cfg.slstm_every - 1          # mLSTM layers per group
    n_super, _ = _groups(cfg, cfg.slstm_every)

    def group_init(g):
        return {"m": _stack_init(g, inner, lambda g2: _xl_layer_init(
                    g2, cfg, "m", device)),
                "s": _xl_layer_init(g, cfg, "s", device)}

    return {
        "embed": L.embed_init(gen, cfg, device, into.at("embed")),
        "super": _stack_init(gen, n_super, group_init, into.at("super")),
        "lnf": into.at("lnf").put(
            L.rmsnorm_init(cfg.d_model, L._dtype(cfg), device)),
    }


def _xl_layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                   device) -> Params:
    p = {"ln": L.rmsnorm_init(cfg.d_model, L._dtype(cfg), device)}
    p["core"] = SSM.mlstm_init(gen, cfg, device) if kind == "m" else \
        SSM.slstm_init(gen, cfg, device)
    return p


def _xl_layer_fwd(cfg: ModelConfig, fwd, p: Params, x, state):
    """An mLSTM or sLSTM layer (``fwd``) with its residual -> (x, the
    final state)."""
    y, state = fwd(p["core"], cfg, L.rmsnorm(p["ln"], x, cfg.norm_eps),
                   state)
    return x + y, state


def xlstm_fwd(cfg: ModelConfig, params: Params, x, pos,
              cache: Optional[Dict] = None, decode: bool = False):
    """Returns the normed hidden states. ``cache``: {"mC": [n_super, inner,
    B,H,dh,dh], "mn": [n_super, inner, B,H,dh], "sc"/"sn": [n_super, B,
    d]}, or None for a full forward; a prefill writes the final states
    into it, a decode step starts from them and updates them in place.
    ``pos`` is unused: these layers have no positions. A full forward
    under grad runs each layer under ``torch.utils.checkpoint``."""
    inner = cfg.slstm_every - 1
    n_super, _ = _groups(cfg, cfg.slstm_every)
    remat = cache is None and torch.is_grad_enabled()

    def run(fwd, p, h, keys, idx):
        if remat:
            return checkpoint(_xl_layer_fwd, cfg, fwd, p, h, None,
                              use_reentrant=False)[0]
        s0 = tuple(cache[k][idx] for k in keys) if decode else None
        h, s = _xl_layer_fwd(cfg, fwd, p, h, s0)
        if cache is not None:
            for k, v in zip(keys, s):
                cache[k][idx].copy_(v)
        return h

    for g, pg in enumerate(_unstack(params["super"], n_super)):
        for i, p in enumerate(_unstack(pg["m"], inner)):
            x = run(SSM.mlstm_fwd, p, x, ("mC", "mn"), (g, i))
        x = run(SSM.slstm_fwd, pg["s"], x, ("sc", "sn"), g)
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)


# ----------------------------------------------------- encoder-decoder -----
def encdec_init(gen: torch.Generator, cfg: ModelConfig, device,
                into: L.Whole = L.WHOLE) -> Params:
    """The reference's leaves: ``enc_layers`` (``ln1``, ``attn``, ``ln2``,
    ``mlp``) and ``dec_layers`` (also ``lnx`` and ``cross``), stacked,
    beside ``embed``, ``enc_lnf`` and ``lnf``; drawn in that order."""
    dt = L._dtype(cfg)

    def norm():
        return L.rmsnorm_init(cfg.d_model, dt, device)

    def enc_layer(g):
        return {"ln1": norm(), "attn": L.attention_init(g, cfg, device),
                "ln2": norm(), "mlp": L.mlp_init(g, cfg, device)}

    def dec_layer(g):
        return {"ln1": norm(), "attn": L.attention_init(g, cfg, device),
                "lnx": norm(), "cross": L.attention_init(g, cfg, device),
                "ln2": norm(), "mlp": L.mlp_init(g, cfg, device)}

    return {
        "embed": L.embed_init(gen, cfg, device, into.at("embed")),
        "enc_layers": _stack_init(gen, cfg.n_enc_layers, enc_layer,
                                  into.at("enc_layers")),
        "enc_lnf": into.at("enc_lnf").put(norm()),
        "dec_layers": _stack_init(gen, cfg.n_layers, dec_layer,
                                  into.at("dec_layers")),
        "lnf": into.at("lnf").put(norm()),
    }


def _enc_layer_fwd(cfg: ModelConfig, p: Params, x):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + L.attention_fwd(p["attn"], cfg, h, None, causal=False)
    return x + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def encoder_fwd(cfg: ModelConfig, params: Params, frames: torch.Tensor):
    """frames: [B, F, d] (the stubbed conv frontend's output, the sinusoid
    added) -> the normed encoder output [B, F, d]. With grad enabled each
    layer runs under ``torch.utils.checkpoint``."""
    remat = torch.is_grad_enabled()
    x = frames
    for p in _unstack(params["enc_layers"], cfg.n_enc_layers):
        x = checkpoint(_enc_layer_fwd, cfg, p, x, use_reentrant=False) \
            if remat else _enc_layer_fwd(cfg, p, x)
    return L.rmsnorm(params["enc_lnf"], x, cfg.norm_eps)


def _cross_and_mlp(cfg: ModelConfig, p: Params, x, enc_out):
    """A decoder layer after its self-attention: cross-attention to
    ``enc_out``, then the MLP, each on its own norm and residual."""
    h = L.rmsnorm(p["lnx"], x, cfg.norm_eps)
    x = x + L.cross_attention_fwd(p["cross"], cfg, h, enc_out)
    return x + L.mlp_fwd(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _dec_layer_fwd(cfg: ModelConfig, p: Params, x, pos, enc_out,
                   cache: Optional[Tuple] = None):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cache is None:
        a = L.attention_fwd(p["attn"], cfg, h, pos)
    else:
        a, _, _ = L.attention_decode(p["attn"], cfg, h, cache[0], cache[1],
                                     pos)
    return _cross_and_mlp(cfg, p, x + a, enc_out)


def encdec_fwd(cfg: ModelConfig, params: Params, x, pos, enc_out,
               caches: Optional[Tuple] = None):
    """The decoder over ``enc_out`` [B, F, d]: a full forward
    (``caches=None``; with grad enabled each layer under
    ``torch.utils.checkpoint``) or a decode step on ``caches = (k, v)``,
    each ``[L, B, Tw, Hkv, dh]``, updated in place. Returns the normed
    hidden states."""
    remat = caches is None and torch.is_grad_enabled()
    for i, p in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        if remat:
            x = checkpoint(_dec_layer_fwd, cfg, p, x, pos, enc_out,
                           use_reentrant=False)
        else:
            cache = None if caches is None else (caches[0][i], caches[1][i])
            x = _dec_layer_fwd(cfg, p, x, pos, enc_out, cache)
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)


def encdec_prefill(cfg: ModelConfig, params: Params, x, pos, enc_out,
                   caches: Tuple[torch.Tensor, torch.Tensor]):
    """The decoder over the prompt once, its causal self-attention on the
    flash kernel, filling all ``Tw`` slots of the self-attention caches
    ``caches = (k, v)``, each ``[L, B, Tw, Hkv, dh]``, in place (the
    reference's ring keeps S of them when S < Tw: see the module
    docstring). Returns the normed hidden states."""
    S = x.shape[1]
    Tw = caches[0].shape[2]
    for i, p in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], cfg, h, pos)
        a = L.flash_sdpa(q, k, v) @ p["attn"]["wo"]
        x = _cross_and_mlp(cfg, p, x + a, enc_out)
        caches[0][i].copy_(_ring(k, S, Tw))
        caches[1][i].copy_(_ring(v, S, Tw))
    return L.rmsnorm(params["lnf"], x, cfg.norm_eps)


# ------------------------------------ the other stacks, tensor parallel ----
# zamba2, xLSTM and the encoder-decoder over a data shard's model shards,
# laid out as the decoder's section above says; each layer (and zamba2's
# shared attention) runs under ``_tp_checkpoint`` in a full forward under
# grad. ``caches`` holds each shard's blocks of the cache (placed by
# ``cache_specs``): the recurrent states split on heads or channels,
# zamba2's ``ak``/``av`` on KV heads, whisper's ``k``/``v`` on KV heads or
# (``REPRO_KV_SHARD=seq``) on slots, its ``enc_out`` on ``d``.
def _tp_mamba_layer(cfg: ModelConfig, tp, lp, xs, states=None):
    """``_mamba_layer_fwd`` over the model shards -> (xs, each shard's
    final state)."""
    hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    ms, st, split = SSM.tp_mamba2_fwd(tp, [p["mamba"] for p in lp], cfg,
                                      hs, states)
    xs = [x + y for x, y in zip(xs, tp.reduce(ms, split))]
    hs = [L.rmsnorm(p["ln2"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    ys = tp.reduce(*L.tp_mlp([p["mlp"] for p in lp], cfg, hs))
    return [x + y for x, y in zip(xs, ys)], st


def _tp_mamba_layers(cfg: ModelConfig, tp, stacks, n: int, xs, states,
                     decode: bool, remat: bool):
    """``_mamba_layers`` over the model shards: ``stacks`` each shard's
    stacked ``[n, ...]`` leaves, ``states`` each shard's ``[n, B, h, N,
    P]`` cache block or None."""
    per = [_unstack(s, n) for s in stacks]
    for i, lp in enumerate(zip(*per)):
        lp = list(lp)
        if remat:
            xs = _tp_checkpoint(
                lambda ys, t: _tp_mamba_layer(cfg, tp, t, ys)[0], xs, lp)
            continue
        xs, st = _tp_mamba_layer(cfg, tp, lp, xs, [s[i] for s in states]
                                 if decode else None)
        if states is not None:
            for dst, src in zip(states, st):
                dst[i].copy_(src)
    return xs


def tp_zamba2_fwd(cfg: ModelConfig, tp, ps, xs, pos, caches=None,
                  decode: bool = False):
    """``zamba2_fwd`` over the model shards -> each shard's normed hidden
    states: a full forward (``caches=None``), a prefill (each shard writes
    its blocks of every state and, by ``_tp_fill``, of ``ak``/``av``) or a
    decode step (``decode``). The shared attention runs each shard's query
    heads under ``ZAMBA_WINDOW``, as ``windowed_attention`` does."""
    inner = cfg.attn_every
    n_super, _ = _groups(cfg, inner)
    S = xs[0].shape[1]
    remat = caches is None and torch.is_grad_enabled()
    groups = [_unstack(p["super"], n_super) for p in ps]
    shared = [{"ln": p["shared_ln"], "attn": p["shared_attn"]} for p in ps]

    def norms(sh, ys):
        return [L.rmsnorm(t["ln"], y, cfg.norm_eps) for t, y in zip(sh, ys)]

    def attend(ys, sh):
        a, kvs, split = L.tp_attention_fwd(tp, [t["attn"] for t in sh], cfg,
                                           norms(sh, ys), pos, ZAMBA_WINDOW)
        return [y + o for y, o in zip(ys, tp.reduce(a, split))], kvs

    for g in range(n_super):
        xs = _tp_mamba_layers(cfg, tp, [gr[g] for gr in groups], inner, xs,
                              None if caches is None else
                              [c["ssm"][g] for c in caches], decode, remat)
        if remat:
            xs = _tp_checkpoint(lambda ys, sh: attend(ys, sh)[0], xs, shared)
        elif decode:
            a, split = L.tp_attention_decode(
                tp, [t["attn"] for t in shared], cfg, norms(shared, xs),
                [(c["ak"][g], c["av"][g]) for c in caches], pos,
                window=ZAMBA_WINDOW)
            xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
        else:
            xs, kvs = attend(xs, shared)
            if caches is not None:
                _tp_fill(cfg, tp, [(c["ak"], c["av"]) for c in caches], g,
                         kvs, S)
    if "tail" in ps[0]:
        nt = ps[0]["tail"]["ln1"]["scale"].shape[0]
        xs = _tp_mamba_layers(cfg, tp, [p["tail"] for p in ps], nt, xs,
                              None if caches is None else
                              [c["tail_ssm"] for c in caches], decode, remat)
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]


def tp_xlstm_fwd(cfg: ModelConfig, tp, ps, xs, pos, caches=None,
                 decode: bool = False):
    """``xlstm_fwd`` over the model shards (``tp_zamba2_fwd``'s modes):
    each mLSTM on its shard's heads, each sLSTM on its shard's channels,
    each shard's states in its cache blocks."""
    inner = cfg.slstm_every - 1
    n_super, _ = _groups(cfg, cfg.slstm_every)
    remat = caches is None and torch.is_grad_enabled()

    def layer(fwd, lp, ys, states=None):
        hs = [L.rmsnorm(p["ln"], y, cfg.norm_eps) for p, y in zip(lp, ys)]
        out, st, split = fwd(tp, [p["core"] for p in lp], cfg, hs, states)
        return [y + o for y, o in zip(ys, tp.reduce(out, split))], st

    def run(fwd, lp, ys, keys, idx):
        if remat:
            return _tp_checkpoint(lambda zs, t: layer(fwd, t, zs)[0], ys, lp)
        s0 = [tuple(c[k][idx] for k in keys) for c in caches] \
            if decode else None
        ys, st = layer(fwd, lp, ys, s0)
        if caches is not None:
            for c, s in zip(caches, st):
                for k, v in zip(keys, s):
                    c[k][idx].copy_(v)
        return ys

    groups = [_unstack(p["super"], n_super) for p in ps]
    for g in range(n_super):
        ms = [_unstack(gr[g]["m"], inner) for gr in groups]
        for i in range(inner):
            xs = run(SSM.tp_mlstm_fwd, [m[i] for m in ms], xs, ("mC", "mn"),
                     (g, i))
        xs = run(SSM.tp_slstm_fwd, [gr[g]["s"] for gr in groups], xs,
                 ("sc", "sn"), g)
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]


def _tp_enc_layer(cfg: ModelConfig, tp, lp, xs):
    hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    a, _, split = L.tp_attention_fwd(tp, [p["attn"] for p in lp], cfg, hs,
                                     [None] * len(xs), causal=False)
    xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
    hs = [L.rmsnorm(p["ln2"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    ys = tp.reduce(*L.tp_mlp([p["mlp"] for p in lp], cfg, hs))
    return [x + y for x, y in zip(xs, ys)]


def tp_encoder_fwd(cfg: ModelConfig, tp, ps, xs):
    """``encoder_fwd`` over the model shards, each shard's heads not
    causal on the flash kernel -> each shard's whole normed output."""
    remat = torch.is_grad_enabled()
    for lp in _tp_layers(cfg, ps, "enc_layers", cfg.n_enc_layers):
        xs = _tp_checkpoint(lambda ys, t: _tp_enc_layer(cfg, tp, t, ys),
                            xs, lp) if remat else _tp_enc_layer(cfg, tp, lp,
                                                                xs)
    return [L.rmsnorm(p["enc_lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]


def _tp_cross_and_mlp(cfg: ModelConfig, tp, lp, xs, encs):
    hs = [L.rmsnorm(p["lnx"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    a, split = L.tp_cross_attention(tp, [p["cross"] for p in lp], cfg, hs,
                                    encs)
    xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
    hs = [L.rmsnorm(p["ln2"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    ys = tp.reduce(*L.tp_mlp([p["mlp"] for p in lp], cfg, hs))
    return [x + y for x, y in zip(xs, ys)]


def _tp_dec_layer(cfg: ModelConfig, tp, lp, xs, pos, encs, caches=None):
    hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
    attn = [p["attn"] for p in lp]
    if caches is None:
        a, _, split = L.tp_attention_fwd(tp, attn, cfg, hs, pos)
    else:
        a, split = L.tp_attention_decode(tp, attn, cfg, hs, caches, pos)
    xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
    return _tp_cross_and_mlp(cfg, tp, lp, xs, encs)


def tp_encdec_fwd(cfg: ModelConfig, tp, ps, xs, pos, encs, caches=None):
    """``encdec_fwd`` over the model shards, ``encs`` each shard's whole
    encoder output: a full forward, or a decode step on ``caches[m] = (k,
    v)`` blocks."""
    remat = caches is None and torch.is_grad_enabled()
    for i, lp in enumerate(_tp_layers(cfg, ps, "dec_layers")):
        if remat:
            xs = _tp_checkpoint(lambda ys, t: _tp_dec_layer(
                cfg, tp, t["p"], ys, pos, t["enc"]), xs,
                {"p": lp, "enc": encs})
        else:
            xs = _tp_dec_layer(cfg, tp, lp, xs, pos, encs,
                               None if caches is None else
                               [(k[i], v[i]) for k, v in caches])
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]


def tp_encdec_prefill(cfg: ModelConfig, tp, ps, xs, pos, encs, caches):
    """``encdec_prefill`` over the model shards, each shard filling its
    blocks of the self-attention caches (``_tp_fill``)."""
    S = xs[0].shape[1]
    for i, lp in enumerate(_tp_layers(cfg, ps, "dec_layers")):
        hs = [L.rmsnorm(p["ln1"], x, cfg.norm_eps) for p, x in zip(lp, xs)]
        a, kvs, split = L.tp_attention_fwd(tp, [p["attn"] for p in lp], cfg,
                                           hs, pos)
        xs = [x + y for x, y in zip(xs, tp.reduce(a, split))]
        xs = _tp_cross_and_mlp(cfg, tp, lp, xs, encs)
        _tp_fill(cfg, tp, caches, i, kvs, S)
    return [L.rmsnorm(p["lnf"], x, cfg.norm_eps) for p, x in zip(ps, xs)]
