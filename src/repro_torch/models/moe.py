"""Mixture-of-Experts with capacity-based static dispatch.

Port of ``repro.models.moe``'s single-device path: Mixtral-style (8 routed,
top-2) and DeepSeek-MoE-style fine-grained routing (2 shared + 64 routed,
top-6, small per-expert d_ff), with the same names, parameter leaves and
semantics:

* a fp32 router on ``x.float()`` and a softmax; the top K of it,
  renormalised with ``+ 1e-9``;
* the Switch-style auxiliary loss ``E * sum(mean(probs) * counts/(T*K))``;
* capacity ``C = max(8, min(ceil(cf * T * K / E), T))``; the slot of a
  (token, k) pair within its expert is the number of earlier pairs in
  token-major, k-inner order that chose that expert (the reference's
  ``cumsum`` over the ``[T*K, E]`` one-hot; here a stable sort by
  expert), and a pair is kept when its slot is below C, so drops fall on
  the same pairs;
* SwiGLU experts ``silu(xe @ wi) * (xe @ wg) @ wo`` in the config's dtype,
  the combine in fp32, shared experts on every token, the output in
  ``x.dtype``.

What differs: the reference dispatches through the one-hot
``slot_oh [T, K, E, C]`` in fp32 (12.1 GB for deepseek-moe-16b at 4 x 2048
tokens) and two ``[T, E, C]`` products. ``moe_fwd`` routes by index
instead: each (expert, slot) row of ``[E, C, d]`` gathers the token of the
kept pair there (zeros where none is), the experts run as batched products
over E, and each pair gathers its expert's output row back, weighted by
its gate (0 when dropped); the reference's ``REPRO_MOE_SCATTER`` branch of
``_moe_groups`` routes the same way, scattering the rows instead.
``moe_fwd_onehot`` is the reference's one-hot form, transcribed, which the
tests hold ``moe_fwd`` against; nothing on the model's path calls it.
The reference's grouped dispatch (``_moe_groups`` under
``REPRO_MOE_GROUPED=1``: each data-parallel group of tokens routed alone,
with its own capacity and auxiliary loss, the loss taking their mean) is
what the data-parallel steps do (``launch/steps.py`` on a mesh): each
data shard runs ``moe_fwd`` on its own tokens, G = the shard count, and
the step's loss is the mean of the shards'. ``tp_moe_fwd`` runs one
data shard's layer over its model shards, as GSPMD partitions the
reference's at its ``shard_act`` sites (``moe.py:113,117,173-188``):
the route once, then expert- or ffn-parallel by the sharding rules.

Every op is out of place, so ``moe_fwd`` is differentiable (``Model.loss``
runs through it); the gradient reaches x through the two gathers, and
the router through the gates and the auxiliary loss.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = L._dtype(cfg)
    d = cfg.d_model
    f = cfg.d_ff_expert or cfg.d_ff
    E = cfg.n_experts
    scale = 1.0 / np.sqrt(d)
    p = {
        "router": L.dense_init(gen, d, E, torch.float32, device),
        "wi": L._randn(gen, (E, d, f), device).mul_(scale).to(dt),
        "wg": L._randn(gen, (E, d, f), device).mul_(scale).to(dt),
        "wo": L._randn(gen, (E, f, d), device).div_(np.sqrt(f)).to(dt),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi": L.dense_init(gen, d, fs, dt, device),
                       "wg": L.dense_init(gen, d, fs, dt, device),
                       "wo": L.dense_init(gen, fs, d, dt, device)}
    return p


def capacity(T: int, E: int, K: int, capacity_factor: float) -> int:
    """Rows an expert takes: ``max(8, min(ceil(cf * T * K / E), T))``."""
    C = int(np.ceil(capacity_factor * T * K / E))
    return max(8, min(C, T))


class Route(NamedTuple):
    gate_vals: torch.Tensor   # [T, K] fp32, renormalised top-K probs
    gate_idx: torch.Tensor    # [T, K] int64, the chosen experts
    slot: torch.Tensor        # [T, K] int64, the pair's row in its expert
    keep: torch.Tensor        # [T, K] bool, slot < capacity
    aux: torch.Tensor         # fp32 scalar, the load-balancing loss
    capacity: int


def _router(p: Dict, cfg: ModelConfig, xt: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gate_vals, gate_idx, aux) of the tokens ``xt [T, d]``."""
    E, K = cfg.n_experts, cfg.moe_top_k
    T = xt.shape[0]
    logits = xt.float() @ p["router"]                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)    # [T, K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    # load-balancing auxiliary loss (Switch-style); the counts by a one-hot
    # sum, since bincount waits for the card to size its output
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx.reshape(-1), E).sum(0).float() / (T * K)
    aux = E * torch.sum(me * ce)
    return gate_vals, gate_idx, aux


def route(p: Dict, cfg: ModelConfig, xt: torch.Tensor,
          capacity_factor: float = 1.25) -> Route:
    """The routing of the tokens ``xt [T, d]``: each (token, k) pair's
    expert, gate, slot within the expert and whether capacity keeps it."""
    E, K = cfg.n_experts, cfg.moe_top_k
    T = xt.shape[0]
    gate_vals, gate_idx, aux = _router(p, cfg, xt)
    C = capacity(T, E, K, capacity_factor)
    slot = slots(gate_idx, E)
    return Route(gate_vals, gate_idx, slot, slot < C, aux, C)


def route_flips(a: Route, b: Route) -> int:
    """The (token, k) pairs of route ``a`` whose expert is not among the
    token's top K in route ``b``: the routes two runs pick differently,
    whatever their order within the top K."""
    ga, gb = a.gate_idx, b.gate_idx.to(a.gate_idx.device)
    return int((~(ga[:, :, None] == gb[:, None, :]).any(-1)).sum())


def slots(gate_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Each (t, k) pair's count of earlier pairs, in token-major, k-inner
    order, that chose its expert ``gate_idx [T, K]``. A stable sort by
    expert keeps each expert's pairs in that order, so a pair's rank among
    its expert's is the reference's cumsum count (a cumsum down the
    ``[T*K, E]`` one-hot is one long serial scan a column on the card)."""
    e = gate_idx.reshape(-1)
    e_sorted, order = torch.sort(e, stable=True)
    first = torch.searchsorted(e_sorted, torch.arange(E, device=e.device))
    rank = torch.arange(e.numel(), device=e.device) - first[e_sorted]
    return torch.empty_like(e).scatter_(0, order, rank).view(gate_idx.shape)


def _experts(p: Dict, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: xe [E, C, d] -> [E, C, d]."""
    h = F.silu(torch.bmm(xe, p["wi"])) * torch.bmm(xe, p["wg"])
    return torch.bmm(h, p["wo"])


def _shared_out(sh: Dict, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts on every token (fp32), over whatever hidden
    columns ``sh``'s leaves hold."""
    hs = F.silu(xt @ sh["wi"]) * (xt @ sh["wg"])
    return (hs @ sh["wo"]).float()


def _shared(p: Dict, cfg: ModelConfig, xt: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """y plus the shared experts on every token (fp32)."""
    if not cfg.n_shared_experts:
        return y
    return y + _shared_out(p["shared"], xt)


def _routed(p: Dict, cfg: ModelConfig, xt: torch.Tensor, r: Route,
            e0: int = 0) -> torch.Tensor:
    """The routed experts' output ``[T, d]`` (fp32): each kept pair that
    landed on the experts ``[e0, e0 + n)`` that ``p`` holds (n its leading
    dimension; all of them on one device) gathers its expert's output row
    for its token, weighted by its gate; other pairs add nothing."""
    T, d = xt.shape
    K = cfg.moe_top_k
    n = p["wi"].shape[0]
    C = r.capacity
    mine = r.keep
    if n < cfg.n_experts:
        mine = mine & (r.gate_idx >= e0) & (r.gate_idx < e0 + n)
    row = (r.gate_idx - e0) * C + r.slot                  # [T, K]
    # each expert row's token (T, a zero row, where no pair landed); the
    # other pairs write one spare entry past n*C, which is cut off
    dest = torch.where(mine, row, n * C).reshape(T * K)
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)
    src_tok = torch.full((n * C + 1,), T, device=xt.device).scatter_(
        0, dest, tok)[:n * C]
    xe = F.pad(xt, (0, 0, 0, 1))[src_tok].view(n, C, d)
    ye = _experts(p, xe).reshape(n * C, d)
    src = torch.where(mine, row, 0).reshape(T * K)
    w = r.gate_vals * mine                                # [T, K] fp32
    return torch.bmm(w[:, None, :], ye[src].view(T, K, d).float())[:, 0]


def moe_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss), routed by index."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, cfg, xt, capacity_factor)
    y = _shared(p, cfg, xt, _routed(p, cfg, xt, r))
    return y.reshape(B, S, d).to(x.dtype), r.aux


def tp_moe_fwd(tp, ps, cfg: ModelConfig, xs, capacity_factor: float = 1.25
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``moe_fwd`` over a data shard's model shards (``layers.py``'s
    tensor-parallel section says how ``ps``, ``xs`` and ``tp`` are laid
    out) -> (y on every shard, aux on shard 0's device). The route is
    computed once, on shard 0 from its copy of the replicated router, and
    copied to the others, so the drops are the one-device route's and aux
    counts once. Expert-parallel (``E % M == 0``): each shard runs its
    E / M experts on the rows that landed on them and combines those
    pairs. Ffn-parallel (the rules split ``f``): each shard runs every
    expert on its slice of ``f``. Either way the shards' fp32 outputs are
    partial and summed in shard order; the shared experts are split as an
    MLP is (``layers.tp_mlp``). A part the guard keeps whole runs whole
    on every shard and joins after the sum."""
    B, S, d = xs[0].shape
    T, E = B * S, cfg.n_experts
    f = cfg.d_ff_expert or cfg.d_ff
    r = route(ps[0], cfg, xs[0].reshape(T, d), capacity_factor)
    xts = [x.reshape(T, d) for x in xs]
    routed = []
    for m, (p, xt) in enumerate(zip(ps, xts)):
        rm = Route(*(t.to(xt.device) if torch.is_tensor(t) else t
                     for t in r))
        n = p["wi"].shape[0]
        routed.append(_routed(p, cfg, xt, rm, m * n if n < E else 0))
    terms = [(routed, ps[0]["wi"].shape[0] < E
              or ps[0]["wi"].shape[-1] < f)]
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        outs = []
        for m, (p, xt) in enumerate(zip(ps, xts)):
            sh = p["shared"]
            lo, hi = L.block_cols(sh["wo"].shape[0], fs, m)
            outs.append(_shared_out({k: w if k == "wo" else
                                     L._cols(w, lo, hi)
                                     for k, w in sh.items()}, xt))
        terms.append((outs, ps[0]["shared"]["wo"].shape[0] < fs))
    ys = _add_terms(tp, terms)
    return [y.reshape(B, S, d).to(x.dtype) for y, x in zip(ys, xs)], r.aux


def _add_terms(tp, terms) -> List[torch.Tensor]:
    """The sum of (parts, split) terms on every shard: the split terms'
    parts added on each shard and summed across the shards in shard
    order, then each whole term's own part."""
    part = whole = None
    for vals, split in terms:
        if split:
            part = vals if part is None else [a + b
                                              for a, b in zip(part, vals)]
        else:
            whole = vals if whole is None else [a + b
                                                for a, b in zip(whole, vals)]
    if part is None:
        return whole
    part = tp.sum(part)
    return part if whole is None else [a + b for a, b in zip(part, whole)]


def onehot_slots(gate_idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The reference's ``slot_oh [T, K, E, C]`` (fp32): 1 at (t, k, the
    pair's expert, its slot) for each pair capacity keeps, by the cumsum
    over the ``[T*K, E]`` one-hot."""
    T, K = gate_idx.shape
    onehot = F.one_hot(gate_idx, E).float()               # [T, K, E]
    pos_in_e = onehot.reshape(T * K, E).cumsum(0).reshape(T, K, E) - 1.0
    keep = (pos_in_e < C) & (onehot > 0)
    slot = pos_in_e.clamp(0, C - 1).long()
    return ((slot[..., None] == torch.arange(C, device=slot.device))
            & keep[..., None]).float()


def moe_fwd_onehot(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                   capacity_factor: float = 1.25
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's one-hot dispatch (``moe.py:72-124``), transcribed:
    the yardstick ``moe_fwd`` is held against; it holds ``[T, K, E, C]``
    in fp32."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    gate_vals, gate_idx, aux = _router(p, cfg, xt)
    slot_oh = onehot_slots(gate_idx, E, capacity(T, E, K, capacity_factor))
    dispatch = slot_oh.sum(1)                             # [T, E, C]
    combine = (slot_oh * gate_vals[..., None, None]).sum(1)
    xe = torch.einsum("td,tec->ecd", xt.float(), dispatch).to(x.dtype)
    ye = _experts(p, xe)
    y = torch.einsum("ecd,tec->td", ye.float(), combine)
    y = _shared(p, cfg, xt, y)
    return y.reshape(B, S, d).to(x.dtype), aux
