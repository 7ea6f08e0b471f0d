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
the step's loss is the mean of the shards'.

Every op is out of place, so ``moe_fwd`` is differentiable (``Model.loss``
runs through it); the gradient reaches x through the two gathers, and
the router through the gates and the auxiliary loss.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

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


def _shared(p: Dict, cfg: ModelConfig, xt: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """y plus the shared experts on every token (fp32)."""
    if not cfg.n_shared_experts:
        return y
    sh = p["shared"]
    hs = F.silu(xt @ sh["wi"]) * (xt @ sh["wg"])
    return y + (hs @ sh["wo"]).float()


def moe_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss), routed by index."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)
    r = route(p, cfg, xt, capacity_factor)
    C = r.capacity
    row = r.gate_idx * C + r.slot                         # [T, K]
    # each expert row's token (T, a zero row, where no pair landed); the
    # dropped pairs write one spare entry past E*C, which is cut off
    dest = torch.where(r.keep, row, E * C).reshape(T * K)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    src_tok = torch.full((E * C + 1,), T, device=x.device).scatter_(
        0, dest, tok)[:E * C]
    xe = F.pad(xt, (0, 0, 0, 1))[src_tok].view(E, C, d)
    ye = _experts(p, xe).reshape(E * C, d)
    src = torch.where(r.keep, row, 0).reshape(T * K)
    w = r.gate_vals * r.keep                              # [T, K] fp32
    y = torch.bmm(w[:, None, :], ye[src].view(T, K, d).float())[:, 0]
    y = _shared(p, cfg, xt, y)
    return y.reshape(B, S, d).to(x.dtype), r.aux


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
