"""AdamW with fp32 master state over bf16 params, gradient clipping, cosine
schedule, and optional int8-compressed gradients with error feedback.

Port of ``repro.optim.adamw`` over nested dicts of tensors: the same
names, the same fp32 arithmetic in the same order. Params of a lower
precision are read as fp32 and written back rounded to their dtype, as the
reference's ``upd`` does. ``torch.round`` rounds half to even, as
``jnp.round`` does. Every function is functional: it returns new tensors
and leaves its inputs as they are. ``apply`` updates a leaf of more than
``CHUNK`` elements a slice of its leading axis at a time (the same
elementwise arithmetic, so the same bits), which bounds its fp32
temporaries to a few chunks: on a stacked ``[L, ...]`` leaf of a billion
elements they would otherwise be several whole fp32 copies of it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch


# elements of a leaf that ``apply`` updates at once (256 MiB in fp32)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: Any                  # int32 scalar tensor
    m: Any
    v: Any
    ef: Optional[Any] = None   # error-feedback residual (compression)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, leaf for leaf with ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def init(params, compress: bool = False) -> AdamWState:
    """Zero fp32 moments (and residuals with ``compress``) shaped like
    ``params``, on each leaf's device (meta leaves give meta state)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(leaves(params)).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params), v=tree_map(zeros, params),
        ef=tree_map(zeros, params) if compress else None)


def cosine_lr(step, base_lr=3e-4, warmup=200, total=10000):
    """Linear warm-up to ``base_lr``, then a cosine to 0 at ``total``;
    ``step`` an int tensor (or int), the result fp32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = base_lr * (step + 1) / warmup
    prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def quantize_int8(g: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization; ``amax`` the tensor's
    largest magnitude when ``g`` is one block of it (default ``g``'s)."""
    if amax is None:
        amax = g.abs().max()
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clip(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads, ef):
    """int8 + error feedback: returns (quantized tree, scales, new
    residuals). The residuals carry the rounding error into the next
    step."""
    def one(g, e):
        gf = g.float() + e
        q, s = quantize_int8(gf)
        return q, s, gf - dequantize_int8(q, s)

    return _unzip(tree_map(one, grads, ef), 3)


def _unzip(tree, n: int):
    """n trees from one whose leaves are n-tuples."""
    return tuple(tree_map(lambda t: t[i], tree) for i in range(n))


def apply(params, grads, state: AdamWState, *, lr=None, b1=0.9, b2=0.95,
          eps=1e-8, weight_decay=0.1, clip=1.0, gnorm=None):
    """One AdamW update. Grads may be lower precision; math is fp32.
    ``gnorm`` is the global norm to clip by when ``grads`` are blocks of
    a gradient split across devices (default ``global_norm(grads)``).
    Returns (new params, new state, the global norm)."""
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(clip / (gnorm + 1e-9), 1.0)
    c1 = 1 - b1 ** step
    c2 = 1 - b2 ** step

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mh = m / c1
        vh = v / c2
        pf = p.float()
        new_p = pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)
        return new_p.to(p.dtype), m, v

    def upd_chunked(p, g, m, v):
        if p.dim() == 0 or p.numel() <= CHUNK:
            return upd(p, g, m, v)
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        rows = max(1, CHUNK // (p.numel() // p.shape[0]))
        for i in range(0, p.shape[0], rows):
            part = slice(i, i + rows)
            for o, x in zip(out, upd(p[part], g[part], m[part], v[part])):
                o[part] = x
        return out

    new_p, new_m, new_v = _unzip(
        tree_map(upd_chunked, params, grads, state.m, state.v), 3)
    return new_p, AdamWState(step, new_m, new_v, state.ef), gnorm
