"""Recurrent blocks: Mamba2 (SSD, for zamba2) and xLSTM (mLSTM/sLSTM).

Port of ``repro.models.ssm``: the same names, parameter leaves and
arithmetic on torch tensors. Each ``lax.scan`` over the sequence becomes a
Python loop over its steps, with the state in fp32. The reference has no
Pallas kernel here, so none is ported: the steps are plain PyTorch ops.

What differs from the reference:

* A state given to ``mamba2_fwd``, ``mlstm_fwd`` or ``slstm_fwd`` is left
  as it is; the scan copies it into a state of its own and returns views
  of that. The states are laid out so that a step is few kernels: Mamba2
  keeps ``h`` as [B,N,H,P], so ``y_t = C_t h_t`` is one ``bmm``; mLSTM
  keeps n as the last column of ``[C | n]``, updated by v's appended 1,
  so one product gives ``q.C`` and ``q.n``; sLSTM keeps ``(c, n)`` as one
  tensor, one ``addcmul`` a step. With grad disabled (the serve steps run
  under ``inference_mode``) Mamba2's and mLSTM's loops update their state
  in place, ``h.mul_(decay).addcmul_(b, x)`` and one contraction: three
  kernels a step, which read and write the state about three times
  rather than five. With grad enabled they run out of place, as autograd
  needs, in chunks of ``SCAN_CHUNK`` steps, each under
  ``torch.utils.checkpoint`` (non-reentrant) from its start state: the
  forward keeps one state a chunk (S / ``SCAN_CHUNK`` of them) and the
  chunk's outputs, and the backward recomputes one chunk's steps at a
  time, so a layer's backward holds one chunk's states, not S of them
  (the reference's scan is rematerialised by its layer's ``_remat``
  alone). The chunks nest inside the layer's own checkpoint
  (``models/transformer.py``); the last chunk takes what is left of S.
* ``tp_mamba2_fwd``, ``tp_mlstm_fwd`` and ``tp_slstm_fwd`` run a core
  over a data shard's model shards (the reference leaves that to GSPMD):
  each shard its heads or channels, with the same steps and scans.
* ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is
  (``F.softplus`` switches to ``x`` past a threshold of 20), computed in
  the dtype the reference computes it in: mLSTM's input gate in the
  model's dtype, then cast to fp32; sLSTM's and Mamba2's in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ModelConfig
from .layers import _dtype, dense_init, rmsnorm, rmsnorm_init

# sequence steps a checkpointed chunk of a scan runs under grad
SCAN_CHUNK = 128


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` in x's dtype."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _scan(steps, state, seqs):
    """``steps(state, *seqs) -> (state, ys)`` over the sequence axis (1) of
    ``seqs``. With grad disabled, in one call; with grad enabled, in
    chunks of ``SCAN_CHUNK`` steps, each under the non-reentrant
    ``checkpoint`` from the state the chunk before it returned, the ys
    joined along axis 1."""
    if not torch.is_grad_enabled():
        return steps(state, *seqs)
    S, ys = seqs[0].shape[1], []
    for i in range(0, S, SCAN_CHUNK):
        state, y = checkpoint(steps, state,
                              *(s[:, i:i + SCAN_CHUNK] for s in seqs),
                              use_reentrant=False)
        ys.append(y)
    return state, torch.cat(ys, 1)


# ---------------------------------------------------------------- mamba2 ----
def mamba2_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    d_in = 2 * d
    H = d_in // cfg.ssm_headdim
    N = cfg.ssm_state
    return {
        # fused input projection, split by mamba2_fwd as [z, x, B, C, dt]
        "in_proj": dense_init(gen, d, 2 * d_in + 2 * N + H, dt, device),
        "out_proj": dense_init(gen, d_in, d, dt, device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(d_in, dt, device),
    }


def _mamba2_steps(h, decay, Bm, xh, Cm):
    """The SSD recurrence over the steps of its inputs from h [B,N,H,P]
    fp32 (the scan's layout): decay [B,s,H], Bm/Cm [B,s,N], xh [B,s,H,P].
    Returns (h, y [B,s,H*P]); with grad disabled h is updated in place."""
    B, N, H, P = h.shape
    inplace = not torch.is_grad_enabled()
    steps = zip(decay[:, :, None, :, None].unbind(1),    # [B,1,H,1]
                Bm[:, :, :, None, None].unbind(1),       # [B,N,1,1]
                xh[:, :, None].unbind(1),                # [B,1,H,P]
                Cm[:, :, None, :].unbind(1))             # [B,1,N]
    ys = []
    for dc, b_t, x_t, c_t in steps:
        if inplace:
            h.mul_(dc).addcmul_(b_t, x_t)
        else:
            h = h * dc + b_t * x_t
        ys.append(torch.bmm(c_t, h.view(B, N, H * P)))   # [B,1,H*P]
    return h, torch.cat(ys, 1)


def _mamba2_scan(xh, Bm, Cm, dtv, A, h0):
    """Sequential SSD recurrence. xh: [B,S,H,P]; Bm/Cm: [B,S,N]; dtv:
    [B,S,H]; h0: [B,H,N,P] fp32 or None (zeros). Returns (the final state
    [B,H,N,P], a view of the scan's own; y [B,S,H,P]).

    The scan keeps the state as [B,N,H,P], so that y_t = C_t h_t is one
    ``bmm`` of [B,1,N] by [B,N,H*P]: a step is three kernels (decay,
    outer-product add, contraction), the first two in place with grad
    disabled; with grad enabled ``_scan`` runs it in checkpointed
    chunks."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    decay = torch.exp(-torch.exp(A)[None, None, :] * _softplus(dtv))
    h = torch.zeros((B, N, H, P), dtype=torch.float32, device=xh.device)
    if h0 is not None:
        h.copy_(h0.transpose(1, 2))
    h, y = _scan(_mamba2_steps, h, (decay, Bm, xh, Cm))
    return h.transpose(1, 2), y.view(B, S, H, P)


def mamba2_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (y, final_state [B,H,N,P] fp32)."""
    B, S, d = x.shape
    d_in = 2 * d
    P = cfg.ssm_headdim
    H = d_in // P
    N = cfg.ssm_state
    z, xr, Bm, Cm, dtv = torch.split(x @ p["in_proj"],
                                     [d_in, d_in, N, N, H], dim=-1)
    xh = xr.reshape(B, S, H, P).float()
    dtv = dtv.float() + p["dt_bias"]
    h, y = _mamba2_scan(xh, Bm.float(), Cm.float(), dtv, p["A_log"], state)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    return y @ p["out_proj"], h


# ----------------------------------------------------------------- xlstm ----
def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    return {
        "wq": dense_init(gen, d, d, dt, device),
        "wk": dense_init(gen, d, d, dt, device),
        "wv": dense_init(gen, d, d, dt, device),
        "wi": dense_init(gen, d, cfg.n_heads, dt, device),   # input gate
        "wf": dense_init(gen, d, cfg.n_heads, dt, device),   # forget gate
        "wo": dense_init(gen, d, d, dt, device),
        "norm": rmsnorm_init(d, dt, device),
    }


def _mlstm_steps(Cn, fg, ik, v1, q):
    """The mLSTM recurrence over the steps of its inputs from ``[C | n]``
    [B,H,dh,dh+1] fp32: fg [B,s,H], ik = i k [B,s,H,dh], v1 = [v | 1]
    [B,s,H,dh+1], q [B,s,H,dh]. Returns (Cn, q [C | n] [B,s,H,dh+1]);
    with grad disabled Cn is updated in place."""
    inplace = not torch.is_grad_enabled()
    steps = zip(fg[..., None, None].unbind(1),              # [B,H,1,1]
                ik[..., None].unbind(1),                    # [B,H,dh,1]
                v1[:, :, :, None].unbind(1),                # [B,H,1,dh+1]
                q.transpose(0, 1).contiguous()[:, :, :, None])  # [B,H,1,dh]
    outs = []
    for f_t, ik_t, v_t, q_t in steps:
        if inplace:
            Cn.mul_(f_t).addcmul_(ik_t, v_t)
        else:
            Cn = f_t * Cn + ik_t * v_t
        outs.append(torch.matmul(q_t, Cn))                  # [B,H,1,dh+1]
    return Cn, torch.stack(outs, 1)[:, :, :, 0]


def mlstm_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
    """Matrix-memory LSTM. state = (C [B,H,dh,dh], n [B,H,dh]), fp32."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    q = (x @ p["wq"]).reshape(B, S, H, dh).float()
    k = (x @ p["wk"]).reshape(B, S, H, dh).float() / math.sqrt(dh)
    v = (x @ p["wv"]).reshape(B, S, H, dh).float()
    # the input gate in x's dtype, as the reference computes it
    ig = torch.exp(-_softplus(-(x @ p["wi"]))).float()
    fg = torch.sigmoid((x @ p["wf"]).float())
    # C and n in one [B,H,dh,dh+1] state: n is C's last column, updated
    # by v's appended 1 (f n + i k 1), so q C gives q.C and q.n at once
    Cn = torch.zeros((B, H, dh, dh + 1), dtype=torch.float32,
                     device=x.device)
    if state is not None:
        Cn[..., :dh].copy_(state[0])
        Cn[..., dh].copy_(state[1])
    v1 = torch.cat([v, v.new_ones((B, S, H, 1))], -1)      # [B,S,H,dh+1]
    Cn, out = _scan(_mlstm_steps, Cn, (fg, ig[..., None] * k, v1, q))
    y = out[..., :dh] / out[..., dh:].abs().clamp_min(1.0)
    y = y.reshape(B, S, d).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["wo"], (Cn[..., :dh], Cn[..., dh])


def slstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    return {
        "wz": dense_init(gen, d, d, dt, device),
        "wi": dense_init(gen, d, d, dt, device),
        "wf": dense_init(gen, d, d, dt, device),
        "wo": dense_init(gen, d, d, dt, device),
        "proj": dense_init(gen, d, d, dt, device),
        "norm": rmsnorm_init(d, dt, device),
    }


def _slstm_steps(cn, fg, add):
    """The sLSTM recurrence over the steps of its inputs from ``(c, n)``
    [B,2,d] fp32, out of place, one kernel a step: (c, n) <- f (c, n) +
    (i z, i), fg [B,s,d], add [B,s,2,d]. Returns (cn, every step's
    [B,s,2,d])."""
    cns = []
    for f_t, a_t in zip(fg[:, :, None].unbind(1), add.unbind(1)):
        cn = torch.addcmul(a_t, cn, f_t)
        cns.append(cn)
    return cn, torch.stack(cns, 1)


def slstm_fwd(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              state: Optional[Tuple] = None) -> Tuple[torch.Tensor, Tuple]:
    """Scalar-memory LSTM. state = (c [B,d], n [B,d]), fp32; n starts at
    ones."""
    B, S, d = x.shape
    z = torch.tanh((x @ p["wz"]).float())
    ig = torch.exp(-_softplus(-(x @ p["wi"]).float()))
    fg = torch.sigmoid((x @ p["wf"]).float())
    og = torch.sigmoid((x @ p["wo"]).float())
    # c and n in one [B,2,d] state, out of place: one kernel a step
    # (c, n) <- f (c, n) + (i z, i), and every step's (c, n) is kept
    cn = torch.zeros((B, 2, d), dtype=torch.float32, device=x.device)
    if state is None:
        cn[:, 1] = 1.0
    else:
        cn[:, 0].copy_(state[0])
        cn[:, 1].copy_(state[1])
    add = torch.stack([ig * z, ig], 2)                      # [B,S,2,d]
    cn, cns = _scan(_slstm_steps, cn, (fg, add))            # [B,S,2,d]
    y = (og * cns[:, :, 0] / cns[:, :, 1].clamp_min(1.0)).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y @ p["proj"], (cn[:, 0], cn[:, 1])


# ------------------------------------------------------ tensor parallel ----
# The cores over a data shard's model shards, as ``layers.py``'s
# tensor-parallel section lays them out: ``ps`` each shard's blocks of a
# core's parameters, ``hs`` each shard's copy of the normed input,
# ``states`` each shard's block of the state (None: from zeros), ``tp``
# the group. Each shard runs its heads (Mamba2, mLSTM) or channels
# (sLSTM), ``own_heads``/the output projection's rows say which, with its
# slice of each leaf kept whole; the norm over every head joins the
# shards' sums of squares (``tp_rmsnorm``); the output projection, split
# by rows, gives partial sums. Each returns (outs, states, split).
def tp_mamba2_fwd(tp, ps, cfg: ModelConfig, hs, states=None):
    """``mamba2_fwd`` over the model shards. ``in_proj``'s fused ``[z | x
    | B | C | dt]`` columns are split in blocks that need not fall on a
    field or a head, so the product is gathered whole (where split) and
    each shard takes ``z``, ``x`` and ``dt`` of its heads and ``B`` and
    ``C`` whole; its scan runs those heads, its state ``[B, n, N, P]``
    is the cache's block of H."""
    B, S, d = hs[0].shape
    d_in, P, N = 2 * d, cfg.ssm_headdim, cfg.ssm_state
    H = d_in // P
    proj = [h @ p["in_proj"] for p, h in zip(ps, hs)]
    whole = proj if proj[0].shape[-1] == 2 * d_in + 2 * N + H else \
        tp.gather(proj)
    ys, zs, cols, out_states = [], [], [], []
    for m, (p, w) in enumerate(zip(ps, whole)):
        h0, h1 = L.own_heads(H, len(ps), m)
        lo, hi = L.block_cols(p["out_proj"].shape[0], d_in, m)
        z, xr, Bm, Cm, dtv = torch.split(w, [d_in, d_in, N, N, H], dim=-1)
        xh = xr[..., h0 * P:h1 * P].reshape(B, S, h1 - h0, P).float()
        dtv = dtv[..., h0:h1].float() + p["dt_bias"][h0:h1]
        st, y = _mamba2_scan(xh, Bm.float(), Cm.float(), dtv,
                             p["A_log"][h0:h1],
                             None if states is None else states[m])
        y = y + xh * p["D"][h0:h1][None, None, :, None]
        y = y.reshape(B, S, -1).to(hs[0].dtype)
        ys.append(y[..., lo - h0 * P:hi - h0 * P])
        zs.append(z[..., lo:hi])
        cols.append((lo, hi))
        out_states.append(st)
    ys = L.tp_rmsnorm(tp, [p["norm"] for p in ps], ys, cols, d_in,
                      cfg.norm_eps)
    outs = [(y * F.silu(z)) @ p["out_proj"] for p, y, z in zip(ps, ys, zs)]
    return outs, out_states, ps[0]["out_proj"].shape[0] < d_in


def tp_mlstm_fwd(tp, ps, cfg: ModelConfig, hs, states=None):
    """``mlstm_fwd`` over the model shards: each shard's heads' q, k and v
    columns (gathered first where a block cuts a head), its heads'
    columns of the gates ``wi`` and ``wf`` (whole by the guard), its
    scan, the norm over every head, ``wo``'s rows."""
    B, S, d = hs[0].shape
    H = cfg.n_heads
    dh = d // H
    M = len(ps)
    heads = [L.own_heads(H, M, m) for m in range(M)]
    cols = [(h0 * dh, h1 * dh) for h0, h1 in heads]

    def take(name, full, ranges):
        return L.tp_columns(tp, [h @ p[name] for p, h in zip(ps, hs)],
                            full, ranges)

    qs, ks, vs = (take(n, d, cols) for n in ("wq", "wk", "wv"))
    wis, wfs = take("wi", H, heads), take("wf", H, heads)
    ys, out_states, ycols = [], [], []
    for m, (p, (h0, h1)) in enumerate(zip(ps, heads)):
        n = h1 - h0
        q = qs[m].reshape(B, S, n, dh).float()
        k = ks[m].reshape(B, S, n, dh).float() / math.sqrt(dh)
        v = vs[m].reshape(B, S, n, dh).float()
        ig = torch.exp(-_softplus(-wis[m])).float()
        fg = torch.sigmoid(wfs[m].float())
        Cn = torch.zeros((B, n, dh, dh + 1), dtype=torch.float32,
                         device=q.device)
        if states is not None:
            Cn[..., :dh].copy_(states[m][0])
            Cn[..., dh].copy_(states[m][1])
        v1 = torch.cat([v, v.new_ones((B, S, n, 1))], -1)
        Cn, out = _scan(_mlstm_steps, Cn, (fg, ig[..., None] * k, v1, q))
        y = out[..., :dh] / out[..., dh:].abs().clamp_min(1.0)
        y = y.reshape(B, S, n * dh).to(hs[0].dtype)
        lo, hi = L.block_cols(p["wo"].shape[0], d, m)
        ys.append(y[..., lo - h0 * dh:hi - h0 * dh])
        ycols.append((lo, hi))
        out_states.append((Cn[..., :dh], Cn[..., dh]))
    ys = L.tp_rmsnorm(tp, [p["norm"] for p in ps], ys, ycols, d,
                      cfg.norm_eps)
    return ([y @ p["wo"] for p, y in zip(ps, ys)], out_states,
            ps[0]["wo"].shape[0] < d)


def tp_slstm_fwd(tp, ps, cfg: ModelConfig, hs, states=None):
    """``slstm_fwd`` over the model shards, each on the channels its
    ``proj`` rows take (all of them where ``proj`` is whole): ``wz``,
    ``wi`` and ``wf`` columns (``wi``/``wf`` split only past 512 columns,
    else whole and cut), the output gate ``x @ wo`` from ``wo``'s rows as
    partial sums added across the shards before its sigmoid, the
    recurrence on the shard's channels (its block of the cache's ``(c,
    n)``), the norm over every channel, ``proj``'s rows."""
    B, S, d = hs[0].shape
    cols = [L.block_cols(p["proj"].shape[0], d, m) for m, p in enumerate(ps)]

    def take(name):
        return L.tp_columns(tp, [h @ p[name] for p, h in zip(ps, hs)], d,
                            cols)

    zs, wis, wfs = take("wz"), take("wi"), take("wf")
    og = []
    for m, (p, h) in enumerate(zip(ps, hs)):
        lo, hi = L.block_cols(p["wo"].shape[0], d, m)
        og.append(L._cols(h, lo, hi) @ p["wo"])
    og = tp.reduce(og, ps[0]["wo"].shape[0] < d)
    ys, out_states = [], []
    for m, (lo, hi) in enumerate(cols):
        z = torch.tanh(zs[m].float())
        ig = torch.exp(-_softplus(-wis[m].float()))
        fg = torch.sigmoid(wfs[m].float())
        o = torch.sigmoid(L._cols(og[m], lo, hi).float())
        cn = torch.zeros((B, 2, hi - lo), dtype=torch.float32,
                         device=z.device)
        if states is None:
            cn[:, 1] = 1.0
        else:
            cn[:, 0].copy_(states[m][0])
            cn[:, 1].copy_(states[m][1])
        cn, cns = _scan(_slstm_steps, cn, (fg, torch.stack([ig * z, ig], 2)))
        ys.append((o * cns[:, :, 0] / cns[:, :, 1].clamp_min(1.0)).to(
            hs[0].dtype))
        out_states.append((cn[:, 0], cn[:, 1]))
    ys = L.tp_rmsnorm(tp, [p["norm"] for p in ps], ys, cols, d, cfg.norm_eps)
    return ([y @ p["proj"] for p, y in zip(ps, ys)], out_states,
            ps[0]["proj"].shape[0] < d)
