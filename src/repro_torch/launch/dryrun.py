"""Dry run: plan every (arch x shape x mesh) cell on fake tensors.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles
each cell with XLA. Here each cell runs the port's own step
(``launch/steps.py`` ``make_train_step`` / ``make_serve_steps``) on meta
tensors (``MetaDevices``): the tensors have shapes, dtypes and devices
and no memory, so no card is needed, forward and backward, on either
machine. It shows that the shardings hold together
(the step runs to its end on the cell's mesh), what each device holds
(``memory``) and the roofline terms with their bottleneck
(``launch/hlo_analysis.py`` counts the ops), and writes one record a cell
to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The mesh's devices are ``meta:0`` .. ``meta:n-1``, one index a card, so
each device's memory and copies are kept apart. A fake ``cuda:i`` cannot
stand in for card i: Python indexing and ``torch.utils.checkpoint`` take
a device guard, which fails for an index past the cards present (and for
every CUDA index on a CPU-only build). The flash kernels are custom ops
with fake implementations; within a trace the wrappers take the mesh's
tensors for cards' (``on_cards``), so each calls its op, as on a card,
and counts the launch in ``COUNTS``.

Costs are extrapolated where a full trace would take too long:

* depth: the reference's two-point calibration (``_unit_scaled``), at 2
  and 3 units: cost(U) = cost(2) + (U - 2) (cost(3) - cost(2)), for
  FLOPs, bytes, collective bytes, launches and each device's memory (a
  1-unit model peaks elsewhere than a deeper one, so its peak is off the
  line the others lie on); a config of at most 3 units is traced whole,
  as every config is under ``--no-calibrate``;
* data rows: on a mesh of more than ``TRACE_DEVICES`` devices, 2 and 3
  rows of the data axes are traced, each with the full model axis and its
  rows of the batch (the whole batch where neither 2, 3 nor D rows divide
  it: ``split_batch`` replicates it); rows 1.. are identical by
  construction, and row 0 (whose shards sum the data-axis reductions,
  ``bucketed_mean``, ``pmean``, and take the whole batch) grows by the
  same amount for each further row, so row 0 at D rows is row 0 at 2 plus
  (D - 2) times the difference;
* the recurrent scans (``models/ssm.py``): a Python loop a step, too slow
  to trace at 32768 steps; a scan longer than 4 chunks is traced at 2, 3
  and 4 chunks (forward, and backward under grad) and its costs and
  memory fitted by a quadratic in its length (each chunk's slice sends
  its gradient back through a zero tensor of the whole length, so the
  backward's bytes are quadratic) and added at the scan's place, whose
  outputs are allocated at full length (``_planned_scan``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes --jobs 8
  python -m repro_torch.launch.dryrun --table      # the records as a table
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from fractions import Fraction
from pathlib import Path
from typing import Dict, Optional, Tuple
from unittest import mock

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS
from ..distributed import sharding as SH
from ..distributed.ctx import Mesh
from ..kernels import flash_attention as FA
from ..launch import hlo_analysis as HLO
from ..launch.mesh import make_production_mesh
from ..launch.shapes import SHAPES, Shape, cells
from ..launch.steps import make_serve_steps, make_train_step, train_specs
from ..models import ssm
from ..models.config import ModelConfig
from ..optim import adamw

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
# the most devices a trace runs; a larger mesh is traced 2 and 3 data rows
TRACE_DEVICES = 16
# torch.device keeps its index in 8 signed bits (meta:128 is meta:-128,
# meta:255 the index-less meta, meta:256 meta:0), so no trace takes more
MAX_TRACE_DEVICES = 128
GB = 1e9
CARD_BYTES = 80 * GB          # an H100's memory, as its name gives it


def model_flops(cfg: ModelConfig, shape: Shape) -> float:
    """6*N*D (train) / 2*N_active*D (inference) useful-FLOP accounting."""
    total, active = cfg.param_count()
    if shape.mode == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * active * tokens
    if shape.mode == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch     # decode: one token per seq


def _unit_scaled(cfg: ModelConfig, k: int):
    """A k-unit variant of cfg for the depth calibration, plus the number
    of units in the full config (exact, a ``Fraction``)."""
    if cfg.block == "mamba2":
        u = cfg.attn_every
        return cfg.scaled(n_layers=k * u), Fraction(cfg.n_layers, u)
    if cfg.block == "xlstm":
        u = cfg.slstm_every
        return cfg.scaled(n_layers=k * u), Fraction(cfg.n_layers, u)
    if cfg.enc_dec:
        return (cfg.scaled(n_layers=k, n_enc_layers=k),
                Fraction(cfg.n_layers))
    return cfg.scaled(n_layers=k), Fraction(cfg.n_layers)


# ------------------------------------------------------------ tracing ----
Counts = Dict[tuple, int]


class OnDevice(torch.Tensor):
    """A meta tensor that reports a device of its own (``meta:i``, one
    index a card, or the host): a trace's tensor under ``MetaDevices``.
    ``_elem`` is the plain meta tensor (whose storage aliasing follows
    the op that made it)."""

    @staticmethod
    def __new__(cls, elem: torch.Tensor, device: torch.device):
        t = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            layout=elem.layout, device=device)
        t._elem = elem
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on an OnDevice tensor outside "
                           "MetaDevices")

    def untyped_storage(self):
        return self._elem.untyped_storage()


class MetaDevices(TorchDispatchMode):
    """Runs each op on meta tensors and gives its outputs the device the
    op would put them on: a factory's ``device`` (the host without one),
    a copy's target, else its first ``OnDevice`` input's. A host tensor
    that meets an ``OnDevice`` one (a constant from numpy) is read as its
    meta stand-in; ops on host tensors alone run as they are. Generators
    are dropped: nothing is drawn. FakeTensorMode does the same for
    ``cuda`` fake devices, but a fake ``cuda:i`` needs card i, and it
    costs three times the time a trace takes here."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        ts = HLO.tensors((args, kwargs))
        wrapped = [t for t in ts if isinstance(t, OnDevice)]
        target = kwargs.get("device")
        if not wrapped and (ts or target is None and not _is_factory(func)):
            return func(*args, **kwargs)
        if target is not None:
            kwargs["device"] = torch.device("meta")
        if kwargs.get("generator") is not None:
            kwargs["generator"] = None
        dev = torch.device(target) if target is not None else (
            wrapped[0].device if wrapped else torch.device("cpu"))
        mine = {id(t._elem): t for t in wrapped}

        def unwrap(x):
            if isinstance(x, OnDevice):
                return x._elem
            if isinstance(x, torch.Tensor) and x.device.type != "meta" \
                    and x.dim() > 0:
                return torch.empty_strided(x.shape, x.stride(),
                                           dtype=x.dtype, device="meta")
            return x

        def wrap(x):
            if isinstance(x, torch.Tensor) and not isinstance(x, OnDevice) \
                    and x.device.type == "meta":
                own = mine.get(id(x))
                return OnDevice(x, dev) if own is None else own
            return x

        a = _map(unwrap, args)
        kw = {k: _map(unwrap, v) for k, v in kwargs.items()}
        out = _cached(func, a, kw)
        if not torch.is_inference_mode_enabled():
            return _map(wrap, out)
        # made as normal tensors: a view of one then shares its version
        # counter, as a view of a card's tensor would
        with torch._C._InferenceMode(False):
            return _map(wrap, out)


# (op, its arguments' shapes, strides and dtypes) -> its outputs' (a pure
# function of the key, so every trace in the process shares it)
_OUTPUTS: Dict = {}
_FRESH: Dict = {}


def _fresh(func) -> bool:
    """Whether ``func`` makes new tensors of its own and nothing else: no
    view, no input written, every output a tensor."""
    f = _FRESH.get(func)
    if f is None:
        sch = func._schema
        f = _FRESH[func] = (
            not func.is_view and not sch.is_mutable
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in sch.returns) and len(sch.returns) > 0)
    return f


def _key(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


def _cached(func, a, kw):
    """``func(*a, **kw)`` on meta tensors; an op that makes fresh tensors
    is run once a signature, and its outputs after that allocated from
    the shapes, strides and dtypes it gave (the meta kernels of many ops
    run in Python, and a trace repeats each signature once a shard and a
    layer)."""
    if not _fresh(func):
        return func(*a, **kw)
    try:
        key = (func, _key(a), _key(tuple(sorted(kw.items()))))
        spec = _OUTPUTS.get(key)
    except TypeError:                   # an argument that does not hash
        return func(*a, **kw)
    if spec is None:
        out = func(*a, **kw)
        one = isinstance(out, torch.Tensor)
        _OUTPUTS[key] = (one, [(t.shape, t.stride(), t.dtype)
                               for t in ([out] if one else out)])
        return out
    one, outs = spec
    made = [torch.empty_strided(sh, st, dtype=dt, device="meta")
            for sh, st, dt in outs]
    return made[0] if one else tuple(made)


def _map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)([_map(fn, v) for v in x])
    return fn(x)


def _is_factory(func) -> bool:
    return any(arg.name == "device" for arg in func._schema.arguments)


def _card(name: str, q: torch.Tensor) -> None:
    """``flash_attention._on_card`` within a trace: a tensor of the
    mesh stands in for a card's."""
    if not isinstance(q, OnDevice):
        raise ValueError(f"{name}: no kernel for {q.device}")


@contextlib.contextmanager
def on_cards():
    """``MetaDevices``, with the flash wrappers taking its tensors for
    cards': each calls its op (the op's fake runs) and counts a launch."""
    with MetaDevices(), mock.patch.object(FA, "_on_card", _card):
        yield


def _inputs(specs: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in specs.items()}


def _params(model, where, specs=None):
    """The model's parameters: on one device, replicated over a mesh's
    data shards (a ``model`` axis of 1) or drawn into their blocks."""
    g = torch.Generator()
    if not isinstance(where, Mesh):
        return model.init(g, where)
    if where.shape.get("model", 1) > 1:
        return SH.init_sharded(model, g, SH.to_named(where, specs))
    return SH.replicate(model.init(g, where.devices.flat[0]), where)


def _build(cfg: ModelConfig, mode: str, seq: int, batch: int, where,
           compress: bool):
    """(step, its arguments) of a cell on ``where`` (a device or a
    ``Mesh``), the arguments made as a user makes them."""
    first = where.devices.flat[0] if isinstance(where, Mesh) else where
    if mode == "train":
        model, step, p_shapes, opt_shapes = make_train_step(
            cfg, where, compress_grads=compress)
        if isinstance(where, Mesh):
            p_specs, o_specs = train_specs(cfg, where, p_shapes, compress)
        else:
            p_specs = o_specs = None
        params = _params(model, where, p_specs)
        if isinstance(where, Mesh) and where.shape.get("model", 1) > 1:
            opt = SH.zeros_tree(opt_shapes, SH.to_named(where, o_specs))
        elif isinstance(where, Mesh):
            opt = [adamw.init(p, compress) for p in params]
        else:
            opt = adamw.init(params, compress)
        data = _inputs(model.input_specs(seq, batch, "train"), first)
        return step, (params, opt, data)
    model, prefill, decode = make_serve_steps(cfg, where)
    p_specs = (SH.param_specs(cfg, where, model.abstract_params())
               if isinstance(where, Mesh) else None)
    params = _params(model, where, p_specs)
    cache = model.make_cache(batch, seq,
                             torch.device("meta") if isinstance(where, Mesh)
                             else where)
    if isinstance(where, Mesh):
        cache = SH.zeros_tree(cache, SH.to_named(
            where, SH.cache_specs(cfg, where, cache)))
    if mode == "prefill":
        data = _inputs(model.input_specs(seq, batch, "prefill"), first)
        return prefill, (params, data, cache)
    toks = _inputs(model.input_specs(seq, batch, "decode"), first)
    return decode, (params, toks["tokens"], cache, seq - 1)


def _storages_of(tree):
    """{id(storage): (device, nbytes)} of every tensor in ``tree`` (lists,
    dicts, NamedTuples, ``ShardedTensor`` blocks)."""
    found = {}

    def visit(x):
        if isinstance(x, torch.Tensor):
            st = getattr(x, "_elem", x).untyped_storage()
            found[id(st)] = (x.device, st.nbytes())
        elif isinstance(x, SH.ShardedTensor):
            for b in x.blocks.flat:
                visit(b)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
    visit(tree)
    return found


def trace(cfg: ModelConfig, mode: str, seq: int, batch: int,
          mesh_shape: Optional[Tuple[int, ...]] = None, axes=None,
          compress: bool = False, plan_scans: bool = True) -> Counts:
    """One traced step: its arguments made and the step run on fake
    tensors over a mesh of ``mesh_shape`` (None: one device, the
    one-device entry points). Returns the counts by key:
    ``("dev", i, name)`` for device i (flat mesh index; ``name`` one of
    flops, bytes_hbm, argument, output, peak, ``out:<link>``,
    ``in:<link>``), ``("coll_bytes", label)``, ``("coll_count", label)``
    and ``("launch", kernel)``. ``plan_scans=False`` runs every scan
    step by step."""
    n = int(np.prod(mesh_shape)) if mesh_shape else 1
    if n > MAX_TRACE_DEVICES:
        raise ValueError(f"a trace takes at most {MAX_TRACE_DEVICES} "
                         f"devices (torch's device index), not {n}")
    devices = [torch.device("meta", i) for i in range(n)]
    where = (Mesh(mesh_shape, axes, devices) if mesh_shape
             else devices[0])
    counter = HLO.OpCounter()
    index = {d: i for i, d in enumerate(devices)}
    scan = _planned_scan(counter, {}) if plan_scans else ssm._scan
    with on_cards(), counter, mock.patch.object(ssm, "_scan", scan):
        step, args = _build(cfg, mode, seq, batch, where, compress)
        gc.collect()
        counter.reset()
        before = counter.live_storages()
        argument = {d: s.live for d, s in counter.dev.items()}
        launches = dict(FA.COUNTS)
        out = step(*args)
        launches = {k: FA.COUNTS[k] - v for k, v in launches.items()}
        produced: Dict[torch.device, int] = {}
        for key, (d, nb) in _storages_of(out).items():
            if key not in before:
                produced[d] = produced.get(d, 0) + nb
        del out, args
    res: Counts = {}
    for d, s in counter.dev.items():
        if d not in index:
            continue           # the host's: an init's draws
        i = index[d]
        for name, v in (("flops", s.flops), ("bytes_hbm", s.bytes_hbm),
                        ("argument", argument.get(d, 0)),
                        ("output", produced.get(d, 0)), ("peak", s.peak)):
            res[("dev", i, name)] = v
        for k, v in s.link_out.items():
            res[("dev", i, "out:" + k)] = v
        for k, v in s.link_in.items():
            res[("dev", i, "in:" + k)] = v
    for k, v in counter.collectives.bytes_.items():
        res[("coll_bytes", k)] = v
        res[("coll_count", k)] = counter.collectives.counts[k]
    for k, v in launches.items():
        res[("launch", k)] = v
    return res


# -------------------------------------------------- the planned scans ----
def _fit(xs, ys, x):
    """The quadratic through (xs[i], ys[i]) at x, exact (Lagrange)."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        term = Fraction(yi)
        for j, xj in enumerate(xs):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return total


def _snapshot(s: HLO.DeviceStats):
    return (s.flops, s.bytes_hbm, s.live, s.peak)


def _planned_scan(counter: HLO.OpCounter, plans: Dict):
    """``ssm._scan`` for a trace: a scan of more than 4 chunks is measured
    at 2, 3 and 4 chunks of its inputs (``_measure``), and its costs at
    full length fitted and charged to its device; its outputs are
    allocated at full length, and under grad an autograd node gives its
    inputs gradients and charges the backward's costs. Shorter scans run
    as they are."""
    real = ssm._scan

    def scan(steps, state, seqs):
        S = seqs[0].shape[1]
        c = ssm.SCAN_CHUNK
        if S <= 4 * c:
            return real(steps, state, seqs)
        grad = torch.is_grad_enabled()
        key = (steps.__qualname__, tuple(state.shape), state.dtype, grad, S,
               tuple((s.shape[:1] + s.shape[2:], s.dtype, s.requires_grad)
                     for s in seqs), state.requires_grad)
        if key not in plans:
            plans[key] = _measure(counter, real, steps, state, seqs, S, c,
                                  grad)
        plan = plans[key]
        if grad:
            return _Scan.apply(counter, plan, state, *seqs)
        st = counter.dev[state.device]
        st.flops += plan["fwd_flops"]
        st.bytes_hbm += plan["fwd_bytes"]
        st.peak = max(st.peak, st.live + plan["fwd_peak"])
        new = state if plan["in_place"] else state.new_empty(state.shape)
        return new, seqs[0].new_empty(plan["ys_shape"],
                                      dtype=plan["ys_dtype"])

    return scan


def _measure(counter, real, steps, state, seqs, S, c, grad):
    """The scan's costs at ``S`` steps, from real runs over 2, 3 and 4
    chunks of ``c`` steps, forward (and backward under grad), with the
    counts they made taken back out."""
    st = counter.dev[state.device]
    lengths = (2 * c, 3 * c, 4 * c)
    rows = []
    for L in lengths:
        s0 = _snapshot(st)
        x0 = (state.detach().clone().requires_grad_(state.requires_grad)
              if grad else state.clone())
        xs = [s[:, :L].detach().requires_grad_(s.requires_grad)
              if grad else s[:, :L] for s in seqs]
        base = _snapshot(st)
        st.peak = st.live
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                      lambda t: t):
            new, ys = real(steps, x0, xs)
            fwd = _snapshot(st)
            m = {"fwd_flops": fwd[0] - base[0], "fwd_bytes": fwd[1] - base[1],
                 "fwd_keep": fwd[2] - base[2], "fwd_peak": fwd[3] - base[2],
                 "in_place": new is x0}
            shape, dtype = list(ys.shape), ys.dtype
            if grad:
                # the gradient of the outputs only: a loss drops the
                # final state
                gouts = torch.ones_like(ys)
                ins = [t for t in [x0] + xs if t.requires_grad]
                b0 = _snapshot(st)
                st.peak = st.live
                grads = torch.autograd.grad(ys, ins, gouts,
                                            allow_unused=True)
                b1 = _snapshot(st)
                m.update(bwd_flops=b1[0] - b0[0], bwd_bytes=b1[1] - b0[1],
                         bwd_peak=b1[3] - b0[2])
                del gouts, ins, grads
        del new, ys, x0, xs
        gc.collect()
        st.flops, st.bytes_hbm = s0[0], s0[1]
        st.peak = s0[3]
        rows.append(m)
    plan = {"ys_shape": shape[:1] + [S] + shape[2:], "ys_dtype": dtype,
            "in_place": rows[0]["in_place"]}
    out_bytes = math.prod(plan["ys_shape"]) * dtype.itemsize + (
        0 if plan["in_place"] else state.numel() * state.element_size())
    for k in rows[0]:
        if k != "in_place":
            plan[k] = int(_fit(lengths, [r[k] for r in rows], S))
    # bytes the forward leaves beside its outputs (for the backward)
    plan["saved"] = max(plan["fwd_keep"] - out_bytes, 0)
    return plan


class _Scan(torch.autograd.Function):
    """A planned scan under grad: outputs at full length, the bytes the
    real scan keeps for its backward held as one buffer, the costs charged
    to the device forward and backward."""

    @staticmethod
    def forward(ctx, counter, plan, state, *seqs):
        st = counter.dev[state.device]
        st.flops += plan["fwd_flops"]
        st.bytes_hbm += plan["fwd_bytes"]
        st.peak = max(st.peak, st.live + plan["fwd_peak"])
        ctx.counter, ctx.plan = counter, plan
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(state.new_empty(plan["saved"],
                                              dtype=torch.uint8))
        ctx.shapes = [(t.shape, t.dtype) for t in (state,) + seqs]
        return (state.new_empty(state.shape),
                seqs[0].new_empty(plan["ys_shape"], dtype=plan["ys_dtype"]))

    @staticmethod
    def backward(ctx, g_state, g_ys):
        keep, = ctx.saved_tensors
        st = ctx.counter.dev[keep.device]
        plan = ctx.plan
        st.flops += plan["bwd_flops"]
        st.bytes_hbm += plan["bwd_bytes"]
        st.peak = max(st.peak, st.live + plan["bwd_peak"])
        grads = [keep.new_empty(s, dtype=d) if need else None
                 for (s, d), need in zip(ctx.shapes,
                                         ctx.needs_input_grad[2:])]
        return (None, None, *grads)


# ------------------------------------------------------ extrapolation ----
def _affine(a: Counts, b: Counts, x) -> Dict[tuple, Fraction]:
    """a + x (b - a), key by key."""
    return {k: Fraction(a.get(k, 0)) + x * (b.get(k, 0) - a.get(k, 0))
            for k in set(a) | set(b)}


def _rows(t2: Counts, t3: Counts, D: int, M: int) -> Dict[tuple, Fraction]:
    """A trace of D data rows of M devices from traces of 2 and 3 rows:
    row 0 and every total by ``_affine`` at D - 2; rows 1..D-1 as row 1 of
    the 2-row trace."""
    lin = _affine(t2, t3, D - 2)
    out = {}
    for k, v in lin.items():
        if k[0] != "dev":
            out[k] = v
        elif k[1] < M:
            out[k] = v
    for k, v in t2.items():
        if k[0] == "dev" and M <= k[1] < 2 * M:
            for r in range(1, D):
                out[("dev", r * M + k[1] - M) + k[2:]] = Fraction(v)
    return out


def plan(cfg: ModelConfig, mode: str, seq: int, batch: int,
         mesh_shape: Optional[Tuple[int, ...]] = None, axes=None,
         compress: bool = False, calibrate: bool = True,
         trace_devices: int = TRACE_DEVICES) -> Dict:
    """The counts of a step at ``batch`` x ``seq`` on a mesh of
    ``mesh_shape`` (None: one device), extrapolated as the module says;
    returns ``{"counts", "units", "rows", "traces"}``."""
    n = int(np.prod(mesh_shape)) if mesh_shape else 1
    model_axis = mesh_shape[-1] if mesh_shape else 1
    D = n // model_axis
    split = batch % D == 0
    whole = all(batch % r for r in (2, 3, D))    # replicated on every row
    by_rows = n > trace_devices and D > 3 and (split or whole)
    if by_rows:
        rows = (2, 3)
        shapes = [tuple(1 for _ in mesh_shape[:-2]) + (r, model_axis)
                  for r in rows]
        batches = [batch // D * r if split else batch for r in rows]
    else:
        shapes, batches = [mesh_shape], [batch]

    def at(c):
        ts = [trace(c, mode, seq, b, s, axes, compress)
              for s, b in zip(shapes, batches)]
        return _rows(ts[0], ts[1], D, model_axis) if by_rows else ts[0]

    units = _unit_scaled(cfg, 1)[1]
    calibrate = calibrate and units > 3
    if calibrate:
        counts = _affine(at(_unit_scaled(cfg, 2)[0]),
                         at(_unit_scaled(cfg, 3)[0]), units - 2)
    else:
        counts = {k: Fraction(v) for k, v in at(cfg).items()}
    return {"counts": counts, "units": units if calibrate else None,
            "rows": [s[-2] for s in shapes] if by_rows else None,
            "traces": len(shapes) * (2 if calibrate else 1)}


def _num(x):
    x = Fraction(x)
    return int(x) if x.denominator == 1 else float(x)


def per_device(counts: Dict) -> Dict[int, Dict[str, float]]:
    """{device index: {name: value}} from plan counts."""
    out: Dict[int, Dict[str, float]] = {}
    for k, v in counts.items():
        if k[0] == "dev":
            out.setdefault(k[1], {})[k[2]] = _num(v)
    return out


def roofline(counts: Dict, n_chips: int, mf: float) -> HLO.Roofline:
    devs = per_device(counts)
    t_link = 0.0
    sent = 0
    for d in devs.values():
        s = HLO.DeviceStats()
        for name, v in d.items():
            if name.startswith("out:"):
                s.link_out[name[4:]] = v
                sent += v
            elif name.startswith("in:"):
                s.link_in[name[3:]] = v
        t_link = max(t_link, s.t_link)
    coll = HLO.CollectiveStats(
        counts={k[1]: _num(v) for k, v in counts.items()
                if k[0] == "coll_count"},
        bytes_={k[1]: _num(v) for k, v in counts.items()
                if k[0] == "coll_bytes"})
    return HLO.Roofline(
        flops=float(sum(d.get("flops", 0) for d in devs.values())),
        bytes_hbm=float(sum(d.get("bytes_hbm", 0) for d in devs.values())),
        bytes_collective=float(sent), n_chips=n_chips, model_flops=mf,
        collectives=coll, t_link=t_link)


def memory(counts: Dict) -> Dict:
    """The memory record of the device with the largest peak."""
    devs = per_device(counts)
    i = max(devs, key=lambda j: (devs[j].get("peak", 0), -j))
    d = devs[i]
    return {"argument_bytes": d.get("argument", 0),
            "output_bytes": d.get("output", 0),
            "temp_bytes": d.get("peak", 0) - d.get("argument", 0),
            "peak_bytes": d.get("peak", 0), "device": i,
            "peak_bytes_least": min(v.get("peak", 0)
                                    for v in devs.values())}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             compress: bool = False, calibrate: bool = True) -> dict:
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.time()
    p = plan(cfg, shape.mode, shape.seq_len, shape.global_batch,
             tuple(mesh.shape.values()), mesh.axis_names, compress,
             calibrate)
    t_trace = time.time() - t0
    counts = p["counts"]
    mf = model_flops(cfg, shape)
    roof = roofline(counts, n_chips, mf)
    mem = memory(counts)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "mode": shape.mode,
        "t_trace_s": round(t_trace, 1),
        "memory": mem,
        "fits": mem["peak_bytes"] <= CARD_BYTES,
        "roofline": roof.as_dict(),
        "roofline_raw_per_device": {
            "flops": roof.flops / n_chips,
            "bytes_hbm": roof.bytes_hbm / n_chips,
            "bytes_collective": roof.bytes_collective / n_chips},
        "launches": {k[1]: _num(v) for k, v in counts.items()
                     if k[0] == "launch"},
        "calibration": {"units": float(p["units"]) if p["units"] else None,
                        "rows_traced": p["rows"],
                        "traces": p["traces"]},
        "status": "ok",
    }


def _one(job) -> Tuple[str, dict]:
    arch, shape, mp, compress, calibrate = job
    mesh_tag = "2x16x16" if mp else "16x16"
    try:
        rec = run_cell(arch, shape, mp, compress, calibrate)
        r = rec["roofline"]
        line = (f"[OK] {arch:18s} {shape:12s} {mesh_tag:8s} "
                f"trace={rec['t_trace_s']:.0f}s "
                f"peak={rec['memory']['peak_bytes'] / GB:.1f}GB "
                f"bottleneck={r['bottleneck']:10s} "
                f"tc={r['t_compute']:.3e} tm={r['t_memory']:.3e} "
                f"tx={r['t_collective']:.3e}")
    except Exception as e:  # noqa: BLE001 -- a failed cell is a record
        rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        line = (f"[FAIL] {arch} {shape} {mesh_tag}: "
                f"{type(e).__name__}: {str(e)[:200]}")
    return line, rec


def table(out_dir: Path) -> str:
    """The records in ``out_dir`` as a markdown table, one row a cell,
    the 16x16 and 2x16x16 meshes side by side in each column, then each
    failed cell's error."""
    recs: Dict[Tuple[str, str], Dict[str, dict]] = {}
    for f in sorted(out_dir.glob("*.json")):
        r = json.loads(f.read_text())
        recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def col(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "-"
                          for m in ("16x16", "2x16x16"))

    def ok(fn):
        return lambda r: fn(r) if r["status"] == "ok" else "fail"

    rows = ["| arch | shape | status | peak GB a card (of 80) | t_compute s "
            "| t_memory s | t_collective s | bottleneck | roofline_fraction "
            "| trace s |", "|---" * 10 + "|"]
    for arch, s in cells():
        c = recs.get((arch, s.name), {})
        rows.append("| " + " | ".join([
            arch, s.name,
            col(c, lambda r: r["status"]),
            col(c, ok(lambda r: f"{r['memory']['peak_bytes'] / GB:.1f}")),
            col(c, ok(lambda r: f"{r['roofline']['t_compute']:.3g}")),
            col(c, ok(lambda r: f"{r['roofline']['t_memory']:.3g}")),
            col(c, ok(lambda r: f"{r['roofline']['t_collective']:.3g}")),
            col(c, ok(lambda r: r["roofline"]["bottleneck"])),
            col(c, ok(lambda r: f"{r['roofline']['roofline_fraction']:.2g}")),
            col(c, ok(lambda r: f"{r['t_trace_s']:.0f}"))]) + " |")
    errors = [f"- {r['arch']} {r['shape']} {r['mesh']}: {r['error']}"
              for c in recs.values() for r in c.values()
              if r["status"] != "ok"]
    return "\n".join(rows + ([""] + errors if errors else []))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    if args.table:
        print(table(out_dir))
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        todo = [(a, s.name) for a, s in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(a, s, mp, args.compress_grads, not args.no_calibrate)
            for a, s in todo for mp in meshes]

    failures = 0
    pool = (ProcessPoolExecutor(args.jobs,
                                multiprocessing.get_context("spawn"))
            if args.jobs > 1 else contextlib.nullcontext())
    with pool:
        results = pool.map(_one, jobs) if args.jobs > 1 else map(_one, jobs)
        for (arch, shape, mp, *_), (line, rec) in zip(jobs, results):
            print(line, flush=True)
            failures += rec["status"] != "ok"
            mesh_tag = "2x16x16" if mp else "16x16"
            (out_dir / f"{arch}__{shape}__{mesh_tag}{args.tag}.json"
             ).write_text(json.dumps(rec, indent=1))
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
