"""Tensor parallelism over the ``model`` axis: the port's counterpart of
GSPMD partitioning at the reference's ``shard_act`` sites (the reference
has no file of its own for it).

On a mesh whose ``model`` axis is larger than 1, params and optimizer
state are trees of ``ShardedTensor`` placed by ``sharding.param_specs``
(the moments like the params, the step whole), as ``shard_tree`` and
``restore_tree(shardings=)`` give them. Each data shard's model shards run
in turn, each on its own device (a device may repeat): a ``Group`` holds
their devices and moves activations between them, and the model code's
``tp_*`` functions (``models/layers.py``, ``transformer.py``, ``moe.py``,
``model.py``) run each shard's blocks. A replicated activation is a list
of one copy a shard. Two collectives do what GSPMD inserts:

* ``Group.sum``: the partials of a row-parallel product summed in shard
  order on shard 0's device, then copied back to each shard, as
  ``overlap.bucketed_mean`` fixes its order;
* ``Group.gather``: a column-split activation joined on shard 0's device
  and copied back;
* ``Group.join``: each shard's partial softmax over its slots of a
  sequence-split K/V cache (``REPRO_KV_SHARD=seq``) rescaled by the
  global max and added on shard 0's device, divided, and copied back.

Both go through autograd (cross-device ``.to()`` and ``+``), so the
backward runs in a fixed order too, and results differ from one device's
only by rounding.

``make_train_step`` runs the train step: each data shard's loss over its
model shards, one backward over the data shards' losses, then the
gradients: a leaf whose spec leaves it whole on the model axis gets the
sum of every model shard's contribution in shard order (``sum_whole``),
so its model replicas stay bit-equal; then the data-axis mean runs per
model block, the same buckets over the data shards that hold that block
(``overlap.bucketed_mean``); the global norm adds each split leaf's
blocks once and each whole leaf once; AdamW runs on every block with that
norm. ``timed_collectives`` times the sums and gathers on the card.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim import adamw
from . import sharding as SH
from .ctx import Mesh
from .overlap import bucketed_mean, make_buckets, pmean, split_batch

Tree = Any

# (kind, start, end) CUDA events of each sum and gather while
# ``timed_collectives`` is open, else None
_EVENTS: Optional[List] = None


@contextlib.contextmanager
def timed_collectives():
    """Records a CUDA event pair around each ``Group.sum``,
    ``Group.gather`` and ``Group.join`` (on the current stream of shard
    0's card) while open; yields a dict that holds, once the block exits,
    the calls and ms of each kind (``{"sum": {"calls": n, "ms": t},
    "gather": ..., "join": ...}``)."""
    global _EVENTS
    prev, _EVENTS = _EVENTS, []
    out: Dict[str, Dict[str, float]] = {}
    try:
        yield out
    finally:
        events, _EVENTS = _EVENTS, prev
        if events:
            torch.cuda.synchronize()
        for kind, start, end in events:
            k = out.setdefault(kind, {"calls": 0, "ms": 0.0})
            k["calls"] += 1
            k["ms"] += start.elapsed_time(end)


@contextlib.contextmanager
def _timed(kind: str, device: torch.device):
    if _EVENTS is None or device.type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _EVENTS.append((kind, start, end))


class Group:
    """One data shard's model shards: their devices, in model order, and
    ``kv_slots``, the K/V ring's whole length where a serve step's cache
    splits its slots over these shards (``REPRO_KV_SHARD=seq``), else
    None."""

    def __init__(self, devices, kv_slots: Optional[int] = None):
        self.devices = [torch.device(d) for d in devices]
        self.kv_slots = kv_slots

    def __len__(self) -> int:
        return len(self.devices)

    def copy(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on every shard's device (``t`` itself where it lies)."""
        return [t.to(d) for d in self.devices]

    def total(self, parts) -> torch.Tensor:
        """The sum of one part a shard, in shard order, on shard 0's
        device."""
        root = self.devices[0]
        with _timed("sum", root):
            acc = parts[0].to(root)
            for p in parts[1:]:
                acc = acc + p.to(root)
        return acc

    def sum(self, parts) -> List[torch.Tensor]:
        """``total(parts)`` copied back to every shard."""
        return self.copy(self.total(parts))

    def reduce(self, parts, split: bool) -> List[torch.Tensor]:
        """``sum(parts)`` when they are partial sums (``split``), else the
        parts: each shard's whole result, with nothing to add."""
        return self.sum(parts) if split else list(parts)

    def gather(self, parts, dim: int = -1) -> List[torch.Tensor]:
        """The shards' blocks of a split activation joined along ``dim``
        in shard order on shard 0's device, and copied to every shard."""
        root = self.devices[0]
        with _timed("gather", root):
            whole = torch.cat([p.to(root) for p in parts], dim)
        return self.copy(whole)

    def join(self, parts) -> List[torch.Tensor]:
        """The softmax-weighted sum from one ``(mx, l, o)`` a shard, each
        over the shard's keys: ``mx`` the max score (-inf where the shard
        has no valid key), ``l`` the sum of ``exp(score - mx)`` and ``o``
        those weights' sum of values (fp32; ``mx`` and ``l`` broadcast
        against ``o``). On shard 0's device, in shard order: each part
        rescaled by ``exp(mx - max)`` (0 for a shard with no valid key),
        added, ``o`` divided by ``l``; copied to every shard."""
        root = self.devices[0]
        with _timed("join", root):
            mxs = torch.stack([p[0].to(root) for p in parts])
            top = mxs.amax(0)
            top = torch.where(torch.isfinite(top), top, 0.0)
            w = torch.exp(mxs - top)              # exp(-inf) = 0
            l = o = None
            for ws, (_, ls, os) in zip(w, parts):
                l = ws * ls.to(root) if l is None else l + ws * ls.to(root)
                o = ws * os.to(root) if o is None else o + ws * os.to(root)
            out = o / l
        return self.copy(out)


def model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def grid(mesh: Mesh) -> List[List[Tuple[int, ...]]]:
    """The mesh index of each (data shard, model shard): one row a data
    shard (``sharding.data_positions``), one entry a model index."""
    k = mesh.axis_names.index("model")
    rows = []
    for pos in SH.data_positions(mesh):
        row = []
        for m in range(mesh.shape["model"]):
            p = list(pos)
            p[k] = m
            row.append(tuple(p))
        rows.append(row)
    return rows


def groups(mesh: Mesh) -> List[Group]:
    """One ``Group`` a data shard, in ``grid`` order."""
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} has no devices to run on")
    return [Group([mesh.devices[p] for p in row]) for row in grid(mesh)]


def assemble(template: Tree, blocks: Dict[Tuple[int, ...], Tree]) -> Tree:
    """A tree of ``ShardedTensor`` placed as ``template``'s leaves are,
    whose block at each mesh index ``pos`` is ``blocks[pos]``'s leaf."""
    flat = {pos: _by_path(tree) for pos, tree in blocks.items()}

    def one(t: SH.ShardedTensor, path):
        arr = np.empty(t.blocks.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            arr[pos] = flat[pos][path]
        return SH.ShardedTensor(t.sharding, t.shape, t.dtype, arr)
    return SH.tree_map(one, template)


def split_on_model(t: SH.ShardedTensor) -> bool:
    """Whether a leaf's spec splits it on the ``model`` axis."""
    for e in t.sharding.spec:
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return True
    return False


def _by_path(tree) -> Dict[Tuple, Any]:
    out: Dict[Tuple, Any] = {}
    SH.tree_map(lambda leaf, path: out.__setitem__(path, leaf), tree)
    return out


def _per_shard(split: Tree, res: Dict[Tuple, List], n: int) -> List[Tree]:
    """n trees shaped like ``split``, tree m holding ``res[path][m]``."""
    return [SH.tree_map(lambda _, path, m=m: res[path][m], split)
            for m in range(n)]


def sum_whole(g: Group, grads: List[Tree], split: Tree) -> List[Tree]:
    """Each model shard's gradient tree with every leaf that is whole on
    the model axis (``split`` False) replaced by the sum of the shards'
    contributions, in shard order on shard 0's device, copied back to
    each shard (a shard whose part of the step did not reach the leaf
    adds nothing). A leaf no shard reached raises."""
    flat = [_by_path(t) for t in grads]
    res = {}
    for path, s in _by_path(split).items():
        parts = [f.get(path) for f in flat]
        got = [p for p in parts if p is not None]
        name = "/".join(str(k) for k in path)
        if not got or (s and len(got) < len(parts)):
            raise RuntimeError(f"parameter leaf {name} got no gradient "
                               "from the loss")
        res[path] = parts if s else g.copy(g.total(got))
    return _per_shard(split, res, len(g))


def global_norm(g: Group, grads: List[Tree], split: Tree) -> torch.Tensor:
    """The gradient's global norm on shard 0's device: each whole leaf's
    squares once (shard 0's), each split leaf's blocks summed in shard
    order."""
    flags = SH.tree_leaves(split)
    sq = []
    for m, tree in enumerate(grads):
        own = [x for x, s in zip(SH.tree_leaves(tree), flags) if s or m == 0]
        if own:
            sq.append(sum(x.float().square().sum() for x in own))
    return torch.sqrt(g.total(sq))


def _compress(g: Group, grads: List[Tree], efs: List[Tree], split: Tree):
    """``adamw.compress_grads`` over the model shards: a split leaf's int8
    scale is its whole gradient's (the max over its blocks). Returns (each
    shard's dequantized grads, each shard's new residuals)."""
    gf = [_by_path(SH.tree_map(lambda x, e, _: x.float() + e, gr, ef))
          for gr, ef in zip(grads, efs)]
    deq, res = {}, {}
    for path, s in _by_path(split).items():
        amax = [f[path].abs().max() for f in gf]
        if s:
            amax = g.copy(torch.stack([a.to(g.devices[0]) for a in amax]
                                      ).amax())
        deq[path], res[path] = [], []
        for f, a in zip(gf, amax):
            q, sc = adamw.quantize_int8(f[path], a)
            d = adamw.dequantize_int8(q, sc)
            deq[path].append(d)
            res[path].append(f[path] - d)
    return _per_shard(split, deq, len(g)), _per_shard(split, res, len(g))


def shard_grads(loss_fn: Callable, mesh: Mesh, params: Tree, batch: Dict):
    """Each data shard's loss over its model shards and one backward over
    all of them: returns (``split``, the tree of which leaves are split on
    ``model``; each data shard's loss and metrics; ``grads[d][m]``, model
    shard m's gradient blocks in data shard d, every whole leaf's the sum
    of the shards' contributions, ``sum_whole``). ``loss_fn``, ``params``
    and ``batch`` are ``make_train_step``'s."""
    split = SH.tree_map(lambda t, _: split_on_model(t), params)
    gs = groups(mesh)
    losses, metrics, leaves = [], [], []
    for g, row, part in zip(gs, grid(mesh), split_batch(
            batch, [g.devices[0] for g in gs])):
        lv = [SH.tree_map(lambda t, _, p=p: t.blocks[p].detach()
                          .requires_grad_(), params) for p in row]
        loss, m = loss_fn(g, lv, part)
        losses.append(loss)
        metrics.append(m)
        leaves.append(lv)
    torch.autograd.backward(losses)
    grads = [sum_whole(g, [SH.tree_map(lambda t, _: t.grad, lv)
                           for lv in lvs], split)
             for g, lvs in zip(gs, leaves)]
    return split, losses, metrics, grads


def make_train_step(loss_fn: Callable, mesh: Mesh,
                    compress_grads: bool = False,
                    bucket_bytes: int = 32 << 20):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)`` over
    ``mesh`` (``model`` axis > 1): ``params`` and ``opt`` trees of
    ``ShardedTensor`` placed by ``param_specs`` (the moments the same,
    ``opt.step`` whole), returned placed the same way; ``batch`` split
    along B over the data shards (``split_batch``; where they do not
    divide B, each data shard takes the whole batch, its gradient is the
    full-batch gradient, and ``bucketed_mean``'s division by the shard
    count gives it back, as ``pmean`` gives back the loss).
    ``loss_fn(group, blocks, batch) -> (loss, metrics)`` is
    ``Model.loss_tp``. ``metrics`` holds each loss
    metric's mean over the data shards, ``loss`` and ``gnorm``.
    ``step.groups`` are the data shards' groups; ``step.buckets`` (set at
    the first call) the data-axis mean's leaf paths a bucket."""
    rows = grid(mesh)
    gs = groups(mesh)
    D = len(gs)

    def step(params: Tree, opt: adamw.AdamWState, batch: Dict):
        split, losses, metrics, grads = shard_grads(loss_fn, mesh, params,
                                                    batch)
        if D > 1:
            if step.buckets is None:
                step.buckets = make_buckets(grads[0][0], bucket_bytes)
            for m in range(len(gs[0])):
                col = bucketed_mean([grads[d][m] for d in range(D)],
                                    step.buckets)
                for d in range(D):
                    grads[d][m] = col[d]
        blk = [[SH.blocks_at(opt, p) for p in row] for row in rows]
        if compress_grads and opt.ef is not None:
            for d, g in enumerate(gs):
                grads[d], efs = _compress(g, grads[d],
                                          [o.ef for o in blk[d]], split)
                blk[d] = [o._replace(ef=e) for o, e in zip(blk[d], efs)]
        gnorm = global_norm(gs[0], grads[0], split)
        new = {}
        for d, (g, row) in enumerate(zip(gs, rows)):
            for m, (p, dev) in enumerate(zip(row, g.devices)):
                new[p] = adamw.apply(SH.blocks_at(params, p), grads[d][m],
                                     blk[d][m], gnorm=gnorm.to(dev))[:2]
            grads[d] = None       # free each data shard's grads once used
        out = {k: pmean([m[k] for m in metrics]) for k in metrics[0]}
        return (assemble(params, {p: n[0] for p, n in new.items()}),
                assemble(opt, {p: n[1] for p, n in new.items()}),
                dict(out, loss=pmean(losses), gnorm=gnorm))

    step.buckets = None
    step.groups = gs
    return step
