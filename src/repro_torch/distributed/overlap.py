"""Static-BSP data-parallel trainer: manual, bucketed gradient reduction.

Port of ``repro.distributed.overlap``. The reference computes gradients
per data shard under ``shard_map`` with no auto-partitioning, then emits
one ``psum`` per fixed-size bucket in an order known before the run: the
paper's static-BSP discipline applied to the collectives. Here each data
shard runs eagerly on its own device (a device may repeat): every shard's
loss goes into one ``torch.autograd.backward``, then ``bucketed_mean``
reduces the gradients bucket by bucket, in bucket order, summing the
shards in order 0..D-1 on the first shard's device, dividing by D (the
reference's ``bucketed_psum`` and the division after it) and copying the
mean back to every shard. The order is fixed, so every shard gets the same
bits on every run, and the replicas stay bit-equal.

Data-parallel only (params replicated per shard); a ``model`` axis
larger than 1 runs ``distributed.tensor_parallel``, whose data-axis mean
is ``bucketed_mean`` per model block. Overlapping the reduction with the
backward is later work.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from .ctx import Mesh
from .sharding import tree_map

Tree = Any


def _path(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def _sorted_leaves(tree, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _sorted_leaves(tree[k], prefix + (k,))]
    return [(_path(prefix), tree)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def make_buckets(params: Tree, bucket_bytes: int = 32 << 20
                 ) -> List[List[str]]:
    """Greedy fixed-size bucketing of the gradient leaves, largest first
    (reduction order = reverse autodiff completion order), as leaf paths
    (``"layers/attn/wq"``). Leaves of one size keep the reference's leaf
    order (dict keys sorted), so the buckets equal its by path."""
    leaves = _sorted_leaves(params)
    order = sorted(range(len(leaves)), key=lambda i: -_nbytes(leaves[i][1]))
    buckets: List[List[str]] = []
    cur: List[str] = []
    cur_b = 0
    for i in order:
        b = _nbytes(leaves[i][1])
        if cur and cur_b + b > bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(leaves[i][0])
        cur_b += b
    if cur:
        buckets.append(cur)
    return buckets


def bucketed_mean(shard_grads: Sequence[Tree], buckets: List[List[str]]
                  ) -> List[Tree]:
    """The mean over the shards of their gradient trees, one tree a shard
    on that shard's device. Bucket by bucket, in bucket order: each
    shard's leaves of the bucket go into one contiguous buffer (one a
    dtype), the buffers are summed in shard order on shard 0's device and
    divided by the shard count there, and the mean is copied back to
    every shard, whose leaves are views of its copy."""
    flat = [dict(_sorted_leaves(g)) for g in shard_grads]
    out: List[Dict[str, torch.Tensor]] = [{} for _ in flat]
    root = flat[0][buckets[0][0]].device
    for bucket in buckets:
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for p in bucket:
            by_dtype.setdefault(flat[0][p].dtype, []).append(p)
        for paths in by_dtype.values():
            acc = torch.cat([flat[0][p].reshape(-1) for p in paths])
            for f in flat[1:]:
                acc.add_(torch.cat([f[p].reshape(-1) for p in paths]
                                   ).to(root))
            acc.div_(len(flat))
            sizes = [flat[0][p].numel() for p in paths]
            for s, f in enumerate(flat):
                buf = acc if s == 0 else acc.to(f[paths[0]].device,
                                                copy=True)
                for p, part in zip(paths, torch.split(buf, sizes)):
                    out[s][p] = part.view(f[p].shape)
    return [tree_map(lambda _, path: o[_path(path)], g)
            for g, o in zip(shard_grads, out)]


def dp_devices(mesh: Mesh, axis="data") -> List[torch.device]:
    """The devices of the shards along ``axis`` (a name or a tuple of
    names), row-major, each at index 0 of every other axis: with a
    ``model`` axis larger than 1, the device of each data shard's model
    shard 0 (``distributed.tensor_parallel`` runs the rest). Raises
    ``ValueError`` for a mesh with no devices."""
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} has no devices to run on")
    axes = axis if isinstance(axis, tuple) else (axis,)
    idx = tuple(slice(None) if a in axes else 0 for a in mesh.axis_names)
    return list(mesh.devices[idx].flat)


def split_batch(batch: Dict[str, torch.Tensor], devices
                ) -> List[Dict[str, torch.Tensor]]:
    """Each device's rows of every input, input by input as the
    reference's divisibility guard places them: split along dim 0 in order
    where the shard count divides the input's batch, else the whole input
    on every device (the data axis dropped: each shard computes the whole
    batch; ``replicated`` says when). Raises ``ValueError`` when the inputs
    disagree in their batch."""
    sizes = {k: v.shape[0] for k, v in batch.items()}
    if len(set(sizes.values())) > 1:
        raise ValueError(f"the inputs disagree in their batch: {sizes}")
    D = len(devices)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in devices]
    for k, v in batch.items():
        whole, b = replicated(v.shape[0], D), v.shape[0] // D
        for d, dev in enumerate(devices):
            out[d][k] = (v if whole else v[d * b:(d + 1) * b]).to(dev)
    return out


def replicated(B: int, D: int) -> bool:
    """Whether ``split_batch`` hands each of ``D`` shards the whole batch
    of ``B`` rows (D > 1 and D does not divide B): the shards' results are
    then copies of one another, and a caller keeps shard 0's."""
    return D > 1 and B % D != 0


def gather_rows(parts: Sequence[torch.Tensor], B: int, device
                ) -> torch.Tensor:
    """A batch of ``B`` rows on ``device`` from each shard's result along
    dim 0: the shards' rows in order, or shard 0's where the batch was
    replicated (``replicated``)."""
    if replicated(B, len(parts)):
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def pmean(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of one value a shard, summed in shard order on shard 0's
    device, as ``psum`` then a division."""
    acc = values[0].detach()
    for v in values[1:]:
        acc = acc + v.detach().to(acc.device)
    return acc / len(values)


def _grad(leaf: torch.Tensor, path) -> torch.Tensor:
    if leaf.grad is None:
        raise RuntimeError(f"parameter leaf {_path(path)} got no gradient "
                           "from the loss")
    return leaf.grad


def make_manual_dp_step(loss_fn: Callable, optimizer_apply: Callable,
                        mesh: Mesh, axis="data",
                        bucket_bytes: int = 32 << 20):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)`` over
    the data shards of ``mesh`` along ``axis``. ``params`` and ``opt`` are
    replicated, one tree a shard (``sharding.replicate``); ``batch`` is
    split along B by ``split_batch``: where the shard count does not
    divide B, every shard gets the whole batch, its gradient is the
    full-batch gradient, and ``bucketed_mean``'s division by D gives that
    gradient back, as ``pmean`` gives back the loss. Each
    shard's ``loss_fn(params, batch) -> (loss, metrics)`` goes into one
    ``torch.autograd.backward`` over the D losses; the gradients are
    reduced by ``bucketed_mean``; then
    ``optimizer_apply(params, grads, opt) -> (params, opt, gnorm)`` runs
    on every replica. ``metrics`` holds every loss metric's mean over the
    shards (``pmean``; the reference's ``loss`` is its ``pmean`` and its
    other metrics shard 0's), ``loss``, and ``gnorm``. ``step.buckets``
    (the leaf paths a bucket, set at the first call) and
    ``step.devices`` say how it reduces."""
    axes = axis if isinstance(axis, tuple) else (axis,)
    wide = {a: n for a, n in mesh.shape.items() if a not in axes and n > 1}
    if wide:
        raise ValueError(
            f"axes {wide} besides the data axes {axes}: replicated params do "
            "not run on them; tensor_parallel.make_train_step does")
    devices = dp_devices(mesh, axis)
    D = len(devices)

    def step(params: Sequence[Tree], opt: Sequence[Any], batch: Dict):
        if len(params) != D or len(opt) != D:
            raise ValueError(f"{len(params)} params and {len(opt)} optimizer"
                             f" replicas for {D} data shards")
        if step.buckets is None:
            step.buckets = make_buckets(params[0], bucket_bytes)
        losses, metrics, leaves = [], [], []
        for p, part in zip(params, split_batch(batch, devices)):
            lv = tree_map(lambda t, _: t.detach().requires_grad_(), p)
            loss, m = loss_fn(lv, part)
            losses.append(loss)
            metrics.append(m)
            leaves.append(lv)
        torch.autograd.backward(losses)
        grads = bucketed_mean([tree_map(_grad, lv) for lv in leaves],
                              step.buckets)
        del leaves
        new = []
        for d in range(D):
            new.append(optimizer_apply(params[d], grads[d], opt[d]))
            grads[d] = None          # free each replica's copy once used
        out = {k: pmean([m[k] for m in metrics]) for k in metrics[0]}
        return ([n[0] for n in new], [n[1] for n in new],
                dict(out, loss=pmean(losses), gnorm=new[0][2]))

    step.buckets = None
    step.devices = devices
    return step
