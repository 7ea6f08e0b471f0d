"""Parameter / input / cache sharding rules, and placement on a mesh.

Port of ``repro.distributed.sharding``. Baseline scheme: tensor
parallelism on the ``model`` axis (megatron column->row for MLPs and
attention heads; vocab-sharded embeddings; expert- or ffn-parallel MoE),
batch on ``pod`` x ``data``. Rules are *name + trailing-shape* driven over
the parameter tree (the port's nested dicts, name for name the
reference's pytree), with a divisibility guard: an axis only shards when
the dimension divides evenly, so one rule set serves every architecture
and mesh. A spec is a ``P``: one entry a dimension, an axis name, a tuple
of names or None.

What jax's ``device_put`` does for the reference is here too:
``shard_tree`` gives each device of the mesh its block of each leaf (a
``ShardedTensor``), ``gather_tree`` joins the blocks back, ``data_shards``
takes the blocks one data shard holds, and ``replicate`` puts a whole
tree on every data shard. ``init_sharded`` gives what ``shard_tree(
model.init(generator), shardings)`` gives, bit for bit, without any
device holding a whole stacked leaf: each layer goes into its blocks as
it is drawn. It is the reference's ``device_put(model.init(key),
shardings)`` (``repro.launch.train``) for a model that no one card
holds; ``zeros_tree`` gives the optimizer's zero moments block by block.
The steps run over the data axes with replicated params where the
``model`` axis is 1, and tensor-parallel on the blocks these rules place
where it is larger (``launch/steps.py``,
``distributed/tensor_parallel.py``).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from .ctx import Mesh

Params = Any


class P:
    """A partition spec: one entry a leading dimension (an axis name, a
    tuple of axis names or None); dimensions past its length are
    replicated. A tuple of one name is that name, as in the reference's
    ``PartitionSpec``, and ``tuple(spec)`` gives the entries as its
    ``tuple()`` does. Not a tuple, so that the tree helpers take it as a
    leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


# ------------------------------------------------------------ trees ----
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest, path: Tuple = ()):
    """``fn(leaf, *rest_leaves, path)`` over nested dicts, NamedTuples,
    lists and tuples (``None`` holds no leaf); ``path`` is the tuple of
    dict keys and field names down to the leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                     path=path + (f,))
            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(tree, *rest, path)


def tree_leaves(tree) -> List:
    out: List = []
    tree_map(lambda leaf, _: out.append(leaf), tree)
    return out


# ------------------------------------------------------------ rules ----
def _axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def _guard(mesh: Mesh, shape, spec) -> P:
    """Drop shard axes that do not divide the dimension."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None or dim % _axis_size(mesh, ax) != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


# trailing-dims rules, matched by parameter name (innermost dict key)
_COL = (None, "model")     # shard outputs  (column parallel)
_ROW = ("model", None)     # shard inputs   (row parallel)

_NAME_RULES: Dict[str, Tuple] = {
    "wq": _COL, "wk": _COL, "wv": _COL, "wg": _COL, "wz": _COL,
    "in_proj": _COL,
    "wo": _ROW, "out_proj": _ROW, "proj": _ROW,
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "tok": ("model", None),     # vocab-sharded embedding
    "out": (None, "model"),     # vocab-sharded unembedding
}


def spec_for(cfg: ModelConfig, mesh: Mesh, path: Tuple[str, ...],
             leaf) -> P:
    name = path[-1]
    shape = tuple(leaf.shape)
    in_moe = "moe" in path and "shared" not in path
    if in_moe:
        if name == "router":
            return P()
        m = _axis_size(mesh, "model")
        ep = cfg.n_experts % m == 0
        # leading stack dims (layers) -> None
        lead = (None,) * (len(shape) - 3)
        if name in ("wi", "wg"):
            rule = ("model", None, None) if ep else (None, None, "model")
        elif name == "wo":
            rule = ("model", None, None) if ep else (None, "model", None)
        else:
            return P()
        return _guard(mesh, shape, lead + rule)
    # xLSTM gate exceptions: tiny trailing dims stay replicated via guard
    rule = _NAME_RULES.get(name)
    if name == "wi" and len(shape) >= 2 and shape[-1] >= 512:
        rule = _COL                       # MLP wi (large) vs mLSTM gate wi
    elif name == "wi":
        rule = None
    if name == "wf":
        rule = _COL if shape[-1] >= 512 else None
    if rule is None:
        return P()
    lead = (None,) * (len(shape) - len(rule))
    return _guard(mesh, shape, lead + tuple(rule))


def param_specs(cfg: ModelConfig, mesh: Mesh, params_shape: Params):
    """A ``P`` tree matching ``params_shape`` (tensors, meta ones from
    ``Model.abstract_params`` included)."""
    return tree_map(lambda leaf, path: spec_for(cfg, mesh, path, leaf),
                    params_shape)


def batch_spec(mesh: Mesh) -> Tuple:
    if "pod" in mesh.axis_names:
        return ("pod", "data")
    return ("data",)


def input_specs_sharding(cfg: ModelConfig, mesh: Mesh, specs: Dict
                         ) -> Dict[str, "Sharding"]:
    """Shardings for the model input dict (batch on pod x data); ``specs``
    as ``Model.input_specs`` gives them, ``{name: (shape, dtype)}``."""
    b = batch_spec(mesh)
    out = {}
    for k, (shape, _) in specs.items():
        spec = (b,) + (None,) * (len(shape) - 1)
        out[k] = Sharding(mesh, _guard(mesh, shape, spec))
    return out


def cache_specs(cfg: ModelConfig, mesh: Mesh, cache_shape) -> Any:
    """Decode-state sharding: batch on data axes, kv-heads/heads on model
    when divisible (the guard demotes otherwise). ``REPRO_KV_SHARD=seq``
    puts the K/V caches' sequence on the model axis instead of their
    heads, as the reference's does."""
    b = batch_spec(mesh)

    def one(leaf, path):
        shape = tuple(leaf.shape)
        name = path[-1]
        if name == "enc_out":
            return _guard(mesh, shape, (b, None, "model"))
        if name in ("k", "v"):        # [L, B, T, Hkv, dh]
            if os.environ.get("REPRO_KV_SHARD") == "seq":
                return _guard(mesh, shape, (None, b, "model", None, None))
            return _guard(mesh, shape, (None, b, None, "model", None))
        if name in ("ak", "av"):      # [n_super, B, T, Hkv, dh]
            return _guard(mesh, shape, (None, b, None, "model", None))
        if name == "ssm":             # [n_super, inner, B, H, N, P]
            return _guard(mesh, shape, (None, None, b, "model", None, None))
        if name == "tail_ssm":
            return _guard(mesh, shape, (None, b, "model", None, None))
        if name in ("mC", "mn"):      # [ns, inner, B, H, ...]
            return _guard(mesh, shape,
                          (None, None, b, "model") + (None,) * (len(shape) - 4))
        if name in ("sc", "sn"):      # [ns, B, d]
            return _guard(mesh, shape, (None, b, "model"))
        return P()

    return tree_map(one, cache_shape)


def to_named(mesh: Mesh, spec_tree):
    return tree_map(lambda s, _: Sharding(mesh, s), spec_tree)


# -------------------------------------------------------- placement ----
class Sharding:
    """A spec on a mesh: where each device's block of a leaf lies."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.spec!r})"

    def block(self, shape, pos) -> Tuple[slice, ...]:
        """The slices of a leaf of ``shape`` that the device at mesh
        index ``pos`` holds. A dimension split over axes (a, b) is cut
        into size(a) x size(b) blocks, row-major over the axes."""
        mesh = self.mesh
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"leaf of shape {tuple(shape)}")
        entries = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, ax in zip(shape, entries):
            if ax is None:
                out.append(slice(None))
                continue
            n, i = 1, 0
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec}: no axis {a!r} in "
                                     f"{mesh!r}")
                k = mesh.axis_names.index(a)
                i, n = i * mesh.shape[a] + pos[k], n * mesh.shape[a]
            if dim % n:
                raise ValueError(f"spec {self.spec}: {n} shards do not "
                                 f"divide a dimension of {dim}")
            out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
        return tuple(out)


class ShardedTensor:
    """A leaf on a mesh: ``blocks[pos]`` is the block (a tensor of its
    own, not a view) that the device at mesh index ``pos`` holds."""

    def __init__(self, sharding: Sharding, shape, dtype, blocks: np.ndarray):
        self.sharding, self.blocks = sharding, blocks
        self.shape, self.dtype = torch.Size(shape), dtype

    def __repr__(self) -> str:
        return (f"ShardedTensor({self.dtype}{list(self.shape)}, "
                f"{self.sharding.spec!r})")

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (None: the first block's), each
        block copied from the first device that holds it."""
        first = self.blocks.flat[0]
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=first.device if device is None else device)
        seen = set()
        for pos in np.ndindex(self.blocks.shape):
            sl = self.sharding.block(self.shape, pos)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:
                seen.add(key)
                out[sl].copy_(self.blocks[pos])
        return out


def _blocks(sharding: Sharding, shape, dtype, make=torch.empty
            ) -> ShardedTensor:
    """A leaf of ``shape`` on ``sharding``, each block ``make``-d on its
    device (``torch.empty``: not yet written)."""
    mesh = sharding.mesh
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} has no devices to place a leaf on")
    meta = torch.empty(shape, dtype=dtype, device="meta")
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(mesh.devices.shape):
        blocks[pos] = make(meta[sharding.block(shape, pos)].shape,
                           dtype=dtype, device=mesh.devices[pos])
    return ShardedTensor(sharding, shape, dtype, blocks)


def _write_row(t: ShardedTensor, row: torch.Tensor, i: int) -> None:
    """Row ``i`` of a stacked leaf (``row`` whole, one layer) into the
    blocks that hold it."""
    for pos in np.ndindex(t.blocks.shape):
        sl = t.sharding.block(t.shape, pos)
        lo, hi, _ = sl[0].indices(t.shape[0])
        if lo <= i < hi:
            t.blocks[pos][i - lo].copy_(row[sl[1:]])


class _Blocks:
    """Where ``init_sharded`` puts what an init draws (the calls of
    ``models.layers.Whole``): each leaf into its blocks on the
    ``Sharding`` of ``shardings`` (the subtree's) at the same path."""

    def __init__(self, shardings):
        self.shardings = shardings

    def at(self, key) -> "_Blocks":
        return _Blocks(self.shardings[key])

    def put(self, tree):
        return shard_tree(tree, self.shardings)

    def stack(self, layer, n: int):
        return tree_map(lambda t, s, _: _blocks(
            s, (n,) + tuple(t.shape), t.dtype), layer, self.shardings)

    def write(self, out, layer, i: int) -> None:
        tree_map(lambda o, t, _: _write_row(o, t, i), out, layer)


def init_sharded(model, generator: torch.Generator, shardings):
    """``shard_tree(model.init(generator), shardings)``, bit for bit, drawn
    straight into the blocks: the same draws in the same order on the
    generator's device, each layer of a stack written into the blocks it
    lands in as it is drawn, each leaf outside a stack (the embedding, the
    head, the norms, zamba2's shared attention) placed as it is drawn and
    then freed. No device holds more than its own blocks beside one drawn
    layer (one group of a nested stack) or one such leaf. ``shardings``:
    a tree of ``Sharding`` (``to_named(mesh, param_specs(...))``)."""
    return model.init(generator, generator.device, into=_Blocks(shardings))


def zeros_tree(shapes, shardings):
    """A tree of ``ShardedTensor`` of zeros shaped like ``shapes`` (meta
    tensors, ``make_train_step``'s ``opt_shapes``), on ``shardings``,
    each block made on its device: ``shard_tree`` of the same zeros with
    no leaf whole anywhere (the optimizer's moments of a model from
    ``init_sharded``)."""
    return tree_map(lambda t, s, _: _blocks(s, t.shape, t.dtype,
                                            torch.zeros), shapes, shardings)


def _place(t, sharding: Sharding) -> ShardedTensor:
    mesh = sharding.mesh
    if mesh.devices is None:
        raise ValueError(f"{mesh!r} has no devices to place a leaf on")
    if isinstance(t, ShardedTensor):
        t = t.gather()
    t = torch.as_tensor(t)
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos in np.ndindex(mesh.devices.shape):
        part = t[sharding.block(t.shape, pos)]
        blocks[pos] = torch.empty(part.shape, dtype=t.dtype,
                                  device=mesh.devices[pos]).copy_(part)
    return ShardedTensor(sharding, t.shape, t.dtype, blocks)


def shard_tree(tree, shardings):
    """Each leaf of ``tree`` (a tensor, or a ``ShardedTensor`` on any
    mesh, gathered first) as a ``ShardedTensor`` on its ``Sharding``."""
    return tree_map(lambda t, s, _: _place(t, s), tree, shardings)


def gather_tree(tree):
    """The whole leaves of a tree of ``ShardedTensor``, each on its first
    block's device; other leaves as they are."""
    return tree_map(lambda t, _: t.gather()
                    if isinstance(t, ShardedTensor) else t, tree)


def data_positions(mesh: Mesh) -> List[Tuple[int, ...]]:
    """The mesh index of each data shard, row-major over the batch axes
    (``pod`` x ``data``), at index 0 of every other axis."""
    axes = batch_spec(mesh)
    sizes = [mesh.shape[a] if a in axes else 1 for a in mesh.axis_names]
    return list(np.ndindex(*sizes))


def blocks_at(tree, pos):
    """The blocks of a tree of ``ShardedTensor`` that the device at mesh
    index ``pos`` holds: the tensors themselves, so a step that updates
    one in place updates the sharded leaf."""
    return tree_map(lambda t, _: t.blocks[pos], tree)


def data_shards(tree, mesh: Mesh) -> List:
    """One tree of blocks a data shard (``data_positions``)."""
    return [blocks_at(tree, pos) for pos in data_positions(mesh)]


def replicate(tree, mesh: Mesh) -> List:
    """A copy of ``tree`` on every data shard of ``mesh``, one tree a
    shard: the params and optimizer state of a data-parallel step."""
    whole = tree_map(lambda _, __: Sharding(mesh, P()), tree)
    return data_shards(shard_tree(tree, whole), mesh)
