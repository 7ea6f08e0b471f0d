"""Roofline terms of a step, read from the ops it dispatches.

The counterpart of ``repro.launch.hlo_analysis``, which reads XLA's
compiled HLO. The port runs eagerly and has no HLO: ``OpCounter`` is a
``TorchDispatchMode`` that reads the op stream of a step while the step
runs on fake tensors (``launch/dryrun.py``), and keeps, for each device:

* FLOPs, by ``torch.utils.flop_counter``'s formulas (those
  ``FlopCounterMode`` uses; the flash kernels register theirs,
  ``kernels/flash_attention.py``);
* HBM bytes: each op's input bytes plus its output bytes (what XLA's
  "bytes accessed" counts); a view, a detach or an allocation moves none;
* collective bytes: each copy whose source and destination are different
  devices (not the host), sent by the one and received by the other, over NVLink within
  a node of ``CARDS_PER_NODE`` cards and over the node's NIC between
  nodes. The port's collectives are such copies (``Group.sum``,
  ``gather``, ``join``, ``total``, ``sum_whole``, ``bucketed_mean``,
  ``pmean``, the expert-parallel route); each is labelled with the port
  function that made it (``label_of``), " (backward)" where autograd made
  it;
* live and peak bytes: each storage counted on its device from the op
  that makes it until it dies.

Hardware constants, per card (NVIDIA H100 SXM5 and DGX H100 data sheets):
989e12 FLOP/s bf16 dense on the tensor cores, 3.35e12 B/s HBM3; NVLink
450e9 B/s each way between the 8 cards of a node, and one 400 Gb/s NIC a
card, 50e9 B/s each way, between nodes. Data-sheet figures, not measured.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s a card (data sheet)
HBM_BW = 3.35e12             # bytes/s a card (data sheet)
NVLINK_BW = 450e9            # bytes/s each way a card, within a node
NIC_BW = 50e9                # bytes/s each way a card, between nodes
CARDS_PER_NODE = 8
LINK_BW = {"nvlink": NVLINK_BW, "nic": NIC_BW}

_aten = torch.ops.aten
# ops that move no bytes: views are caught by ``is_view``
_NO_BYTES = {_aten.detach.default, _aten.alias.default,
             _aten.lift_fresh.default, _aten._unsafe_view.default,
             _aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default,
             _aten._local_scalar_dense.default}
_METADATA = {_aten.is_contiguous, _aten.is_strides_like_format,
             _aten.is_non_overlapping_and_dense, _aten.size, _aten.sym_size,
             _aten.stride, _aten.sym_stride, _aten.storage_offset,
             _aten.sym_storage_offset, _aten.numel, _aten.sym_numel,
             _aten.dim}
# ops found to have no decomposition
_WHOLE = set()
_COPIES = {_aten._to_copy.default, _aten.copy_.default,
           _aten._copy_from.default}
# the port's collectives by qualified name: a copy takes the outermost of
# these on its stack, else the innermost port function
COLLECTIVES = {"Group.sum", "Group.gather", "Group.join", "Group.total",
               "Group.copy", "sum_whole", "global_norm", "_compress",
               "bucketed_mean", "pmean", "split_batch"}
_PKG = __file__.rsplit("/launch/", 1)[0] + "/"
_SELF = (__file__, __file__.replace("hlo_analysis.py", "dryrun.py"))


def tensors(x) -> list:
    """The tensors in an op's arguments or outputs (nested lists, tuples
    and dicts; faster than a pytree walk, which a trace does per op)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    return []


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def node_of(device: torch.device) -> int:
    return (device.index or 0) // CARDS_PER_NODE


def label_of() -> str:
    """The port function that made the copy being dispatched: the
    outermost of ``COLLECTIVES`` on the stack, else the innermost function
    of the port (a generator expression or a lambda stands for the
    function around it); " (backward)" where the autograd engine runs
    it."""
    outer = inner = None
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code.co_filename.startswith(_PKG) and \
                code.co_filename not in _SELF and \
                not code.co_name.startswith("<"):
            if inner is None:
                inner = code.co_qualname
            if code.co_qualname in COLLECTIVES:
                outer = code.co_qualname
        f = f.f_back
    name = outer or inner or "?"
    if torch._C._current_graph_task_id() != -1:
        name += " (backward)"
    return name


@dataclass
class DeviceStats:
    """One device's counters."""
    flops: int = 0
    bytes_hbm: int = 0
    # bytes sent and received over each kind of link
    link_out: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    link_in: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    live: int = 0
    peak: int = 0

    @property
    def t_link(self) -> float:
        """The least time this device's links take for its copies: the
        slowest of its links, each way, the links running at once."""
        return max([b / LINK_BW[k] for k, b in self.link_out.items()]
                   + [b / LINK_BW[k] for k, b in self.link_in.items()]
                   + [0.0])


@dataclass
class CollectiveStats:
    """Copies between devices and their bytes, by label."""
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_: Dict[str, int] = field(default_factory=dict)


class OpCounter(TorchDispatchMode):
    """Counts, per device, the FLOPs, HBM bytes, collective bytes and
    live bytes of the ops run under it (``DeviceStats`` by
    ``torch.device``); ``collectives`` the copies between devices by
    label. ``reset()`` zeroes the counts and sets each peak to what is
    live; storages made before the counter opened are not seen."""

    def __init__(self):
        super().__init__()
        self.dev: Dict[torch.device, DeviceStats] = defaultdict(DeviceStats)
        self.collectives = CollectiveStats()
        self._storages: Dict[int, tuple] = {}

    def reset(self) -> None:
        for s in self.dev.values():
            s.flops = s.bytes_hbm = 0
            s.link_out.clear()
            s.link_in.clear()
            s.peak = s.live
        self.collectives = CollectiveStats()

    def live_storages(self):
        return set(self._storages)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _WHOLE and func.namespace == "aten" and \
                func.overloadpacket not in flop_registry and \
                func.overloadpacket not in _METADATA:
            # a composite op (``matmul`` under inference mode) runs as
            # the ops it decomposes into, as ``FlopCounterMode`` counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            _WHOLE.add(func)
        out = func(*args, **kwargs)
        outs = tensors(out)
        ins = tensors((args, kwargs))
        for t in outs:
            self._track(t)
        at = (outs or ins or [None])[0]
        if at is None:
            return out
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.dev[at.device].flops += int(formula(*args, **kwargs,
                                                     out_val=out))
        if func.is_view or func in _NO_BYTES or func.namespace == "prim" \
                or func.overloadpacket in _METADATA:
            return out
        for t in ins + outs:
            self.dev[t.device].bytes_hbm += nbytes(t)
        if func in _COPIES:
            src = args[1] if func is _aten.copy_.default else args[0]
            dst = args[0] if func is _aten.copy_.default else outs[0]
            if src.device != dst.device and \
                    src.device.type == dst.device.type != "cpu":
                self._copy(src.device, dst.device, nbytes(dst))
        return out

    def _copy(self, src: torch.device, dst: torch.device, n: int) -> None:
        kind = "nvlink" if node_of(src) == node_of(dst) else "nic"
        self.dev[src].link_out[kind] += n
        self.dev[dst].link_in[kind] += n
        name = label_of()
        c = self.collectives
        c.counts[name] = c.counts.get(name, 0) + 1
        c.bytes_[name] = c.bytes_.get(name, 0) + n

    def _track(self, t: torch.Tensor) -> None:
        st = getattr(t, "_elem", t).untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        s = self.dev[t.device]
        self._storages[key] = (t.device, n)
        s.live += n
        s.peak = max(s.peak, s.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        device, n = self._storages.pop(key)
        self.dev[device].live -= n


@dataclass
class Roofline:
    """A step's roofline over ``n_chips`` cards: ``flops`` and
    ``bytes_hbm`` summed over the cards, ``bytes_collective`` the bytes
    they send, ``t_link`` the busiest card's link time (its copies over
    NVLink and the NIC, each way; shard 0 of each group collects the
    port's sums, so it is that card where they set it)."""
    flops: float
    bytes_hbm: float
    bytes_collective: float
    n_chips: int
    model_flops: float = 0.0
    collectives: Optional[CollectiveStats] = None
    t_link: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.t_link

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound (MFU-at-bound)."""
        if self.step_time == 0:
            return 0.0
        return (self.model_flops / (self.n_chips * PEAK_FLOPS)) / \
            self.step_time

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective,
            "n_chips": self.n_chips, "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": dict(self.collectives.counts)
            if self.collectives else {},
            "collective_bytes": dict(self.collectives.bytes_)
            if self.collectives else {},
        }
