"""Multi-device static BSP execution: the machine's cores sharded over devices.

Port of ``repro.core.grid``: the paper's NoC scaled past one card. A
Manticore grid is cut into D shards of ``cl = ceil(C/D)`` cores, one per
device, and the Vcycle-boundary exchange crosses devices. The compiler
knows every SEND (source core and slot, destination core and register) at
compile time, so ``_build_exchange`` groups them into a *static* message
table per device pair: message ``k`` from shard ``s`` to shard ``d``
always carries the same value into the same (core, register) cell.

One controller drives every shard, as the reference's single-controller
mesh does: each shard's tables and state live on its own device, and a
Vcycle is one launch of the chunk kernel per shard at K=1
(``kernels/ops.py make_vcycle_shard``), then the exchange. A shard's
binding holds its ``cl`` cores and a few *outbox* cores that run no code:
a SEND to a core of the same shard goes through the kernel's own exchange,
a SEND to another shard lands in an outbox register, in the order of the
message table. After the launches, each pair's block of outbox words is
copied to the receiving shard's device (``.to(dev, non_blocking=True)``)
and scattered into its ``(rcv_core, rcv_reg)`` cells: indexing on the
device, no host sync. A device may repeat (``["cuda:0"] * 4`` runs four
shards on one card): the exchange is then a copy within the card.

Semantics kept from the reference:

* **Global gate.** A Vcycle of element b runs only if no core of any
  shard has a flag set and ``cyc < budget``; the raising Vcycle completes
  its body, its exchange and its count on every shard. The gate is
  computed on the device and handed to each shard's launch as its cycle
  counter (``budget`` when frozen), so the host syncs once per chunk of K
  Vcycles (``dispatch_chunks``).
* **Unrotated program.** The reference's grid scans all T rows in order
  every Vcycle, a modulo-pipelined program's prologue rows first, and
  applies no prologue at ``init_state``; so does this one (the shard
  bindings have no prologue of their own).
* **Global memory and counters.** Every shard keeps its own ``gmem``,
  cache tags and counters; only the shard that owns the privileged core
  runs GLD/GST, and every shard counts its Vcycles. ``perf`` reads the
  privileged core's shard (shard 0 when the program has no GLD/GST).

``GridMachine(prog, mesh, images=[...])`` runs B stimuli: every state
leaf gains a leading ``[B]`` axis and freezes per element. The state's
leaves are tuples of per-shard tensors (``core.bsp.shard_of``);
``gather`` lays them out on the host as the reference's state:
``regs [(B,) Cp, R]``, ``spads [(B,) Cp, S]``, ``gmem [(B,) D, G]``,
``flags [(B,) Cp]``, ``cache_tags [(B,) D, lines]``, ``counters
[(B,) D, 4]``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_devices
from ..kernels.ops import make_vcycle_shard
from .bsp import (DEFAULT_CHUNK, MachineState, _is_stacked, dispatch_chunks,
                  from_words, join_shards, shard_of, to_words)
from .compile import Program


class ExchangeTables(NamedTuple):
    """One shard's rows of the static message tables, ``[D, M]`` int32 on
    its device: row d of ``snd_idx`` holds the local SEND-buffer slots of
    the messages it sends to shard d; row s of ``rcv_core``/``rcv_reg``
    the local core and register where each message from shard s lands,
    and of ``rcv_valid`` which of the M entries hold a message (1)."""
    snd_idx: torch.Tensor
    rcv_core: torch.Tensor
    rcv_reg: torch.Tensor
    rcv_valid: torch.Tensor


# copied from src/repro/core/grid.py at 95b5484
def _build_exchange(program: Program, D: int, cl: int,
                    Cp: int) -> Tuple[np.ndarray, ...]:
    """Group the compile-time SEND table by (src_dev, dst_dev).

    Returns (snd_idx, rcv_core, rcv_reg, rcv_valid, cap, L): each device
    captures its own SENDs into a compact local buffer of ``L + 1`` words
    (``cap`` is the [T, Cp] capture-index table, sacrificial index ``L``),
    and message ``k`` of pair (s, d) reads local buffer slot
    ``snd_idx[s, d, k]``.
    """
    n = program.n_sends
    T = program.code.shape[1]
    loc_li = np.zeros((n,), np.int32)        # global send -> local index
    counts = [0] * D
    for i in range(n):
        sd = int(program.xchg_src_core[i]) // cl
        loc_li[i] = counts[sd]
        counts[sd] += 1
    L = max(counts) if counts else 0

    msgs: Dict[Tuple[int, int], list] = {}
    for i in range(n):
        sc = int(program.xchg_src_core[i]); dc = int(program.xchg_dst_core[i])
        sd, dd = sc // cl, dc // cl
        msgs.setdefault((sd, dd), []).append(
            (int(loc_li[i]), dc % cl, int(program.xchg_dst_reg[i])))
    mmax = max((len(v) for v in msgs.values()), default=0)
    mmax = max(mmax, 1)
    shape = (D, D, mmax)
    snd_idx = np.full(shape, L, np.int32)    # invalid -> sacrificial slot
    rcv_core = np.zeros(shape, np.int32)
    rcv_reg = np.zeros(shape, np.int32)
    rcv_valid = np.zeros(shape, bool)
    for (sd, dd), lst in msgs.items():
        for k, (li, dcore, dreg) in enumerate(lst):
            snd_idx[sd, dd, k] = li
            # receive tables are indexed by the *receiver*: row = src device
            rcv_core[dd, sd, k] = dcore
            rcv_reg[dd, sd, k] = dreg
            rcv_valid[dd, sd, k] = True

    cap = np.full((T, Cp), L, np.int32)
    for i in range(n):
        cap[int(program.xchg_src_slot[i]),
            int(program.xchg_src_core[i])] = loc_li[i]
    return snd_idx, rcv_core, rcv_reg, rcv_valid, cap, L


class GridMachine:
    """Static BSP executor over a list of devices (the reference's 1-D
    mesh over axis ``cores``): cores ``[s*cl, (s+1)*cl)`` on
    ``mesh[s]``.

    ``images=[(reg_init, spad_init, gmem_init), ...]`` (or the stacked
    ``[B, ...]`` form) selects batched mode: B stimuli of the one compiled
    program run together, each state leaf carrying a leading [B] axis.
    """

    def __init__(self, program: Program, mesh, images=None,
                 chunk: int = DEFAULT_CHUNK):
        self.p = program
        self.devices = resolve_devices(mesh)
        self.chunk = max(1, int(chunk))
        D = self.D = len(self.devices)
        C = program.used_cores
        cl = max(1, -(-C // D))            # cores per device
        Cp = cl * D
        self.C, self.cl, self.Cp = C, cl, Cp
        R = self.R = program.used_reg_count()   # active-register compaction
        if images is None:
            self.B = None
            ri = program.reg_init[None]
            si = program.spad_init[None]
            gi = program.gmem_init[None]
        elif _is_stacked(images):
            ri, si, gi = (np.asarray(a) for a in images)
            self.B = int(ri.shape[0])
        else:
            self.B = len(images)
            ri, si, gi = (np.stack([np.asarray(im[k]) for im in images])
                          for k in range(3))
        self.Bi = Bi = self.B or 1                # the kernels' batch
        self.cache_lines = program.hw.cache_words // \
            program.hw.cache_line_words

        snd_idx, rcv_core, rcv_reg, rcv_valid, cap, _ = _build_exchange(
            program, D, cl, Cp)
        self.xt = [ExchangeTables(*(
            torch.from_numpy(a[s].astype(np.int32)).to(dev)
            for a in (snd_idx, rcv_core, rcv_reg, rcv_valid)))
            for s, dev in enumerate(self.devices)]
        n_msg = rcv_valid.sum(axis=2)            # [dst, src] messages
        # the local sends of shard s: kept on the shard (the kernel's own
        # exchange), or routed into its outbox, message after message in
        # the table's order; route (s, d, lo, hi, core, reg) copies outbox
        # words [lo, hi) of shard s into cells (core, reg) of shard d
        self._kernels, self.n_box, self._routes = [], [], []
        for s, dev in enumerate(self.devices):
            dcore = np.zeros((int(n_msg[:, s].sum()),), np.int32)
            dreg = np.zeros_like(dcore)
            j = 0
            for d in range(D):
                k = int(n_msg[d, s])
                li = snd_idx[s, d, :k]
                if d == s:
                    dcore[li] = rcv_core[s, s, :k]
                    dreg[li] = rcv_reg[s, s, :k]
                    continue
                pos = j + np.arange(k)
                dcore[li] = cl + pos // R
                dreg[li] = pos % R
                if k:
                    xt = self.xt[d]
                    self._routes.append((s, d, j, j + k,
                                         xt.rcv_core[s, :k].long(),
                                         xt.rcv_reg[s, :k].long()))
                j += k
            n_box = -(-j // R)
            self.n_box.append(n_box)
            self._kernels.append(make_vcycle_shard(
                program, s * cl, cl, n_box, cap[:, s * cl:(s + 1) * cl],
                dcore, dreg, 1, batch=Bi, device=dev))
        # words that cross shards per element and Vcycle
        self.cross_words = sum(hi - lo for _, _, lo, hi, _, _ in
                               self._routes)
        self.gshard = next((s for s, k in enumerate(self._kernels)
                            if k.gcore >= 0), 0)

        # initial images, each shard's cores then its (zero) outbox
        def pad_cores(a):
            out = np.zeros((Bi, Cp) + a.shape[2:], np.uint32)
            out[:, :C] = a[:, :C]
            return out

        regs, spads = pad_cores(ri[:, :, :R]), pad_cores(si)
        self.reg0, self.spad0, self.gmem0 = [], [], []
        for s, dev in enumerate(self.devices):
            box = np.zeros((Bi, self.n_box[s], R), np.uint32)
            self.reg0.append(to_words(np.concatenate(
                [regs[:, s * cl:(s + 1) * cl], box], axis=1), dev))
            self.spad0.append(to_words(np.concatenate(
                [spads[:, s * cl:(s + 1) * cl],
                 np.zeros((Bi, self.n_box[s], spads.shape[2]), np.uint32)],
                axis=1), dev))
            self.gmem0.append(to_words(gi, dev))

    # ------------------------------------------------------------------
    def init_state(self) -> MachineState:
        shards = []
        for s, dev in enumerate(self.devices):
            Cs = self.cl + self.n_box[s]
            shards.append(MachineState(
                regs=self.reg0[s], spads=self.spad0[s], gmem=self.gmem0[s],
                flags=torch.zeros((self.Bi, Cs), dtype=torch.int32,
                                  device=dev),
                cache_tags=torch.full((self.Bi, self.cache_lines), -1,
                                      dtype=torch.int32, device=dev),
                counters=torch.zeros((self.Bi, 4), dtype=torch.int32,
                                     device=dev)))
        return join_shards(shards)

    def _raised(self, flags) -> torch.Tensor:
        """[Bi] bool on the first device: a flag set on any shard."""
        out = None
        for f in flags:
            r = f.ne(0).any(1).to(self.devices[0])
            out = r if out is None else out | r
        return out

    def _vcycle(self, cyc: torch.Tensor, budget: int, shards):
        """One Vcycle of every element on every shard: the launches, then
        the exchange across shards. Returns (cyc, shards)."""
        raised = self._raised([sh.flags for sh in shards])
        act = ~raised & (cyc < budget)
        gate = cyc.masked_fill(raised, min(budget, 2**31 - 1))
        # the gate reaches every device before any launch, and the outbox
        # blocks cross only once every shard is launched: a copy between
        # cards may hold the host until its source is done
        moved = {dev: (gate.to(dev), act.to(dev)[:, None])
                 for dev in self.devices}
        out = [MachineState(*kernel(moved[dev][0], budget, tuple(sh))[1])
               for kernel, dev, sh in zip(self._kernels, self.devices,
                                          shards)]
        for s, d, lo, hi, core, reg in self._routes:
            dev = self.devices[d]
            block = out[s].regs[:, self.cl:].reshape(self.Bi, -1)[:, lo:hi]
            regs = out[d].regs
            regs[:, core, reg] = torch.where(
                moved[dev][1], block.to(dev, non_blocking=True),
                regs[:, core, reg])
        return cyc + act.to(torch.int32), out

    def _run_chunk(self, cyc: torch.Tensor, budget: int, state):
        shards = [shard_of(state, s) for s in range(self.D)]
        for _ in range(self.chunk):
            cyc, shards = self._vcycle(cyc, budget, shards)
        return cyc, join_shards(shards)

    def run(self, state: MachineState, num_cycles: int) -> MachineState:
        """Up to ``num_cycles`` Vcycles, in chunks of K with one host sync
        each; stops once every element has raised."""
        cyc = torch.zeros((self.Bi,), dtype=torch.int32,
                          device=self.devices[0])
        return MachineState(*dispatch_chunks(
            self._run_chunk, cyc, state, self.chunk, int(num_cycles),
            lambda flags: bool(self._raised(flags).all())))

    # ------------------------------------------------------------------
    def gather(self, state: MachineState) -> MachineState:
        """The state on the host in the reference's layout (see the module
        docstring): uint32 words, int32 cache tags, the outbox cores
        dropped. A gathered state is returned as it is, so every accessor
        takes either."""
        if isinstance(state.regs, np.ndarray):
            return state
        cl = self.cl

        def cores(leaf):
            return np.concatenate([from_words(t)[:, :cl] for t in leaf], 1)

        def per_shard(leaf):
            return np.stack([from_words(t) for t in leaf], 1)

        out = MachineState(
            regs=cores(state.regs), spads=cores(state.spads),
            gmem=per_shard(state.gmem), flags=cores(state.flags),
            cache_tags=per_shard(state.cache_tags).view(np.int32),
            counters=per_shard(state.counters))
        return out if self.B is not None else MachineState(
            *(leaf[0] for leaf in out))

    def _elem(self, a, b):
        """Strip the batch axis: element ``b`` (default 0) when batched,
        the array itself when not."""
        if self.B is None:
            return a
        return a[0 if b is None else b]

    def exceptions(self, state: MachineState, b: Optional[int] = None):
        """Exceptions as {core: id}; with batched state and ``b=None``,
        one dict per batch element (mirroring BatchedMachine)."""
        state = self.gather(state)
        if self.B is not None and b is None:
            return [self.exceptions(state, i) for i in range(self.B)]
        f = self._elem(state.flags, b)[:self.C]
        return {int(c): int(e) for c, e in enumerate(f) if e}

    def read_reg(self, state: MachineState, rtl_name: str,
                 b: Optional[int] = None) -> int:
        words = self.p.state_regs[rtl_name]
        regs = self._elem(self.gather(state).regs, b)
        out = 0
        for j, locs in enumerate(words):
            c, r = locs[0]
            out |= int(regs[c, r]) << (16 * j)
        return out

    def read_output(self, state: MachineState, name: str,
                    b: Optional[int] = None) -> int:
        core, mregs = self.p.outputs[name]
        regs = self._elem(self.gather(state).regs, b)
        out = 0
        for j, r in enumerate(mregs):
            out |= int(regs[core, r]) << (16 * j)
        return out

    def perf(self, state: MachineState,
             b: Optional[int] = None) -> Dict[str, int]:
        """Performance counters of the privileged core's shard. With
        batched state and ``b=None``, aggregates over the batch."""
        cnt = self.gather(state).counters.astype(np.int64)
        if self.B is not None and b is None:
            cnt = cnt[:, self.gshard].sum(axis=0)
        else:
            cnt = self._elem(cnt, b)[self.gshard]
        return {
            "vcycles": int(cnt[0]),
            "ghits": int(cnt[1]),
            "gmisses": int(cnt[2]),
            "stall_cycles": int(cnt[3]),
            "machine_cycles": int(cnt[0]) * self.p.vcpl + int(cnt[3]),
        }
