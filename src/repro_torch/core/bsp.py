"""Static BSP executor on the card: a compiled Program run in K-Vcycle chunks.

Port of ``repro.core.bsp``. Core *c* of the Manticore grid
is thread *c* of a CUDA block, and one block holds a whole machine (one
stimulus): ``kernels/csrc/vcycle_chunk.cu`` runs up to K Vcycles per
launch, each one the slot loop on every core, then the BSP exchange of SEND
values at the Vcycle boundary, then (for a modulo-pipelined program) the
next Vcycle's prologue. The host reads the exception flags once per chunk.

The privileged core's off-chip traffic (GLD/GST) runs inline through the
paper's direct-mapped cache + global-stall cost model: stalls do not change
simulation results, so the engines only count them (§7.7 / Fig. 8).

``Machine(..., specialize=False)`` is the seed arm, the baseline of the
engine benchmarks: one launch of ``kernels/csrc/vcycle_seed.cu`` per
Vcycle (the whole stream, full ISA select, ``[T, C]`` result trace), the
exchange routed from the trace, and one host read of the flags per Vcycle.

``ShardedBatchedMachine`` shards the stimulus batch over a list of
devices, one batched chunk binding each, driven by one controller; the
core-sharded grid is ``core/grid.py``.

The reference's XLA-specific machinery (the unrolled window graphs and the
segmented-scan fallback) has no counterpart: on the card the kernel is the
engine. ``Machine`` is ``BatchedMachine``'s kernel at B=1.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every chunk goes through the kernel's plain PyTorch version.

State tensors are ``int32`` holding the reference's ``uint32`` words.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device, resolve_devices
from ..kernels.ops import make_vcycle, make_vcycle_chunk
from .compile import Program
from .isa import Op

# Vcycles per chunked dispatch: one launch simulates up to K RTL cycles;
# the host looks at the exception flags once per chunk.
DEFAULT_CHUNK = 32

# per-element cycle counter value that marks a batch-padding element: it is
# >= any real budget, so the element's freeze predicate is never active —
# padding executes nothing, raises nothing and counts nothing
PAD_FROZEN_CYC = 1 << 30


def to_words(a, device) -> torch.Tensor:
    """Host array of machine words (any unsigned/int dtype) -> int32 tensor
    of their uint32 bit patterns on ``device``."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32)
    return torch.from_numpy(a).to(device)


def from_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of machine words -> host uint32 array."""
    return t.detach().cpu().numpy().view(np.uint32)


def _is_stacked(images) -> bool:
    """True for the stacked ``([B, C, R], [B, C, S], [B, G])`` image form
    (``Program.init_images_batch``) as opposed to a per-stimulus list of
    ``(reg, spad, gmem)`` tuples. Shape-driven, not type-driven: a
    per-stimulus sequence holds tuples (no ``ndim``), never 3-D arrays."""
    return (len(images) == 3
            and getattr(images[0], "ndim", 0) == 3
            and getattr(images[1], "ndim", 0) == 3
            and getattr(images[2], "ndim", 0) == 2)


class MachineState(NamedTuple):
    regs: torch.Tensor        # [C, R] int32 (values are 16-bit)
    spads: torch.Tensor       # [C, S] int32
    gmem: torch.Tensor        # [G] int32
    flags: torch.Tensor       # [C] int32 — first exception id per core
    cache_tags: torch.Tensor  # [LINES] int32 (-1 = invalid)
    counters: torch.Tensor    # [4] int32: vcycles, ghits, gmisses, stalls


def shard_of(state: MachineState, s: int) -> MachineState:
    """Shard ``s`` of a multi-device state, whose every leaf is a tuple of
    per-shard tensors (each on its own device)."""
    return MachineState(*(leaf[s] for leaf in state))


def join_shards(shards) -> MachineState:
    """The multi-device state of per-shard states (see :func:`shard_of`)."""
    return MachineState(*(tuple(leaf) for leaf in zip(*shards)))


def dispatch_chunks(run_chunk, cyc, carry, chunk: int, num_cycles: int,
                    done):
    """Host side of the chunked K-Vcycle dispatch: launch
    ceil(num_cycles/chunk) chunks, reading the exception flags once per
    chunk (the only host sync) and stopping early when ``done(flags)``."""
    n_launch = -(-num_cycles // chunk) if num_cycles > 0 else 0
    for _ in range(n_launch):
        cyc, carry = run_chunk(cyc, num_cycles, carry)
        if done(carry[3]):
            break
    return carry


class Machine:
    """Executable instance of a compiled Program (one stimulus, one card).

    ``compact`` simulates only the used cores and registers (as the
    reference does); ``chunk`` is K, the Vcycles per kernel launch.
    ``specialize=False`` selects the seed arm (see the module docstring)."""

    def __init__(self, program: Program, *, device=None, compact: bool = True,
                 chunk: int = DEFAULT_CHUNK, specialize: bool = True,
                 _batch: Optional[int] = None):
        self.p = program
        self.device = resolve_device(device)
        self.chunk = max(1, int(chunk))
        self.specialize = specialize
        hw = program.hw
        # active-core / active-register compaction (beyond-paper: the FPGA
        # burns idle cores and its 2048-entry register file for free)
        C = program.used_cores if compact else program.code.shape[0]
        self.C = C = max(C, 1)
        self.R = program.used_reg_count() if compact else hw.num_regs
        self.reg0 = to_words(program.reg_init[:C, :self.R], self.device)
        self.spad0 = to_words(program.spad_init[:C], self.device)
        self.gmem0 = to_words(program.gmem_init, self.device)
        self.n_sends = program.n_sends
        self.cache_lines = hw.cache_words // hw.cache_line_words
        # rotated dispatch of a modulo-pipelined program: the stream's first
        # ``pipe_prologue`` slots hold the *next* Vcycle's hoisted pure ops;
        # the kernel runs them after the exchange, gated on "no exception
        # this cycle", and ``init_state`` applies iteration 0's once. The
        # seed arm keeps the whole stream: the prologue rows at its head are
        # pure ops whose inputs are untouched since the previous Vcycle's
        # tail, so both forms give identical registers.
        self.Tpro = int(program.pipe_prologue) if specialize else 0
        if self.Tpro:
            head = program.code[:C, :self.Tpro, 0]
            illegal = {int(o) for o in np.unique(head)} & {
                int(o) for o in (Op.ST, Op.GST, Op.EXPECT, Op.SEND, Op.LD,
                                 Op.GLD)}
            if illegal:
                raise ValueError(
                    f"pipelined prologue contains impure opcodes {illegal}")
        if specialize:
            self._kernel = make_vcycle_chunk(program, C, self.chunk,
                                             batch=_batch, device=self.device)
        else:
            self._seed = make_vcycle(program, C, self.R, device=self.device)
            self._xchg = tuple(
                torch.from_numpy(np.asarray(a, np.int64)).to(self.device)
                for a in (program.xchg_src_slot, program.xchg_src_core,
                          program.xchg_dst_core, program.xchg_dst_reg))
            self._vcycle_count = torch.tensor(
                [1, 0, 0, 0], dtype=torch.int32, device=self.device)

    def _words(self, a) -> torch.Tensor:
        return to_words(a, self.device)

    # ------------------------------------------------------------------
    def init_state(self, images=None) -> MachineState:
        """Initial machine state; ``images=(reg_init, spad_init, gmem_init)``
        (full-width arrays, e.g. from ``Program.init_images``) selects a
        different stimulus than the program's base init."""
        if images is None:
            regs, spads, gmem = self.reg0, self.spad0, self.gmem0
        else:
            ri, si, gi = images
            regs = self._words(np.asarray(ri)[:self.C, :self.R])
            spads = self._words(np.asarray(si)[:self.C])
            gmem = self._words(gi)
        if self.Tpro:
            # iteration 0's hoisted pure ops run once, before the first body
            regs = self._kernel.prologue(regs, spads)
        return MachineState(
            regs=regs, spads=spads, gmem=gmem,
            flags=torch.zeros((self.C,), dtype=torch.int32,
                              device=self.device),
            cache_tags=torch.full((self.cache_lines,), -1, dtype=torch.int32,
                                  device=self.device),
            counters=torch.zeros((4,), dtype=torch.int32,
                                 device=self.device))

    def run(self, state: MachineState, num_cycles: int) -> MachineState:
        """Run up to ``num_cycles`` Vcycles; freezes on the first exception
        (the host services it — paper's global stall + host handshake)."""
        if not self.specialize:
            return self._run_seed(state, int(num_cycles))
        cyc = torch.zeros((1,), dtype=torch.int32, device=self.device)
        carry = dispatch_chunks(self._kernel, cyc, tuple(state), self.chunk,
                                int(num_cycles), lambda f: bool(f.any()))
        return MachineState(*carry)

    # ------------------------------------------------ seed (baseline) ----
    def _vcycle_seed(self, carry):
        """One seed Vcycle: the kernel, then the exchange from the trace
        (``regs[d_core, d_reg] = trace[s_slot, s_core]``), then
        ``counters[0] += 1``."""
        (regs, spads, gmem, flags, tags, counters), trace = self._seed(carry)
        if self.n_sends:
            s_slot, s_core, d_core, d_reg = self._xchg
            regs[d_core, d_reg] = trace[s_slot, s_core]
        return (regs, spads, gmem, flags, tags,
                counters + self._vcycle_count)

    def _run_seed(self, state: MachineState, num_cycles: int):
        """The reference's ``_run_legacy``: before each Vcycle, stop at the
        budget or once a flag is set (one host read per Vcycle), so a
        raising Vcycle completes its body, exchange and count."""
        carry = tuple(state)
        for _ in range(num_cycles):
            if bool(carry[3].any()):
                break
            carry = self._vcycle_seed(carry)
        return MachineState(*carry)

    def exceptions(self, state: MachineState) -> Dict[int, int]:
        f = from_words(state.flags)
        return {int(c): int(e) for c, e in enumerate(f) if e}

    def read_output(self, state: MachineState, name: str) -> int:
        core, mregs = self.p.outputs[name]
        regs = from_words(state.regs)
        out = 0
        for j, r in enumerate(mregs):
            out |= int(regs[core, r]) << (16 * j)
        return out

    def read_reg(self, state: MachineState, rtl_name: str) -> int:
        words = self.p.state_regs[rtl_name]
        regs = from_words(state.regs)
        out = 0
        for j, locs in enumerate(words):
            c, r = locs[0]
            out |= int(regs[c, r]) << (16 * j)
        return out

    def perf(self, state: MachineState) -> Dict[str, int]:
        cnt = from_words(state.counters)
        vcycles = int(cnt[0])
        stalls = int(cnt[3])
        return {
            "vcycles": vcycles,
            "ghits": int(cnt[1]),
            "gmisses": int(cnt[2]),
            "stall_cycles": stalls,
            "machine_cycles": vcycles * self.p.vcpl + stalls,
        }


class BatchedMachine(Machine):
    """B independent stimuli of one compiled Program per kernel launch.

    The compile-time pipeline is paid once per design; the card's blocks
    then carry B testbenches that share ``code``/``luts`` and differ only
    in initial state (``Program.init_images`` planes). Every
    ``MachineState`` leaf gains a leading ``[B]`` axis and the kernel runs
    one block per element, so each element's registers and scratchpad stay
    in shared memory for the whole chunk.

    Exception semantics are per element: element ``b`` freezes at its
    raising Vcycle while the others run on; the host reads the flags once
    per K-Vcycle chunk, as the single-stimulus dispatch does.
    """

    def __init__(self, program: Program, images=None,
                 batch: Optional[int] = None, *, device=None,
                 compact: bool = True, chunk: int = DEFAULT_CHUNK):
        super().__init__(program, device=device, compact=compact,
                         chunk=chunk, _batch=self._count(images, batch))
        self._set_images(images, batch)

    @staticmethod
    def _count(images, batch) -> int:
        if images is None:
            if batch is None or batch < 1:
                raise ValueError("BatchedMachine needs init images or an "
                                 "explicit batch size")
            return int(batch)
        if _is_stacked(images):
            return int(np.asarray(images[0]).shape[0])
        return len(images)

    # ------------------------------------------------------------------
    def _set_images(self, images, batch: Optional[int]) -> None:
        """Load the per-stimulus init images into the batched ``[B, ...]``
        layout (sets ``breg0``/``bspad0``/``bgmem0`` and ``B``)."""
        C, R = self.C, self.R
        B = self._count(images, batch)
        if images is None:
            self.breg0 = self.reg0.expand((B,) + self.reg0.shape).contiguous()
            self.bspad0 = self.spad0.expand(
                (B,) + self.spad0.shape).contiguous()
            self.bgmem0 = self.gmem0.expand(
                (B,) + self.gmem0.shape).contiguous()
        elif _is_stacked(images):
            # pre-stacked [B, ...] image arrays (Program.init_images_batch /
            # Bench.images_batch): already in the batched layout
            ri, si, gi = images
            self.breg0 = self._words(np.asarray(ri)[:, :C, :R])
            self.bspad0 = self._words(np.asarray(si)[:, :C])
            self.bgmem0 = self._words(gi)
        else:
            self.breg0 = self._words(
                np.stack([np.asarray(ri)[:C, :R] for ri, _, _ in images]))
            self.bspad0 = self._words(
                np.stack([np.asarray(si)[:C] for _, si, _ in images]))
            self.bgmem0 = self._words(
                np.stack([np.asarray(gi) for _, _, gi in images]))
        self.B = B
        # iteration 0's prologue, once per stimulus (pure — regs only)
        self.breg0 = self._kernel.prologue(self.breg0, self.bspad0)

    def rebind_images(self, images) -> None:
        """Swap in a new batch of per-stimulus init images *in place*.

        The batch size must match, so only the initial state changes and
        the bound kernel tables stay on the card: per-batch image turnover
        costs one host→device transfer. ``init_state()`` after a rebind
        starts the new stimuli."""
        if images is None:
            raise ValueError("rebind_images needs init images")
        B = self._count(images, None)
        if B != self.B:
            raise ValueError(
                f"rebind_images: batch size changed {self.B} -> {B}; "
                "build a new machine for a different B")
        self._set_images(images, None)

    def init_state(self) -> MachineState:
        B, dev = self.B, self.device
        return MachineState(
            regs=self.breg0,
            spads=self.bspad0,
            gmem=self.bgmem0,
            flags=torch.zeros((B, self.C), dtype=torch.int32, device=dev),
            cache_tags=torch.full((B, self.cache_lines), -1,
                                  dtype=torch.int32, device=dev),
            counters=torch.zeros((B, 4), dtype=torch.int32, device=dev))

    def run(self, state: MachineState, num_cycles: int) -> MachineState:
        # stop dispatching only once *every* element froze
        cyc = torch.zeros((self.B,), dtype=torch.int32, device=self.device)
        carry = dispatch_chunks(
            self._kernel, cyc, tuple(state), self.chunk, int(num_cycles),
            lambda f: bool(f.ne(0).any(dim=1).all()))
        return MachineState(*carry)

    # ---------------------------------------------- per-element access ----
    def element(self, state: MachineState, b: int) -> MachineState:
        """Single-stimulus view of batch element ``b``."""
        return MachineState(*(leaf[b] for leaf in state))

    def exceptions(self, state: MachineState, b: Optional[int] = None):
        if b is not None:
            return super().exceptions(self.element(state, b))
        return [super(BatchedMachine, self).exceptions(self.element(state, i))
                for i in range(self.B)]

    def read_output(self, state: MachineState, name: str, b: int = 0) -> int:
        return super().read_output(self.element(state, b), name)

    def read_reg(self, state: MachineState, rtl_name: str, b: int = 0) -> int:
        return super().read_reg(self.element(state, b), rtl_name)

    def perf(self, state: MachineState, b: Optional[int] = None):
        if b is not None:
            return super().perf(self.element(state, b))
        cnt = from_words(state.counters).astype(np.int64)
        vcycles = int(cnt[:, 0].sum())
        stalls = int(cnt[:, 3].sum())
        return {
            "batch": self.B,
            "vcycles": vcycles,                 # aggregate over the batch
            "ghits": int(cnt[:, 1].sum()),
            "gmisses": int(cnt[:, 2].sum()),
            "stall_cycles": stalls,
            "machine_cycles": vcycles * self.p.vcpl + stalls,
        }


class ShardedBatchedMachine(BatchedMachine):
    """B stimuli of one Program sharded ``[D, B/D]`` over a list of devices.

    Port of ``repro.core.bsp.ShardedBatchedMachine``. ``BatchedMachine``
    runs B stimuli on one card; this engine gives each of D devices its
    own ``B/D``-element shard of every state leaf and its own batched
    chunk binding, on that device. One controller drives them all: each
    chunk launches every shard in turn, then the host syncs once, on the
    assembled ``[Bp]`` frozen mask (a flag set, or the budget spent).
    Stimuli are independent, so no word crosses shards. ``devices`` is a
    sequence of devices, which may repeat (``["cuda:0"] * 4`` runs four
    shards on one card, ``["cpu"] * 8`` eight on the CPU); None means
    every card.

    **Padding.** B is padded up to ``Bp = ceil(B/D)*D`` with replicas of
    stimulus 0's images (its prologue applied, as every element's is),
    whose cycle counters start at ``PAD_FROZEN_CYC``: they execute nothing,
    raise nothing, keep zero flags and counters, and appear in no result.

    The state's leaves are tuples of per-shard tensors (``shard_of``,
    ``gather``); shard s holds elements ``[s*Bp/D, (s+1)*Bp/D)``. The
    per-element accessors read element b from its shard; ``perf()`` and
    ``exceptions()`` cover the logical B only.
    """

    def __init__(self, program: Program, images=None,
                 batch: Optional[int] = None, *, devices=None,
                 compact: bool = True, chunk: int = DEFAULT_CHUNK):
        self.devices = resolve_devices(devices)
        self.D = len(self.devices)
        super().__init__(program, images=images, batch=batch,
                         device=self.devices[0], compact=compact,
                         chunk=chunk)
        # a binding holds no state: the shards on the first device share it
        self._kernels = [
            self._kernel if d == self.device else make_vcycle_chunk(
                program, self.C, self.chunk, batch=self.Bl, device=d)
            for d in self.devices]

    def _set_images(self, images, batch: Optional[int]) -> None:
        """``BatchedMachine``'s images, padded to ``Bp`` and split into
        per-device shards (``sreg0``/``sspad0``/``sgmem0``, ``_cyc0``)."""
        super()._set_images(images, batch)
        B, D = self.B, self.D
        self.Bp = Bp = -(-B // D) * D
        self.Bl = Bl = Bp // D

        def split(a):
            a = torch.cat([a, a[:1].expand((Bp - B,) + a.shape[1:])])
            return tuple(a[s * Bl:(s + 1) * Bl].to(dev)
                         for s, dev in enumerate(self.devices))

        self.sreg0 = split(self.breg0)
        self.sspad0 = split(self.bspad0)
        self.sgmem0 = split(self.bgmem0)
        cyc = np.where(np.arange(Bp) < B, 0, PAD_FROZEN_CYC)
        self._cyc0 = split(torch.from_numpy(cyc.astype(np.int32)))

    def init_state(self) -> MachineState:
        shards = []
        for s, dev in enumerate(self.devices):
            shards.append(MachineState(
                regs=self.sreg0[s], spads=self.sspad0[s],
                gmem=self.sgmem0[s],
                flags=torch.zeros((self.Bl, self.C), dtype=torch.int32,
                                  device=dev),
                cache_tags=torch.full((self.Bl, self.cache_lines), -1,
                                      dtype=torch.int32, device=dev),
                counters=torch.zeros((self.Bl, 4), dtype=torch.int32,
                                     device=dev)))
        return join_shards(shards)

    def run(self, state: MachineState, num_cycles: int) -> MachineState:
        """Up to ``num_cycles`` Vcycles of every element: each chunk
        launches every shard, then one host sync on the frozen mask."""
        n = int(num_cycles)
        shards = [shard_of(state, s) for s in range(self.D)]
        cyc = list(self._cyc0)
        for _ in range(-(-n // self.chunk) if n > 0 else 0):
            for s, kernel in enumerate(self._kernels):
                cyc[s], carry = kernel(cyc[s], n, tuple(shards[s]))
                shards[s] = MachineState(*carry)
            # the mask is assembled on the host, once every shard is
            # launched: each shard's copy waits for that shard alone, and
            # no copy goes from card to card
            frozen = [(sh.flags.ne(0).any(1) | (c >= n)).cpu()
                      for sh, c in zip(shards, cyc)]
            if bool(torch.cat(frozen).all()):
                break
        return join_shards(shards)

    def gather(self, state: MachineState) -> MachineState:
        """The whole ``[Bp, ...]`` state on the host, as int32 tensors."""
        return MachineState(*(torch.cat([t.cpu() for t in leaf])
                              for leaf in state))

    # ---------------------------------------------- per-element access ----
    def element(self, state: MachineState, b: int) -> MachineState:
        if not 0 <= b < self.B:
            raise IndexError(f"element {b} outside the batch of {self.B}")
        s, i = divmod(b, self.Bl)
        return MachineState(*(leaf[s][i] for leaf in state))

    def perf(self, state: MachineState, b: Optional[int] = None):
        if b is not None:
            return super().perf(state, b)
        # the logical batch only (padding counts nothing, but stays out
        # of the contract regardless)
        host = self.gather(state)
        return BatchedMachine.perf(
            self, MachineState(*(leaf[:self.B] for leaf in host)))
