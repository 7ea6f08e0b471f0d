"""The ``Engine`` protocol and its adapters over the port's executors.

Port of ``repro.sim.engine``. Every adapter owns its simulation state,
``run(num_cycles)`` advances *all* stimuli and returns the
:class:`~repro_torch.sim.result.RunResult` of element 0, ``run_batch`` the
full per-stimulus list, and the probe methods take a uniform optional batch
index. ``MachineEngine`` and ``BatchedEngine`` run the CUDA chunk kernel,
``MachineEngine(specialize=False)`` the seed arm's per-Vcycle kernel
(``device="cpu"`` selects their plain versions); ``ShardedBatchedEngine``
and ``GridEngine`` run the chunk kernel on each of a list of devices
(``devices=``/``mesh=``); ``IsaEngine`` and ``OracleEngine`` are the numpy
oracles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np
import torch

from ..core.bsp import (DEFAULT_CHUNK, BatchedMachine, Machine,
                        ShardedBatchedMachine, from_words)
from ..core.grid import GridMachine
from ..core.compile import Program
from ..core.interpreter import NetlistSim
from ..core.isasim import IsaSim
from ..core.netlist import Circuit
from .result import ORACLE_CORE, RunResult

Images = Tuple[np.ndarray, np.ndarray, np.ndarray]


@runtime_checkable
class Engine(Protocol):
    """What every simulation backend exposes to the front door.

    ``batch`` is the stimulus count (1 for single-stimulus engines). A
    ``run`` call advances the whole batch by up to ``num_cycles`` Vcycles
    (stopping early on exceptions, per element where supported) and
    snapshots results; ``reset`` rewinds to the initial images.
    """

    batch: int

    def reset(self) -> None: ...

    def run(self, num_cycles: int) -> RunResult: ...

    def run_batch(self, num_cycles: int) -> List[RunResult]: ...

    def read_reg(self, name: str, b: int = 0) -> int: ...

    def read_output(self, name: str, b: int = 0) -> int: ...

    def exceptions(self, b: int = 0) -> Dict[int, int]: ...

    def perf(self, b: Optional[int] = None) -> Dict[str, float]: ...


def _probe_registers(prog: Program, regs: np.ndarray) -> Dict[str, int]:
    out = {}
    for nm, words in prog.state_regs.items():
        v = 0
        for j, locs in enumerate(words):
            c, r = locs[0]
            v |= int(regs[c, r]) << (16 * j)
        out[nm] = v
    return out


def _probe_outputs(prog: Program, regs: np.ndarray) -> Dict[str, int]:
    out = {}
    for nm, (core, mregs) in prog.outputs.items():
        v = 0
        for j, r in enumerate(mregs):
            v |= int(regs[core, r]) << (16 * j)
        out[nm] = v
    return out


def _snapshot(eng, b: int, regs: Optional[np.ndarray] = None) -> RunResult:
    """Uniform probe sweep: every architectural register and every
    host-visible output the program kept, plus exceptions and counters.
    ``regs`` is the element's register file already on the host (a batched
    sweep copies the whole batch off the card once)."""
    prog: Program = eng.program
    if regs is None:
        regs = eng._regs_np(b)
    perf = dict(eng.perf(b))
    return RunResult(
        cycles=int(perf["vcycles"]),
        exceptions=dict(eng.exceptions(b)),
        perf=perf,
        registers=_probe_registers(prog, regs),
        outputs=_probe_outputs(prog, regs),
        batch_index=b,
    )


class MachineEngine:
    """Single-stimulus engine (``core.bsp.Machine``, the chunk kernel at
    B=1). ``specialize=False`` selects the seed baseline arm. ``images`` is
    one ``(reg_init, spad_init, gmem_init)`` stimulus plane
    (``Program.init_images``); omitted means the program's base init."""

    kind = "machine"
    batch = 1

    def __init__(self, program: Program, *, device=None,
                 specialize: bool = True, compact: bool = True,
                 chunk: int = DEFAULT_CHUNK,
                 images: Optional[Images] = None):
        self.program = program
        self.m = Machine(program, device=device, compact=compact,
                         chunk=chunk, specialize=specialize)
        self._images = images
        self.reset()

    def reset(self) -> None:
        self.state = self.m.init_state(self._images)

    def run(self, num_cycles: int) -> RunResult:
        self.state = self.m.run(self.state, num_cycles)
        return _snapshot(self, 0)

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        return [self.run(num_cycles)]

    def _regs_np(self, b: int) -> np.ndarray:
        return from_words(self.state.regs)

    def read_reg(self, name: str, b: int = 0) -> int:
        return self.m.read_reg(self.state, name)

    def read_output(self, name: str, b: int = 0) -> int:
        return self.m.read_output(self.state, name)

    def exceptions(self, b: int = 0) -> Dict[int, int]:
        return self.m.exceptions(self.state)

    def perf(self, b: Optional[int] = None) -> Dict[str, float]:
        return self.m.perf(self.state)


class BatchedEngine:
    """B stimuli per launch (``core.bsp.BatchedMachine``)."""

    kind = "batched"

    def __init__(self, program: Program, *,
                 images: Optional[Sequence[Images]] = None,
                 batch: Optional[int] = None, device=None,
                 compact: bool = True, chunk: int = DEFAULT_CHUNK):
        self.program = program
        self.m = BatchedMachine(program, images=images, batch=batch,
                                device=device, compact=compact, chunk=chunk)
        self.batch = self.m.B
        self.reset()

    def reset(self) -> None:
        self.state = self.m.init_state()

    def rebind(self, images) -> None:
        """Swap this engine onto a new batch of stimuli (same B) and
        reset. The machine keeps its kernel tables on the card
        (``BatchedMachine.rebind_images``), so a serving layer can reuse
        one hot engine across successive coalesced batches."""
        self.m.rebind_images(images)
        self.batch = self.m.B
        self.reset()

    def run(self, num_cycles: int) -> RunResult:
        self.state = self.m.run(self.state, num_cycles)
        return _snapshot(self, 0)

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        t0 = time.perf_counter()
        self.state = self.m.run(self.state, num_cycles)
        regs = from_words(self.state.regs)
        # seconds of the chunks and of the registers' copy to the host,
        # which waits for the device; the rest of the call is snapshots
        self.chunks_s = time.perf_counter() - t0
        return [_snapshot(self, b, regs[b]) for b in range(self.batch)]

    def _regs_np(self, b: int) -> np.ndarray:
        return from_words(self.state.regs[b])

    def read_reg(self, name: str, b: int = 0) -> int:
        return self.m.read_reg(self.state, name, b)

    def read_output(self, name: str, b: int = 0) -> int:
        return self.m.read_output(self.state, name, b)

    def exceptions(self, b: int = 0) -> Dict[int, int]:
        return self.m.exceptions(self.state, b)

    def perf(self, b: Optional[int] = None) -> Dict[str, float]:
        return self.m.perf(self.state, b)


class ShardedBatchedEngine(BatchedEngine):
    """B stimuli data-parallel over a list of devices
    (``core.bsp.ShardedBatchedMachine``): each of D devices runs B/D
    elements of the same compiled Program; per-element exceptions are
    shard-local and results (``RunResult`` per stimulus) are reassembled
    across shards by the inherited accessors — padding elements (B not a
    multiple of D) never appear in them."""

    kind = "sharded"

    def __init__(self, program: Program, *,
                 images: Optional[Sequence[Images]] = None,
                 batch: Optional[int] = None, devices=None,
                 compact: bool = True, chunk: int = DEFAULT_CHUNK):
        self.program = program
        self.m = ShardedBatchedMachine(program, images=images, batch=batch,
                                       devices=devices, compact=compact,
                                       chunk=chunk)
        self.batch = self.m.B
        self.reset()

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        t0 = time.perf_counter()
        self.state = self.m.run(self.state, num_cycles)
        regs = from_words(torch.cat([r.cpu() for r in self.state.regs]))
        self.chunks_s = time.perf_counter() - t0
        return [_snapshot(self, b, regs[b]) for b in range(self.batch)]

    def _regs_np(self, b: int) -> np.ndarray:
        return from_words(self.m.element(self.state, b).regs)


class GridEngine:
    """Core-sharded multi-device engine (``core.grid.GridMachine``).

    ``images=None`` runs the program's base stimulus; a list of image
    tuples selects batched mode (each state leaf gains a ``[B]`` axis,
    still sharded over the devices of ``mesh``). The state is copied to
    the host once after each run, and the probes read that copy.
    """

    kind = "grid"

    def __init__(self, program: Program, mesh, *,
                 images: Optional[Sequence[Images]] = None,
                 chunk: int = DEFAULT_CHUNK):
        self.program = program
        self.m = GridMachine(program, mesh, images=images, chunk=chunk)
        self.batch = self.m.B or 1
        self._batched = self.m.B is not None
        self.reset()

    def reset(self) -> None:
        self.state = self.m.init_state()
        self._host = None

    def _h(self):
        if self._host is None:
            self._host = self.m.gather(self.state)
        return self._host

    def run(self, num_cycles: int) -> RunResult:
        self.state = self.m.run(self.state, num_cycles)
        self._host = None
        return _snapshot(self, 0)

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        self.state = self.m.run(self.state, num_cycles)
        self._host = None
        return [_snapshot(self, b) for b in range(self.batch)]

    def _b(self, b: int):
        return b if self._batched else None

    def _regs_np(self, b: int) -> np.ndarray:
        return self.m._elem(self._h().regs, self._b(b))

    def read_reg(self, name: str, b: int = 0) -> int:
        return self.m.read_reg(self._h(), name, self._b(b))

    def read_output(self, name: str, b: int = 0) -> int:
        return self.m.read_output(self._h(), name, self._b(b))

    def exceptions(self, b: int = 0) -> Dict[int, int]:
        return self.m.exceptions(self._h(), self._b(b))

    def perf(self, b: Optional[int] = None) -> Dict[str, float]:
        return self.m.perf(self._h(), b if self._batched else None)


class IsaEngine:
    """Vectorized numpy ISA simulator (``core.isasim.IsaSim``) — the
    second oracle, with the same probes as the kernel engines (``IsaSim``
    itself has no ``read_output``/``perf``; the adapter derives them from
    the program's tables)."""

    kind = "isa"
    batch = 1

    def __init__(self, program: Program, *,
                 images: Optional[Images] = None):
        self.program = program
        self._images = images
        self.reset()

    def reset(self) -> None:
        # the stimulus's images as the program's own init, so that IsaSim
        # runs a pipelined Program's prologue (iteration 0's hoisted pure
        # ops) on them, as the kernel engines do. The reference's adapter
        # overwrites the state after the prologue ran on the base image
        # (ROADMAP queue C).
        prog = self.program
        if self._images is not None:
            ri, si, gi = self._images
            prog = dataclasses.replace(prog, reg_init=np.asarray(ri),
                                       spad_init=np.asarray(si),
                                       gmem_init=np.asarray(gi))
        self.sim = IsaSim(prog)

    def run(self, num_cycles: int) -> RunResult:
        self.sim.run(num_cycles)
        return _snapshot(self, 0)

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        return [self.run(num_cycles)]

    def _regs_np(self, b: int) -> np.ndarray:
        return self.sim.regs

    def read_reg(self, name: str, b: int = 0) -> int:
        return self.sim.read_reg(name)

    def read_output(self, name: str, b: int = 0) -> int:
        return _probe_outputs(self.program, self.sim.regs)[name]

    def exceptions(self, b: int = 0) -> Dict[int, int]:
        return self.sim.exceptions()

    def perf(self, b: Optional[int] = None) -> Dict[str, float]:
        return {"vcycles": self.sim.cycle,
                "machine_cycles": self.sim.cycle * self.program.vcpl}


class OracleEngine:
    """The reference netlist interpreter (``core.interpreter.NetlistSim``).

    The only engine driven by the *circuit* rather than the compiled
    binary — it needs no Program, but when one is supplied its
    ``state_regs``/``outputs`` maps choose which probes land in the
    :class:`RunResult`, so oracle results compare directly with the
    compiled engines'. Exceptions carry no core, so they are keyed by
    negative pseudo-cores (``ORACLE_CORE - k``).
    """

    kind = "oracle"
    batch = 1

    def __init__(self, circuit: Circuit,
                 program: Optional[Program] = None):
        self.circuit = circuit
        self.program = program
        self.reset()

    def reset(self) -> None:
        self.sim = NetlistSim(self.circuit)
        self._exc: List[int] = []
        self._outputs: Dict[str, int] = {}

    def run(self, num_cycles: int) -> RunResult:
        for _ in range(num_cycles):
            if self._exc:
                break
            r = self.sim.step()
            self._outputs.update(r.outputs)
            self._exc.extend(r.exceptions)
        prog = self.program
        reg_names = (prog.state_regs.keys() if prog is not None
                     else self.sim.c.reg_names.values())
        out_names = (prog.outputs.keys() if prog is not None
                     else self._outputs.keys())
        return RunResult(
            cycles=self.sim.cycle, exceptions=self.exceptions(),
            perf=self.perf(),
            registers={nm: self.sim.reg_value(nm) for nm in reg_names},
            outputs={nm: self._outputs[nm] for nm in out_names
                     if nm in self._outputs})

    def run_batch(self, num_cycles: int) -> List[RunResult]:
        return [self.run(num_cycles)]

    def read_reg(self, name: str, b: int = 0) -> int:
        return self.sim.reg_value(name)

    def read_output(self, name: str, b: int = 0) -> int:
        return self._outputs[name]

    def exceptions(self, b: int = 0) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for k, eid in enumerate(dict.fromkeys(self._exc)):
            out[ORACLE_CORE - k] = eid
        return out

    def perf(self, b: Optional[int] = None) -> Dict[str, float]:
        return {"vcycles": self.sim.cycle}
