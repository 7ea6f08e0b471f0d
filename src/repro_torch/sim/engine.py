"""The ``Engine`` protocol and its adapters over the port's executors.

Port of ``repro.sim.engine``. Every adapter owns its simulation state,
``run(num_cycles)`` advances *all* stimuli and returns the
:class:`~repro_torch.sim.result.RunResult` of element 0, ``run_batch`` the
full per-stimulus list, and the probe methods take a uniform optional batch
index. ``MachineEngine`` and ``BatchedEngine`` run the CUDA chunk kernel,
``MachineEngine(specialize=False)`` the seed arm's per-Vcycle kernel
(``device="cpu"`` selects their plain versions); ``IsaEngine`` and
``OracleEngine`` are the numpy oracles.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np

from ..core.bsp import DEFAULT_CHUNK, BatchedMachine, Machine, from_words
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
        self.state = self.m.run(self.state, num_cycles)
        regs = from_words(self.state.regs)
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
        self.sim = IsaSim(self.program)
        if self._images is not None:
            ri, si, gi = self._images
            C, R = self.sim.C, self.sim.R
            self.sim.regs = np.asarray(ri)[:C, :R].astype(np.uint32).copy()
            self.sim.spads = np.asarray(si)[:C].astype(np.uint32).copy()
            self.sim.gmem = np.asarray(gi).astype(np.uint32).copy()

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
