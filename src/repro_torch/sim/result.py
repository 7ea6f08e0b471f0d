# Copy of src/repro/sim/result.py (commit aa57dc1); imports may differ.
"""Uniform run results for every simulation engine.

The five executors historically returned five different shapes: ``Machine``
hands back a ``MachineState`` tuple the caller probes with
``read_reg``/``exceptions``, ``IsaSim`` mutates itself and returns a cycle
count, ``NetlistSim`` returns ``(cycles, [CycleResult])``. A
:class:`RunResult` is the one shape the :mod:`repro.sim` front door returns
everywhere: the finish cycle, the exception map, the perf counters and the
probed architectural values, snapshotted at the moment the run stopped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet

# Exception-id conventions of repro.circuits.common: every self-checking
# bench raises FINISH (1) on success and MISMATCH (2) on a failed golden
# check. Engines that cannot attribute an exception to a core (the netlist
# oracle) report it under negative pseudo-core keys.
FINISH = 1
MISMATCH = 2
ORACLE_CORE = -1


@dataclass(frozen=True)
class RunResult:
    """Snapshot of one stimulus after a ``run`` call.

    ``cycles``
        Vcycles (simulated RTL cycles) actually executed; on an exception
        this includes the raising cycle (the machine freezes *at* it).
    ``exceptions``
        ``{core: first exception id}`` — empty when the run exhausted its
        budget cleanly. The netlist oracle, which has no cores, uses
        negative pseudo-core keys (``ORACLE_CORE - k``).
    ``perf``
        Engine performance counters; every engine reports at least
        ``vcycles``, the hardware-modelling ones add cache hits/misses,
        stall cycles and ``machine_cycles``.
    ``registers``
        Architectural (RTL-named) register probes at stop time.
    ``outputs``
        Host-visible output probes at stop time.
    ``batch_index``
        Which stimulus of a batched run this snapshot belongs to.
    """

    cycles: int
    exceptions: Dict[int, int] = field(default_factory=dict)
    perf: Dict[str, float] = field(default_factory=dict)
    registers: Dict[str, int] = field(default_factory=dict)
    outputs: Dict[str, int] = field(default_factory=dict)
    batch_index: int = 0

    @property
    def exception_ids(self) -> FrozenSet[int]:
        """Raised exception ids, core-agnostic (what parity checks compare
        across engines that locate exceptions differently)."""
        return frozenset(self.exceptions.values())

    @property
    def finished(self) -> bool:
        """True iff the run ended with the circuits' clean-FINISH id."""
        return self.exception_ids == {FINISH}

    @property
    def failed(self) -> bool:
        """True iff a golden check fired (MISMATCH raised anywhere)."""
        return MISMATCH in self.exception_ids
