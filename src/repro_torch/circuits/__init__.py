# Copy of src/repro/circuits/__init__.py (commit aa57dc1); imports may differ.
"""The paper's nine evaluation benchmarks (§7.5) as circuit generators.

Each builder returns a self-checking :class:`~repro.circuits.common.Bench`:
the circuit raises exception id 1 (FINISH) at ``bench.n_cycles`` when every
golden check passed, and id 2 (MISMATCH) one cycle earlier otherwise.

``full`` builds the evaluation-scale versions; ``small`` builds reduced
variants for oracle-vs-engine differential tests.
"""
from __future__ import annotations

from typing import Callable, Dict

from .common import Bench, FINISH, MISMATCH
from .compute import build_bc, build_cgra, build_mc, build_mm
from .memory import build_blur, build_jpeg, build_vta
from .network import build_noc, build_rv32r

CIRCUITS: Dict[str, Callable[..., Bench]] = {
    "bc": build_bc,
    "mm": build_mm,
    "mc": build_mc,
    "cgra": build_cgra,
    "vta": build_vta,
    "blur": build_blur,
    "jpeg": build_jpeg,
    "noc": build_noc,
    "rv32r": build_rv32r,
}

# evaluation-scale parameters (compile times stay in seconds; the paper's
# exact RTL is not reproducible without its Verilog sources, so sizes are
# chosen to preserve each benchmark's *character*: relative step size,
# parallelism profile and memory behaviour)
FULL_PARAMS: Dict[str, Dict] = {
    "bc": dict(n_cycles=64, n_pipes=4),
    "mm": dict(n=16),
    "mc": dict(n_walkers=32, n_cycles=128),
    "cgra": dict(rows=8, cols=8, n_cycles=96),
    "vta": dict(n_cycles=256, depth=256, acc_depth=64, lanes=4),
    "blur": dict(n_cycles=256, width=32),
    "jpeg": dict(n_cycles=512),
    "noc": dict(rows=4, cols=4, n_cycles=200),
    "rv32r": dict(n_cores=16, n_cycles=128),
}

SMALL_PARAMS: Dict[str, Dict] = {
    "bc": dict(n_cycles=24, n_pipes=1),
    "mm": dict(n=4),
    "mc": dict(n_walkers=4, n_cycles=32),
    "cgra": dict(rows=2, cols=2, n_cycles=24),
    "vta": dict(n_cycles=48, depth=64, acc_depth=16, lanes=2),
    "blur": dict(n_cycles=48, width=8),
    "jpeg": dict(n_cycles=48),
    "noc": dict(rows=2, cols=2, n_cycles=32),
    "rv32r": dict(n_cores=4, n_cycles=32),
}


SCALES = ("full", "small")


def build(name: str, scale: str = "full", seeds=None, **overrides) -> Bench:
    """Build one benchmark. ``seeds=[s0, s1, ...]`` requests a *batched*
    bench: one structural netlist (that of ``s0``) plus per-seed init
    planes (``bench.reg_planes``/``bench.mem_planes``) so a single compiled
    Program can simulate every stimulus at once (``core.bsp.BatchedMachine``
    — or, one level up, ``repro.sim.compile(name, seeds=[...])``).
    """
    if name not in CIRCUITS:
        raise KeyError(
            f"unknown circuit {name!r}: available circuits are "
            f"{', '.join(sorted(CIRCUITS))} (scales: {', '.join(SCALES)})")
    if scale not in SCALES:
        raise KeyError(
            f"unknown scale {scale!r} for circuit {name!r}: valid scales "
            f"are {', '.join(SCALES)}")
    params = dict(FULL_PARAMS[name] if scale == "full"
                  else SMALL_PARAMS[name])
    params.update(overrides)
    if seeds is not None:
        params["seeds"] = list(seeds)
    return CIRCUITS[name](**params)
