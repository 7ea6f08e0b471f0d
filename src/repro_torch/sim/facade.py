"""``repro_torch.sim`` front door: compile once, simulate on the card.

Port of ``repro.sim.facade``. ``compile(source, ...)`` accepts a benchmark
*name* (``"mc"``), a built :class:`~repro_torch.circuits.common.Bench` or a
raw :class:`~repro_torch.core.netlist.Circuit`, runs (or cache-loads) the
static-BSP compiler, and returns a :class:`Simulation` that owns the
compiled :class:`~repro_torch.core.compile.Program`, remembers the source
bench (cycle budget, per-seed init planes) and hands out
protocol-conforming engines on demand::

    import repro_torch.sim as sim

    s = sim.compile("mc", seeds=range(512))   # one Program, 512 stimuli
    results = s.run()                         # BatchedEngine on the card
    assert all(r.finished for r in results)

Engine auto-selection follows the reference: a ``mesh=`` (a sequence of
devices) requests the core-sharded ``grid`` engine; a batch
(``seeds=``/``images=`` with more than one stimulus) picks the
batch-sharded ``sharded`` engine when there are D > 1 devices to shard
over and B >= 2*D (or ``shard_batch=True`` forces it) and
``BatchedEngine`` otherwise; a single stimulus gets ``MachineEngine``.
``devices=`` names the devices to shard over; without it a Simulation on
the card counts every card, and one on the CPU one device.
``engine="seed"`` runs the seed baseline arm.
``device=`` (at ``compile`` or per engine) is the torch device the kernel
engines run on; the default is the card, and ``device="cpu"`` runs the
kernel's plain PyTorch version. A device may repeat in ``mesh``/``devices``
(``["cpu"] * 8``, or ``["cuda:0"] * 4`` on one card).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from ..core.compile import Program, compile_circuit
from ..core.isa import HardwareConfig
from ..core.netlist import Circuit
from ..device import default_device_count, resolve_devices
from .artifact import load_program
from .cache import CompileCache, cache_key, resolve_cache
from .engine import (BatchedEngine, Engine, GridEngine, Images, IsaEngine,
                     MachineEngine, OracleEngine, ShardedBatchedEngine)
from .result import RunResult

# Extra Vcycles past a bench's FINISH cycle: the budget must overshoot so a
# missing exception is detected as "ran past the end", never masked.
CYCLE_SLACK = 10

# "jnp" and "pallas" name the reference's two backends of the specialized
# single-stimulus engine; the port runs both as "machine", on one kernel
_ENGINE_KINDS = ("auto", "machine", "jnp", "pallas", "seed", "batched",
                 "sharded", "grid", "isa", "oracle", "netlist", "reference")


def _auto_shard(shard_batch, B: int, devices, device) -> bool:
    """Auto-selection rule for the batch-sharded engine: an explicit
    ``shard_batch`` wins; otherwise shard when there is more than one
    device to shard over and every device gets at least two elements
    (B >= 2*D). ``devices=None`` counts the devices a Simulation on
    ``device`` shards over by default: every card
    (``torch.cuda.device_count()``) on the card, one on the CPU."""
    if shard_batch is not None:
        return bool(shard_batch)
    D = len(devices) if devices is not None else default_device_count(device)
    return D > 1 and B >= 2 * D


@dataclass
class Simulation:
    """A compiled design plus everything needed to simulate it."""

    program: Program
    bench: Optional["Bench"] = None          # noqa: F821 (circuits.common)
    circuit: Optional[Circuit] = None
    meta: Dict = field(default_factory=dict)
    device: Optional[str] = None
    # default-option engine memo per kind (see Simulation.run)
    _engines: Dict[str, Engine] = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    @property
    def n_cycles(self) -> Optional[int]:
        """The bench's self-checking FINISH cycle, when known."""
        return self.bench.n_cycles if self.bench is not None else None

    @property
    def batch(self) -> int:
        """Stimulus count carried by the source bench (1 when legacy)."""
        return self.bench.batch if self.bench is not None else 1

    @property
    def cache_hit(self) -> bool:
        return bool(self.program.stats.get("cache_hit", False))

    @property
    def fingerprint(self) -> Optional[str]:
        """Structural fingerprint of the compiled circuit — the identity the
        compile cache keys on. Recorded in ``Program.stats`` at compile
        time, so it survives artifact round-trips."""
        fp = self.meta.get("fingerprint") \
            or self.program.stats.get("fingerprint")
        if fp is None and self.circuit is not None:
            fp = self.circuit.fingerprint()
            self.meta["fingerprint"] = fp
        return fp

    def select_engine_kind(self, batch: Optional[int] = None, *,
                           mesh=None, devices=None,
                           shard_batch: Optional[bool] = None) -> str:
        """The engine kind ``engine("auto")`` resolves to — without
        constructing it. ``batch`` defaults to this Simulation's own
        stimulus count; a serving layer passes the coalesced batch size it
        is about to launch. ``devices`` stands for the devices to shard over
        (default: every card, or one device on the CPU, see
        :func:`_auto_shard`); ``shard_batch`` defaults to the value given
        at :func:`compile`."""
        if mesh is not None:
            return "grid"
        B = self.batch if batch is None else int(batch)
        if shard_batch is None:
            shard_batch = self.meta.get("shard_batch")
        if B > 1 and _auto_shard(shard_batch, B, devices, self.device):
            return "sharded"
        if B > 1:
            return "batched"
        return "machine"

    @property
    def engine_kind(self) -> str:
        """Auto-selected engine kind for this Simulation's own batch."""
        return self.select_engine_kind()

    def default_cycles(self) -> int:
        if self.n_cycles is None:
            raise ValueError(
                "this Simulation has no bench cycle budget — pass "
                "cycles= explicitly")
        return self.n_cycles + CYCLE_SLACK

    def images(self) -> Optional[List[Images]]:
        """Per-stimulus (reg, spad, gmem) init images from the bench's
        seed planes, or None for a legacy single-stimulus build."""
        if self.bench is None or self.bench.reg_planes is None:
            return None
        return self.bench.images(self.program)

    def images_stacked(self, workers: Optional[int] = None):
        """Stacked ``([B, C, R], [B, C, S], [B, G])`` init images,
        generated host-parallel — the layout the batched engine consumes
        directly (None for a legacy single-stimulus build)."""
        if self.bench is None or self.bench.reg_planes is None:
            return None
        return self.bench.images_batch(self.program, workers=workers)

    # ------------------------------------------------------------------
    def engine(self, kind: str = "auto", *, mesh=None,
               images: Optional[Sequence[Images]] = None,
               batch: Optional[int] = None, device=None,
               specialize: bool = True, shard_batch: Optional[bool] = None,
               devices=None, workers: Optional[int] = None,
               **opts) -> Engine:
        """Construct a protocol-conforming engine over this Program.

        ``kind="auto"`` resolves through :meth:`select_engine_kind` (grid
        for a ``mesh``, sharded for B >= 2*D over several devices or
        ``shard_batch=True``, batched for several stimuli, else the
        single-stimulus machine). Explicit kinds: ``machine``/``jnp``/
        ``pallas`` (the chunk kernel at B=1), ``seed`` (the unspecialized
        baseline arm, as is ``machine`` with ``specialize=False``),
        ``batched``, ``sharded`` (over ``devices``, by default those of
        ``device``: every card, or one CPU device), ``grid`` (over the
        devices of ``mesh``, which it needs), ``isa``,
        ``oracle``/``netlist``/``reference``. ``device`` overrides the
        Simulation's device for the single-device kernel engines."""
        if kind not in _ENGINE_KINDS:
            raise ValueError(
                f"unknown engine kind {kind!r}; choose from "
                f"{', '.join(_ENGINE_KINDS)}")
        if batch is not None:
            B = batch
        elif images is not None:
            B = (int(images[0].shape[0])
                 if getattr(images[0], "ndim", 0) == 3 else len(images))
        else:
            B = self.batch

        if kind == "auto":
            kind = self.select_engine_kind(B, mesh=mesh, devices=devices,
                                           shard_batch=shard_batch)
        if kind in ("oracle", "netlist", "reference"):
            if self.circuit is None:
                raise ValueError(
                    "oracle engine needs the source circuit — this "
                    "Simulation was loaded from an artifact")
            return OracleEngine(self.circuit, self.program)
        device = self.device if device is None else device
        if kind == "grid":
            if mesh is None:
                raise ValueError("grid engine needs a mesh= (a sequence of "
                                 "devices)")
            if images is None:
                images = self.images()
            return GridEngine(self.program, mesh, images=images, **opts)
        if kind == "sharded":
            if images is None:
                images = self.images_stacked(workers=workers)
            return ShardedBatchedEngine(
                self.program, images=images,
                batch=None if images is not None else B,
                devices=resolve_devices(devices, device), **opts)
        if kind == "batched":
            if images is None:
                images = self.images_stacked(workers=workers)
            return BatchedEngine(self.program, images=images,
                                 batch=None if images is not None else B,
                                 device=device, **opts)
        if images is None:
            images = self.images()
        img0 = _first_image(images)
        if kind == "isa":
            return IsaEngine(self.program, images=img0)
        if kind == "seed":
            specialize = False
        return MachineEngine(self.program, images=img0, device=device,
                             specialize=specialize, **opts)

    def run(self, cycles: Optional[int] = None, *, engine: str = "auto",
            **opts) -> Union[RunResult, List[RunResult]]:
        """Compile-free simulation in one call: build the (auto-selected)
        engine, run ``cycles`` Vcycles (default: the bench budget plus
        slack) and return the uniform result — one :class:`RunResult`, or
        a per-stimulus list when the engine is batched.

        Engines built with default options are memoized per kind (reset
        before each run); calls with explicit options construct a fresh
        engine."""
        if opts:
            eng = self.engine(engine, **opts)
        else:
            eng = self._engines.get(engine)
            if eng is None:
                eng = self._engines[engine] = self.engine(engine)
            else:
                eng.reset()
        n = cycles if cycles is not None else self.default_cycles()
        if eng.batch > 1:
            return eng.run_batch(n)
        return eng.run(n)

    # ------------------------------------------------------------------
    def save(self, path: Union[str, Path]) -> Path:
        """Persist the compiled Program (see :mod:`repro_torch.sim.artifact`;
        the format is the reference's, so either package loads it)."""
        return self.program.save(path)

    @classmethod
    def load(cls, path: Union[str, Path], device=None) -> "Simulation":
        return cls(program=load_program(path), device=device)


def _first_image(images):
    """Stimulus 0's (reg, spad, gmem) tuple from either image form."""
    if not images:
        return None
    if getattr(images[0], "ndim", 0) == 3:          # stacked arrays
        return tuple(a[0] for a in images)
    return images[0]


def _resolve_source(source, scale: str, seeds, overrides):
    """(bench, circuit) from a name / Bench / Circuit source."""
    from ..circuits import build
    from ..circuits.common import Bench
    if isinstance(source, str):
        return build(source, scale, seeds=seeds, **overrides), None
    if seeds is not None or overrides:
        raise ValueError(
            "seeds=/build overrides apply when compiling by circuit name; "
            "pass a name like sim.compile('mc', seeds=[...])")
    if isinstance(source, Bench):
        return source, None
    if isinstance(source, Circuit):
        return None, source
    raise TypeError(
        f"cannot compile {type(source).__name__}: expected a circuit "
        "name, a Bench, or a Circuit")


def compile(source, hw: Optional[HardwareConfig] = None, *,
            scale: str = "full", seeds: Optional[Sequence[int]] = None,
            optimize: bool = True, use_luts: bool = True,
            strategy: str = "balanced", sched_strategy: str = "slack",
            placement: str = "anneal", pipeline: str = "modulo",
            cache: Union[bool, str, Path, CompileCache, None] = None,
            shard_batch: Optional[bool] = None,
            device=None, **overrides) -> Simulation:
    """Compile ``source`` (benchmark name, Bench, or Circuit) into a
    :class:`Simulation` whose kernel engines run on ``device`` (default:
    the card).

    ``seeds=[s0, s1, ...]`` (name sources) builds a batched bench: one
    structural netlist, per-seed init planes, so every stimulus shares the
    compiled Program. ``cache=True`` (or a directory path) consults the
    on-disk compile cache first; on a miss the freshly compiled Program is
    stored for next time. ``shard_batch`` is kept for engine selection
    (see :meth:`Simulation.select_engine_kind`). The compiler options are
    the reference's (``repro.sim.facade.compile``); the compiled Program
    is byte-identical to the one it builds.
    """
    bench, circuit = _resolve_source(source, scale, seeds, overrides)
    if bench is not None:
        circuit = bench.circuit
    hw = hw or HardwareConfig()

    fp = circuit.fingerprint()
    cc = resolve_cache(cache)
    prog = None
    key = None
    if cc is not None:
        key = cache_key(circuit, hw, strategy=strategy, use_luts=use_luts,
                        optimize=optimize, sched_strategy=sched_strategy,
                        placement=placement, pipeline=pipeline,
                        fingerprint=fp)
        prog = cc.load(key)
    if prog is None:
        prog = compile_circuit(circuit, hw, strategy=strategy,
                               use_luts=use_luts, optimize=optimize,
                               sched_strategy=sched_strategy,
                               placement=placement, pipeline=pipeline)
        prog.stats["cache_hit"] = False
        prog.stats["fingerprint"] = fp
        if cc is not None:
            cc.store(key, prog)
    else:
        prog.stats["fingerprint"] = fp
    return Simulation(program=prog, bench=bench, circuit=circuit,
                      meta={"cache_key": key, "shard_batch": shard_batch,
                            "fingerprint": fp},
                      device=device)


def load(path: Union[str, Path], device=None) -> Simulation:
    """Load a persisted Program artifact as a ready-to-run Simulation."""
    return Simulation.load(path, device=device)
