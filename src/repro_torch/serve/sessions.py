"""Session/cache manager: hot compiled ``Simulation``s, LRU-evicted.

Port of ``repro.serve.sessions``. What changed is the device: a
:class:`SessionManager` resolves it once, when it is built (the card by
default; ``device="cpu"`` runs the kernels' plain versions), and every
session it compiles runs its engines there. Without a card and without
``device="cpu"`` the manager raises at construction. A request cannot
pick the device.

A *session* is one design the daemon can simulate without compiling:
``(circuit fingerprint, hardware config, compiler knobs)`` → a compiled
:class:`~repro_torch.sim.facade.Simulation` plus the device-resident engines
built over it. Sessions are what make the service economics work — the
Manticore bargain is "compile once, simulate forever", and a long-lived
daemon is where "forever" actually accumulates.

**Canonical identity.** Some builders bake ``seeds[0]``-derived values
into the *structure* (mm's ROM matrices, cgra's weights, rv32r's
instruction immediates), so the fingerprint of ``build(name, seeds=[s])``
is seed-dependent in general. The service therefore anchors every design
to a canonical build — ``build(name, scale, seeds=[CANONICAL_SEED])`` —
and defines a request's stimulus as *seed s of the canonical design*:
per-batch init planes come from ``build(name, scale,
seeds=[CANONICAL_SEED, s1, ..., sB])``, whose structure is exactly the
canonical one (live-plane builds take structure from ``seeds[0]``), so
every plane patches the one compiled Program. Requests that share the
canonical fingerprint (plus hw + knobs) coalesce; for builders whose
structure is seed-invariant (bc, mc, ...) the results are additionally
bit-exact against an independent ``sim.compile(name, seeds=[s]).run()``.

**Warm starts.** Compilation goes through :func:`repro_torch.sim.compile` with
the on-disk compile cache, so a restarted daemon (or an LRU-evicted
session being re-admitted) pays an artifact load, not a recompile.
Concurrent workers asking for the same uncompiled session serialize on a
per-identity ``asyncio.Lock`` — one compile, everyone shares it; across
*processes* the cache's atomic-rename last-writer-wins contract holds
(see :class:`repro_torch.sim.cache.CompileCache`).

**Eviction.** Sessions are kept in an ``OrderedDict`` LRU bounded by
``max_sessions`` and by ``memory_budget`` bytes (the sum of each
session's program arrays plus its resident engines' state estimate) —
the stand-in for device memory on interpret-mode CPU, and the real
constraint on an accelerator.

**Quarantine.** Each session *identity* — the ``(circuit, scale, hw,
options)`` tuple, before it ever resolves to a fingerprint — carries a
:class:`CircuitBreaker`. Consecutive compile or launch failures open it:
further requests for that identity fast-fail with :class:`Unavailable`
(the daemon answers ``UNAVAILABLE`` + ``retry_after_s``) instead of
re-paying the failing compile or convoying the device behind a broken
build. After a cooldown the breaker goes **half-open** and admits one
probe; a successful compile/launch closes it, a failed probe re-opens it
with doubled cooldown. Breaker state is part of the
:meth:`SessionManager.stats` snapshot.
"""
from __future__ import annotations

import asyncio
import json
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..circuits import build
from ..core.isa import HardwareConfig
from ..device import resolve_device
from ..sim import facade
from ..sim.cache import CompileCache, resolve_cache
from . import faults as faultlib
from .protocol import SimRequest

# the structural anchor: every session's netlist/planes are built with
# this as seeds[0] (see module docstring)
CANONICAL_SEED = 0

# compiler knobs a request may set; anything else is a client error
COMPILE_OPTIONS = frozenset(
    ("optimize", "use_luts", "strategy", "sched_strategy", "placement",
     "pipeline"))

# per-session bound on memoized per-seed init planes (host memory)
MAX_PLANE_CACHE = 4096


class Unavailable(Exception):
    """The identity's circuit breaker is open: fast-fail, retry later."""

    def __init__(self, retry_after: float, state: str):
        super().__init__(
            f"session quarantined (breaker {state}); "
            f"retry in {retry_after:.2f}s")
        self.retry_after = float(retry_after)
        self.state = state


class CompileFailed(Exception):
    """The session compile raised — distinct from a bad request (unknown
    circuit/option), which never trips the breaker."""

    def __init__(self, cause: BaseException):
        super().__init__(f"compile failed: {cause!r}")
        self.cause = cause


class CircuitBreaker:
    """Closed → (``threshold`` consecutive failures) → open →
    (``cooldown_s``) → half-open, one probe → closed or re-open.

    Single-event-loop use: ``allow()`` admits, ``record_success()`` /
    ``record_failure()`` report outcomes. Re-opens double the cooldown up
    to ``cooldown_max_s`` so a persistently broken identity backs off; a
    half-open probe that never reports (e.g. its rider timed out in the
    queue) is replaced after ``cooldown_s`` rather than wedging the
    identity in half-open forever.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 1.0,
                 cooldown_max_s: float = 60.0):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self.state = self.CLOSED
        self.failures = 0          # consecutive
        self.opens = 0             # lifetime re-opens (scales cooldown)
        self._open_until = 0.0
        self._probe_started: Optional[float] = None

    def _cooldown(self) -> float:
        return min(self.cooldown_s * (2 ** max(self.opens - 1, 0)),
                   self.cooldown_max_s)

    def allow(self) -> Tuple[bool, float]:
        """(admitted, retry_after_s). Admission from OPEN past the
        cooldown transitions to HALF_OPEN and marks the caller as the
        probe."""
        now = time.monotonic()
        if self.state == self.CLOSED:
            return True, 0.0
        if self.state == self.OPEN:
            if now < self._open_until:
                return False, self._open_until - now
            self.state = self.HALF_OPEN
            self._probe_started = now
            return True, 0.0
        # HALF_OPEN: one probe at a time, but a stale probe (rider lost
        # to a queue timeout) must not wedge the identity
        if (self._probe_started is not None
                and now - self._probe_started >= self.cooldown_s):
            self._probe_started = now
            return True, 0.0
        return False, max(self.cooldown_s / 4, 0.01)

    def record_success(self) -> None:
        self.state = self.CLOSED
        self.failures = 0
        self.opens = 0
        self._probe_started = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN or self.failures >= self.threshold:
            self.state = self.OPEN
            self.opens += 1
            self._open_until = time.monotonic() + self._cooldown()
            self._probe_started = None

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "failures": self.failures,
            "opens": self.opens,
            "retry_after_s": max(self._open_until - time.monotonic(), 0.0)
            if self.state == self.OPEN else 0.0,
        }


@dataclass(frozen=True)
class SessionKey:
    """What the daemon coalesces on: same design, same hardware, same
    compiler knobs → same compiled Program → one batched launch."""
    fingerprint: str
    hw_key: str
    options_key: str


def _hw_from(req: SimRequest) -> HardwareConfig:
    return HardwareConfig(**req.hw) if req.hw else HardwareConfig()


def _options_from(req: SimRequest) -> Dict[str, Any]:
    opts = dict(req.options or {})
    unknown = set(opts) - COMPILE_OPTIONS
    if unknown:
        raise ValueError(
            f"unknown compile options {sorted(unknown)}; valid options are "
            f"{sorted(COMPILE_OPTIONS)}")
    return opts


class Session:
    """One hot design: compiled Simulation + plane cache + engine cache."""

    def __init__(self, key: SessionKey, name: str, scale: str,
                 hw: HardwareConfig, options: Dict[str, Any],
                 sim: "facade.Simulation"):
        self.key = key
        self.name = name
        self.scale = scale
        self.hw = hw
        self.options = dict(options)
        self.sim = sim
        self.last_used = time.monotonic()
        self.launches = 0
        # the identity's CircuitBreaker; assigned by the SessionManager
        # (launch outcomes reported by the daemon feed it)
        self.breaker: Optional[CircuitBreaker] = None
        # seed -> (reg_plane, mem_plane), LRU-bounded
        self._planes: "OrderedDict[int, Tuple[Dict, Dict]]" = OrderedDict()
        # (engine kind, B) -> hot engine, images rebound per batch
        self._engines: Dict[Tuple[str, int], Any] = {}
        self.engines_built = 0           # engine_for calls that built one

    # ------------------------------------------------------------------
    def touch(self) -> None:
        self.last_used = time.monotonic()

    def default_cycles(self) -> int:
        return self.sim.default_cycles()

    @property
    def fingerprint(self) -> str:
        return self.key.fingerprint

    # ------------------------------------------------------------------
    def planes_for(self, seeds: List[int]) -> Tuple[List[Dict], List[Dict]]:
        """Per-seed init planes for ``seeds``, memoized. Missing seeds are
        produced by one netlist build anchored on the canonical seed
        (structure identical to the compiled Program's), which is pure
        host-side Python — no compilation."""
        missing = [s for s in dict.fromkeys(seeds) if s not in self._planes]
        if missing:
            bench = build(self.name, self.scale,
                          seeds=[CANONICAL_SEED] + missing)
            for i, s in enumerate(missing):
                self._planes[s] = (bench.reg_planes[i + 1],
                                   bench.mem_planes[i + 1])
        for s in seeds:
            self._planes.move_to_end(s)
        while len(self._planes) > MAX_PLANE_CACHE:
            self._planes.popitem(last=False)
        return ([self._planes[s][0] for s in seeds],
                [self._planes[s][1] for s in seeds])

    def images_for(self, seeds: List[int], workers: Optional[int] = None):
        """Stacked ``[B, ...]`` init images for one coalesced batch."""
        reg_planes, mem_planes = self.planes_for(seeds)
        return self.sim.program.init_images_batch(reg_planes, mem_planes,
                                                  workers=workers)

    def engine_for(self, kind: str, images):
        """A hot engine of ``kind`` for this batch shape: cached per
        (kind, B) and rebound onto the new images (no retrace); first use
        of a shape constructs (and traces) it once."""
        B = int(images[0].shape[0])
        eng = self._engines.get((kind, B))
        if eng is None:
            eng = self.sim.engine(kind, images=images)
            self._engines[(kind, B)] = eng
            self.engines_built += 1
        else:
            eng.rebind(images)
        return eng

    # ------------------------------------------------------------------
    def nbytes(self) -> int:
        """Resident-memory estimate: program arrays + per-engine batched
        state (the device-budget currency the manager evicts on)."""
        p = self.sim.program
        base = sum(getattr(p, f).nbytes for f in
                   ("code", "luts", "reg_init", "spad_init", "gmem_init"))
        per_elem = (p.reg_init.nbytes + p.spad_init.nbytes
                    + p.gmem_init.nbytes) * 4 // 2   # u16 images → u32 state
        for (_, B) in self._engines:
            base += B * per_elem
        return base


class SessionManager:
    """LRU of compiled sessions behind one async front.

    ``cache`` is the on-disk compile cache argument
    (:func:`repro_torch.sim.cache.resolve_cache` forms: True = default dir,
    a path, a :class:`CompileCache`, or None/False to disable warm starts).
    ``device`` is where every session's engines run: the card when None
    (raising here when there is none), or e.g. ``"cpu"``.
    """

    def __init__(self, *, cache=True, max_sessions: int = 8,
                 memory_budget: Optional[int] = None,
                 faults: Optional["faultlib.FaultPlan"] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 compile_retries: int = 2,
                 compile_backoff_s: float = 0.02, device=None):
        self.device = resolve_device(device)
        self.cache: Optional[CompileCache] = resolve_cache(cache)
        self.max_sessions = int(max_sessions)
        self.memory_budget = memory_budget
        self.faults = faults
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.compile_retries = int(compile_retries)
        self.compile_backoff_s = float(compile_backoff_s)
        self._sessions: "OrderedDict[SessionKey, Session]" = OrderedDict()
        # (name, scale, hw_key, options_key) -> canonical fingerprint
        self._fingerprints: Dict[Tuple, str] = {}
        self._locks: Dict[Tuple, asyncio.Lock] = {}
        self._breakers: Dict[Tuple, CircuitBreaker] = {}
        self.counters: Dict[str, int] = {
            "compiles": 0, "cache_hits": 0, "evictions": 0, "lookups": 0,
            "compile_failures": 0, "unavailable": 0}

    # ------------------------------------------------------------------
    def _lock(self, ident: Tuple) -> asyncio.Lock:
        lock = self._locks.get(ident)
        if lock is None:
            lock = self._locks[ident] = asyncio.Lock()
        return lock

    def breaker_for(self, ident: Tuple) -> CircuitBreaker:
        br = self._breakers.get(ident)
        if br is None:
            br = self._breakers[ident] = CircuitBreaker(
                threshold=self.breaker_threshold,
                cooldown_s=self.breaker_cooldown_s)
        return br

    async def get(self, req: SimRequest) -> Session:
        """The (possibly freshly compiled) session for ``req``.

        Raises ``KeyError``/``ValueError`` for unknown circuits/scales/
        options (bad requests — never counted by the breaker),
        :class:`Unavailable` when the identity's breaker is open, and
        :class:`CompileFailed` when the compile itself raised (counted;
        transient injected faults are retried ``compile_retries`` times
        first)."""
        self.counters["lookups"] += 1
        hw = _hw_from(req)
        options = _options_from(req)
        hw_key = json.dumps(req.hw or {}, sort_keys=True)
        options_key = json.dumps(options, sort_keys=True)
        ident = (req.circuit, req.scale, hw_key, options_key)

        breaker = self.breaker_for(ident)
        allowed, retry_after = breaker.allow()
        if not allowed:
            self.counters["unavailable"] += 1
            raise Unavailable(retry_after, breaker.state)

        # fast path: fingerprint known and session resident
        fp = self._fingerprints.get(ident)
        if fp is not None:
            sess = self._sessions.get(
                SessionKey(fp, hw_key, options_key))
            if sess is not None:
                self._sessions.move_to_end(sess.key)
                sess.touch()
                return sess

        async with self._lock(ident):
            # re-check under the lock: a concurrent worker may have
            # compiled this session while we waited
            fp = self._fingerprints.get(ident)
            if fp is not None:
                sess = self._sessions.get(SessionKey(fp, hw_key,
                                                     options_key))
                if sess is not None:
                    self._sessions.move_to_end(sess.key)
                    sess.touch()
                    return sess
            sess = await self._compile_with_retry(
                breaker, req.circuit, req.scale, hw, hw_key, options,
                options_key)
            sess.breaker = breaker
            self._fingerprints[ident] = sess.key.fingerprint
            self._sessions[sess.key] = sess
            self.counters["compiles"] += 1
            if sess.sim.cache_hit:
                self.counters["cache_hits"] += 1
            breaker.record_success()
            self._evict()
            return sess

    async def _compile_with_retry(self, breaker: CircuitBreaker,
                                  name: str, scale: str,
                                  hw: HardwareConfig, hw_key: str,
                                  options: Dict[str, Any],
                                  options_key: str) -> Session:
        """Compile on a worker thread; transient faults retry with
        backoff, terminal failures count against the breaker."""
        delay = self.compile_backoff_s
        attempt = 0
        while True:
            try:
                return await asyncio.to_thread(
                    self._compile, name, scale, hw, hw_key, options,
                    options_key)
            except (KeyError, ValueError, TypeError):
                # bad request (unknown circuit/scale/knob value): the
                # identity is not broken, the request is
                raise
            except Exception as exc:
                if (getattr(exc, "transient", False)
                        and attempt < self.compile_retries):
                    attempt += 1
                    await asyncio.sleep(delay)
                    delay *= 2
                    continue
                self.counters["compile_failures"] += 1
                breaker.record_failure()
                raise CompileFailed(exc) from exc

    def _compile(self, name: str, scale: str, hw: HardwareConfig,
                 hw_key: str, options: Dict[str, Any],
                 options_key: str) -> Session:
        """Blocking compile (runs on a worker thread): canonical bench →
        facade compile through the on-disk cache."""
        if self.faults is not None:
            self.faults.check(faultlib.COMPILE, detail=f"{name}/{scale}")
        bench = build(name, scale, seeds=[CANONICAL_SEED])
        sim = facade.compile(bench, hw, cache=self.cache,
                             device=self.device, **options)
        key = SessionKey(sim.fingerprint, hw_key, options_key)
        return Session(key, name, scale, hw, options, sim)

    def _evict(self) -> None:
        def over() -> bool:
            if len(self._sessions) > self.max_sessions:
                return True
            if self.memory_budget is not None:
                total = sum(s.nbytes() for s in self._sessions.values())
                return total > self.memory_budget
            return False

        while len(self._sessions) > 1 and over():
            self._sessions.popitem(last=False)
            self.counters["evictions"] += 1

    # ------------------------------------------------------------------
    def resident(self) -> List[SessionKey]:
        return list(self._sessions)

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self._sessions.values())

    def stats(self) -> Dict[str, Any]:
        """Introspection snapshot: counters, residency, and per-identity
        breaker state (the serving dashboard / drill assertion surface)."""
        return {
            "counters": dict(self.counters),
            "resident": len(self._sessions),
            "nbytes": self.nbytes(),
            "breakers": {
                f"{ident[0]}/{ident[1]}": br.snapshot()
                for ident, br in self._breakers.items()},
        }
