# Copy of src/repro/serve/faults.py (commit 066216e); imports may differ.
"""Deterministic fault injection for the serving stack.

Partial failure is the steady state of a large deployment (Parendi runs
the same BSP model thousand-way), so every recovery path in
:mod:`repro.serve` — batch-retry bisection, the session circuit breaker,
graceful drain — must be *testable on demand*, not only observable in
production. This module is the harness: a :class:`FaultPlan` describes,
per fault **site**, when an :class:`InjectedFault` should be raised, and
the serve layers call :meth:`FaultPlan.check` at exactly four places:

========== =========================================================
site        where the check runs
========== =========================================================
COMPILE     ``SessionManager._compile`` (worker thread), before the
            facade compile — models toolchain/OOM compile failures
IMAGE_BUILD ``SimServer`` before per-batch init-image stacking —
            models host-side stimulus build failures
LAUNCH      ``SimServer`` under the device lock, before the engine
            runs — models device resets, XLA launch errors, and
            **poisoned stimuli** (``poison_seeds``)
TCP_WRITE   the per-connection writer — models a client that
            disconnected mid-response (broken pipe)
========== =========================================================

Determinism: probabilistic fires draw from one seeded
``random.Random`` under a lock, so a given ``(seed, traffic)`` pair
replays the same fault sequence — the chaos drill
(``python -m repro.serve --chaos-drill N``) relies on this to be a
reproducible CI gate rather than a flake generator. ``poison_seeds``
fires are *stateless* (any launch whose batch contains a poisoned seed
fails), which is what gives bisection a fixed point to isolate.

Zero overhead when disabled: the serve layers hold ``faults=None`` by
default and guard every check with ``if faults is not None`` — no plan,
no call, no branch beyond the None test.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Optional

# fault sites (the only strings FaultPlan accepts)
COMPILE = "compile"
IMAGE_BUILD = "image_build"
LAUNCH = "launch"
TCP_WRITE = "tcp_write"
SITES = (COMPILE, IMAGE_BUILD, LAUNCH, TCP_WRITE)


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultPlan.check` at an armed site.

    ``transient`` is the retry contract: the daemon's retry/backoff loop
    only re-attempts an identical launch for transient faults;
    non-transient faults go straight to bisection (batches) or a
    terminal ERROR (singletons). ``poisoned`` carries the seeds whose
    presence triggered a poison fire (empty for probabilistic fires).
    """

    def __init__(self, site: str, message: str, *, transient: bool = False,
                 poisoned: Iterable[int] = ()):
        super().__init__(message)
        self.site = site
        self.transient = bool(transient)
        self.poisoned = tuple(poisoned)


@dataclass(frozen=True)
class FaultSpec:
    """Arming of one site.

    ``p`` — per-check fire probability; ``times`` caps the total number
    of probabilistic fires (None = unlimited) so transient storms dry up
    deterministically; ``transient`` marks fires as retryable;
    ``poison_seeds`` (LAUNCH only) fires — statelessly, independent of
    ``p``/``times`` — whenever the checked batch contains one of these
    seeds.
    """
    p: float = 0.0
    times: Optional[int] = None
    transient: bool = False
    poison_seeds: FrozenSet[int] = field(default_factory=frozenset)

    @property
    def armed(self) -> bool:
        return self.p > 0.0 or bool(self.poison_seeds)


class FaultPlan:
    """Seedable per-site fault schedule. Thread-safe (COMPILE checks run
    on compile worker threads)."""

    def __init__(self, seed: int = 0, *, compile: Optional[FaultSpec] = None,
                 image_build: Optional[FaultSpec] = None,
                 launch: Optional[FaultSpec] = None,
                 tcp_write: Optional[FaultSpec] = None):
        self._specs: Dict[str, FaultSpec] = {
            COMPILE: compile or FaultSpec(),
            IMAGE_BUILD: image_build or FaultSpec(),
            LAUNCH: launch or FaultSpec(),
            TCP_WRITE: tcp_write or FaultSpec(),
        }
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._fired: Dict[str, int] = {s: 0 for s in SITES}
        self._checked: Dict[str, int] = {s: 0 for s in SITES}

    @classmethod
    def chaos(cls, seed: int = 0, p: float = 0.2,
              poison_seeds: Iterable[int] = ()) -> "FaultPlan":
        """The aggressive all-sites plan the chaos drill runs under:
        transient probabilistic faults at every site (so retries can
        succeed) plus optional deterministic launch poison."""
        return cls(
            seed,
            compile=FaultSpec(p=p, transient=True),
            image_build=FaultSpec(p=p, transient=True),
            launch=FaultSpec(p=p, transient=True,
                             poison_seeds=frozenset(poison_seeds)),
            tcp_write=FaultSpec(p=p))

    # ------------------------------------------------------------------
    def spec(self, site: str) -> FaultSpec:
        return self._specs[site]

    def check(self, site: str, *, seeds: Optional[Iterable[int]] = None,
              detail: str = "") -> None:
        """Raise :class:`InjectedFault` if ``site`` fires for this call.

        Poison fires (LAUNCH + ``poison_seeds`` ∩ ``seeds``) are checked
        first and are deterministic; probabilistic fires consume one RNG
        draw per armed check and honour the ``times`` cap.
        """
        spec = self._specs[site]
        with self._lock:
            self._checked[site] += 1
            if site == LAUNCH and spec.poison_seeds and seeds is not None:
                hit = [s for s in seeds if s in spec.poison_seeds]
                if hit:
                    self._fired[site] += 1
                    raise InjectedFault(
                        site, f"injected poison stimulus (seeds {hit})",
                        transient=False, poisoned=hit)
            if spec.p <= 0.0:
                return
            if spec.times is not None and self._fired[site] >= spec.times:
                return
            if self._rng.random() < spec.p:
                self._fired[site] += 1
                raise InjectedFault(
                    site,
                    f"injected {site} fault"
                    + (f" ({detail})" if detail else ""),
                    transient=spec.transient)

    # ------------------------------------------------------------------
    def fired(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._fired)

    def checked(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._checked)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"fired": dict(self._fired),
                    "checked": dict(self._checked)}
