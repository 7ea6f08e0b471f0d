# Copy of src/repro/sim/cache.py (commit aa57dc1); imports may differ.
"""On-disk compile cache: fingerprint the request, reuse the artifact.

Compilation is the expensive half of the Manticore bargain (lower → opt →
partition → lutsynth → schedule → regalloc); simulation of the resulting
static binary is the cheap half. A production service replaying the same
designs across many scenarios should pay compilation once *per design per
configuration* — across processes, not just within one.

The cache key is a SHA-256 over:

* the **circuit fingerprint** (:meth:`repro.core.netlist.Circuit.fingerprint`
  — a structural hash of nodes, memories, register init/next maps and
  latched input values; two builds of the same design collide, any
  semantic difference does not),
* every :class:`~repro.core.isa.HardwareConfig` field,
* the compiler options (``strategy``, ``use_luts``, ``optimize``,
  ``sched_strategy``, ``placement``, ``pipeline``),
* the artifact :data:`~repro.sim.artifact.FORMAT_VERSION` (a schema bump
  silently invalidates old entries — they just miss).

Entries are ordinary :mod:`repro.sim.artifact` files named ``<key>.npz``
under the cache directory (``REPRO_SIM_CACHE`` env var, default
``~/.cache/repro-sim``), so a cache entry doubles as a shareable artifact.
A loaded entry is marked ``stats["cache_hit"] = True`` — the flag the
acceptance timing checks (and ``benchmarks/bench_compile.py``'s cold/warm
rows) key on.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict
from pathlib import Path
from typing import Optional, Union

from ..core.compile import Program
from ..core.isa import HardwareConfig
from ..core.netlist import Circuit
from .artifact import FORMAT_VERSION, load_program, save_program

ENV_VAR = "REPRO_SIM_CACHE"


def default_cache_dir() -> Path:
    return Path(os.environ.get(ENV_VAR, "~/.cache/repro-sim")).expanduser()


def cache_key(circuit: Optional[Circuit], hw: HardwareConfig, *,
              strategy: str = "balanced", use_luts: bool = True,
              optimize: bool = True, sched_strategy: str = "slack",
              placement: str = "anneal", pipeline: str = "modulo",
              fingerprint: Optional[str] = None) -> str:
    """Deterministic key for one (circuit, hardware, options) request.
    ``fingerprint`` supplies a precomputed ``Circuit.fingerprint()`` (the
    facade and the serving layer hash each circuit once); without it the
    circuit is fingerprinted here."""
    payload = json.dumps({
        "format_version": FORMAT_VERSION,
        "circuit": fingerprint or circuit.fingerprint(),
        "hw": asdict(hw),
        "strategy": strategy,
        "use_luts": bool(use_luts),
        "optimize": bool(optimize),
        "sched_strategy": sched_strategy,
        "placement": placement,
        "pipeline": pipeline,
    }, sort_keys=True)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()


class CompileCache:
    """A directory of ``<key>.npz`` Program artifacts.

    **Concurrency contract (last-writer-wins, no locks).** Entries are
    published by :func:`repro.sim.artifact.save_program`, which writes to a
    uniquely-named temp file in the cache directory and ``os.replace``-s it
    over the entry — an atomic rename on POSIX and Windows. Two processes
    (or daemon workers) cold-compiling the same key therefore race
    harmlessly: each publishes a *complete* artifact, the later rename
    wins, and a concurrent :meth:`load` observes either a full old entry, a
    full new entry, or no entry — never a torn file. Determinism makes
    last-writer-wins sound: both writers compiled the same key, so the
    artifacts are interchangeable. A reader that does catch a half-state
    (entry vanishing mid-read, incompatible version) reads it as a miss and
    recompiles. ``tests/test_serve.py`` hammers this contract with
    concurrent writer/reader threads.
    """

    def __init__(self, root: Union[str, Path, None] = None):
        self.root = Path(root) if root is not None else default_cache_dir()

    def path(self, key: str) -> Path:
        return self.root / f"{key}.npz"

    def load(self, key: str) -> Optional[Program]:
        """The cached Program for ``key`` (marked ``stats['cache_hit']``),
        or None. A corrupt or version-incompatible entry reads as a miss —
        the caller recompiles and overwrites it."""
        p = self.path(key)
        if not p.is_file():
            return None
        try:
            prog = load_program(p)
        except Exception:
            return None
        prog.stats["cache_hit"] = True
        return prog

    def store(self, key: str, prog: Program) -> Path:
        return save_program(prog, self.path(key))


def resolve_cache(cache: Union[bool, str, Path, "CompileCache", None]
                  ) -> Optional[CompileCache]:
    """Normalize the facade's ``cache=`` argument: ``False``/``None``
    disables caching, ``True`` uses the default directory, a path or a
    :class:`CompileCache` selects an explicit one."""
    if cache is None or cache is False:
        return None
    if cache is True:
        return CompileCache()
    if isinstance(cache, CompileCache):
        return cache
    return CompileCache(cache)
