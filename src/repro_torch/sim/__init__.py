"""``repro_torch.sim`` — the simulation front-end of the port.

One import gives the whole workflow::

    import repro_torch.sim as sim

    s = sim.compile("rv32r", scale="small")   # or a Circuit/Bench
    result = s.run()                          # RunResult, on the card
    s.save("rv32r.npz")                       # the reference's artifact
    s2 = sim.load("rv32r.npz")                # ...reloaded

Layers: :mod:`.result` (``RunResult``), :mod:`.engine` (the ``Engine``
protocol and its adapters), :mod:`.artifact` (versioned ``.npz``
Programs), :mod:`.cache` (the on-disk compile cache) and :mod:`.facade`
(``compile``, ``load`` and ``Simulation``).
"""
from .artifact import FORMAT_VERSION, load_program, save_program
from .cache import CompileCache, cache_key, default_cache_dir
from .engine import (BatchedEngine, Engine, IsaEngine, MachineEngine,
                     OracleEngine)
from .facade import CYCLE_SLACK, Simulation, compile, load
from .result import FINISH, MISMATCH, RunResult

__all__ = [
    "compile", "load", "Simulation", "RunResult", "Engine",
    "MachineEngine", "BatchedEngine", "IsaEngine", "OracleEngine",
    "save_program", "load_program", "FORMAT_VERSION",
    "CompileCache", "cache_key", "default_cache_dir",
    "FINISH", "MISMATCH", "CYCLE_SLACK",
]
