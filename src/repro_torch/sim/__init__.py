"""``repro_torch.sim`` — the simulation front-end of the port.

One import gives the whole workflow::

    import repro_torch.sim as sim

    s = sim.compile("rv32r", scale="small")   # or a Circuit/Bench
    result = s.run()                          # RunResult, on the card
    grid = s.run(engine="grid", mesh=["cuda:0"] * 4)   # cores over shards
    s.save("rv32r.npz")                       # the reference's artifact
    s2 = sim.load("rv32r.npz")                # ...reloaded

Layers: :mod:`.result` (``RunResult``), :mod:`.engine` (the ``Engine``
protocol and its adapters), :mod:`.artifact` (versioned ``.npz``
Programs), :mod:`.cache` (the on-disk compile cache) and :mod:`.facade`
(``compile``, ``load`` and ``Simulation``).
"""
from .artifact import FORMAT_VERSION, load_program, save_program
from .cache import CompileCache, cache_key, default_cache_dir
from .engine import (BatchedEngine, Engine, GridEngine, IsaEngine,
                     MachineEngine, OracleEngine, ShardedBatchedEngine)
from .facade import CYCLE_SLACK, Simulation, compile, load
from .result import FINISH, MISMATCH, RunResult

__all__ = [
    "compile", "load", "Simulation", "RunResult", "Engine",
    "MachineEngine", "BatchedEngine", "ShardedBatchedEngine", "GridEngine",
    "IsaEngine", "OracleEngine",
    "save_program", "load_program", "FORMAT_VERSION",
    "CompileCache", "cache_key", "default_cache_dir",
    "FINISH", "MISMATCH", "CYCLE_SLACK",
]
