"""Core static-BSP stack: netlist IR, compiler pipeline and executors.

The compiler modules are copies of ``repro.core``'s; ``bsp`` (one device,
or the batch sharded over several: ``ShardedBatchedMachine``) and ``grid``
(the cores sharded over several: ``GridMachine``) are the port's own
engines. The recommended entry point is :mod:`repro_torch.sim`.
"""
from .compile import Program, compile_circuit
from .isa import HardwareConfig, Op
from .netlist import Circuit

__all__ = ["Program", "compile_circuit", "HardwareConfig", "Op", "Circuit"]
