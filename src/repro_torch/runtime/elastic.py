"""Elastic scaling of the LM's training state and of a running RTL
simulation.

Port of ``repro.runtime.elastic``. LM side: checkpoints are
mesh-agnostic (full logical arrays), and ``reshard`` places a tree onto
a new mesh's shardings, so a job that lost devices restarts on fewer
with only a spec rebuild: the divisibility guard in
``distributed.sharding`` re-derives legal specs for the new topology.

RTL side: a Manticore machine state migrates between two *compilations*
of the same circuit (different core counts or grids). Architectural state
is addressed by RTL register name and memory name, not by core, so the
new partitioning is free to place it anywhere; the transfer is exact.
"""
from __future__ import annotations

from typing import Any, Dict

from ..core.bsp import Machine, MachineState, from_words
from ..core.compile import Program
from ..distributed.sharding import shard_tree


def reshard(tree: Any, shardings: Any) -> Any:
    """Every leaf (a tensor, or a ``ShardedTensor`` on any mesh) placed
    on its new-mesh ``Sharding``, as a ``ShardedTensor``."""
    return shard_tree(tree, shardings)


def extract_state(prog: Program, state: MachineState) -> Dict[str, Any]:
    """Architectural state by name: registers, memories and the
    Vcycle counter, as host values."""
    regs = from_words(state.regs)
    out: Dict[str, Any] = {"__regs__": {}, "__mems__": {},
                           "__counters__": from_words(state.counters)[0:1]}
    for name, words in prog.state_regs.items():
        v = 0
        for j, locs in enumerate(words):
            c, r = locs[0]
            v |= int(regs[c, r]) << (16 * j)
        out["__regs__"][name] = v
    spads = from_words(state.spads)
    gmem = from_words(state.gmem)
    for mname, (core, base, words, is_global) in prog.stats.get(
            "mem_layout", {}).items():
        if is_global:
            out["__mems__"][mname] = gmem[base:base + words].copy()
        else:
            out["__mems__"][mname] = spads[core, base:base + words].copy()
    return out


def inject_state(prog: Program, machine: Machine,
                 saved: Dict[str, Any]) -> MachineState:
    """An initial MachineState for a *new* compilation carrying over the
    architectural state captured by ``extract_state``: every copy of each
    register and each memory of the program's images is overwritten by
    name (``Program.init_images``), and ``init_state`` starts the machine
    from those images, running a pipelined Program's prologue on the
    carried state. The reference overwrites the state after the prologue
    ran on the base image, which leaves a pipelined Program's hoisted
    values stale (ROADMAP queue C)."""
    layout = prog.stats.get("mem_layout", {})
    regs = {name: value for name, value in saved["__regs__"].items()
            if prog.state_regs.get(name)}
    mems = {name: data for name, data in saved.get("__mems__", {}).items()
            if name in layout}
    return machine.init_state(images=prog.init_images(regs, mems))


def migrate(old_prog: Program, old_state: MachineState,
            new_prog: Program, new_machine: Machine) -> MachineState:
    """Elastic re-scale of a running RTL simulation: old grid -> new grid."""
    return inject_state(new_prog, new_machine,
                        extract_state(old_prog, old_state))
