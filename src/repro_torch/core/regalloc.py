# Copy of src/repro/core/regalloc.py (commit aa57dc1); imports may differ.
"""Linear-scan register allocation (paper §6.3).

The 2048-entry register file makes spills practically impossible for the
paper's workloads; we still reuse temporaries so heavily duplicated processes
fit. State (current register values, constants, relocatable memory bases) is
*pinned* — those machine registers persist across Vcycles. The Wimmer-Franz
optimization shares one machine register between a register's current and
next value when the schedule orders the next-value write after every read of
the current value.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .isa import Instr, Op
from .lower import InitVal


@dataclass
class CoreAlloc:
    vreg_to_mreg: Dict[int, int]
    init: List[Tuple[int, InitVal]]     # (machine reg, initial value/reloc)
    used: int


def allocate(slots: Sequence[Optional[Instr]],
             pinned_init: Dict[int, InitVal],
             share: Dict[int, int],
             num_regs: int,
             no_recycle: Optional[Set[int]] = None) -> CoreAlloc:
    """Allocate machine registers for one core.

    ``pinned_init``: leaf vregs (state/constants) and their initial values.
    ``share``: nxt vreg -> cur vreg register-sharing pairs (pre-validated).
    ``no_recycle``: vregs whose machine register must stay private for the
    whole stream — prologue carries of a modulo-pipelined schedule live
    across the Vcycle boundary, so their register cannot be handed to a
    later temporary even after their last in-stream read.
    """
    keep = no_recycle or set()
    vmap: Dict[int, int] = {0: 0}  # vreg 0 == machine r0 == 0
    init: List[Tuple[int, InitVal]] = []
    next_reg = 1

    # referenced vregs only
    referenced: Set[int] = set()
    for ins in slots:
        if ins is None:
            continue
        referenced.update(ins.srcs)
        w = ins.writes()
        if w is not None:
            referenced.add(w)
    for n, c in share.items():
        if n in referenced:
            referenced.add(c)

    # pin state & constants
    for v in sorted(referenced & set(pinned_init)):
        if v == 0:
            continue
        if next_reg >= num_regs:
            raise RuntimeError(f"register file overflow: {len(referenced)} "
                               f"values, {num_regs} registers")
        vmap[v] = next_reg
        init.append((next_reg, pinned_init[v]))
        next_reg += 1
    for n, c in sorted(share.items()):
        if n in referenced:
            vmap[n] = vmap[c]

    # linear scan over temporaries
    last_use: Dict[int, int] = {}
    for t, ins in enumerate(slots):
        if ins is None:
            continue
        for s in ins.srcs:
            last_use[s] = t
    free: List[int] = []
    for t, ins in enumerate(slots):
        if ins is None:
            continue
        w = ins.writes()
        if w is not None and w not in vmap:
            if free:
                vmap[w] = free.pop()
            else:
                if next_reg >= num_regs:
                    raise RuntimeError(
                        f"register file overflow at slot {t}: {num_regs} regs")
                vmap[w] = next_reg
                next_reg += 1
        # release temporaries whose last read is this slot
        for s in ins.srcs:
            if (last_use.get(s) == t and s in vmap and s != 0
                    and s not in pinned_init and s not in share
                    and s not in keep and vmap[s] not in free):
                # never recycle a register another vreg still maps to via share
                free.append(vmap[s])
    return CoreAlloc(vmap, init, next_reg)
