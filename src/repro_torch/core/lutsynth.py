# Copy of src/repro/core/lutsynth.py (commit aa57dc1); imports may differ.
"""Custom function synthesis (paper §6.2).

Collapses chains of bitwise logic (AND/OR/XOR/NOT) into single 4-input LUT
instructions evaluated by the per-core custom function unit (CFU). Mirrors
the paper's flow:

  * prune non-logic vertices -> connected logic components;
  * enumerate 4-feasible cuts (cut enumeration, Cong et al.);
  * keep maximum fanout-free cones (MFFC): no interior value may be used
    outside the cone;
  * compute the 16x16-bit truth table. The CFU applies an independent 4-input
    boolean function per bit lane, which lets *constant* operands be folded
    into the table for free (the paper's (a & 0xf) | b | (c & 0x3) | (d ^ 1)
    example) — constants do not consume LUT inputs;
  * group equivalent tables (logic equivalence = identical tables here) and
    select non-overlapping cones. The paper uses an MILP; we use weighted
    greedy set cover (largest savings first), which the evaluation shows is
    within noise for these workloads, and cap distinct tables at the
    hardware's 32 CFU slots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .isa import Instr, LOGIC_OPS, NUM_LUTS, Op, WORD_MASK
from .lower import Lowered, def_index, use_index

# per-lane truth tables for the 4 cut variables: table bit p = value of
# variable i under input pattern p (p encodes (v3,v2,v1,v0))
_VAR_TABLE = [sum(((p >> i) & 1) << p for p in range(16)) for i in range(4)]


@dataclass
class LutCandidate:
    root: int                  # local instr index
    var_leaves: Tuple[int, ...]  # vregs feeding LUT inputs (<= 4)
    covered: Tuple[int, ...]   # local instr indices replaced (incl. root)
    table: Tuple[int, ...]     # 16 entries, entry p = per-lane bits (uint16)

    @property
    def savings(self) -> int:
        return len(self.covered) - 1


def _eval_cone(instrs: List[Instr], root: int, leaves: Sequence[int],
               const_of: Dict[int, int],
               defs: Dict[int, int]) -> Optional[Tuple[int, ...]]:
    """Symbolically evaluate the cone over its <=4 variable leaves.
    Returns the 16-entry LUT table or None if not expressible."""
    var_idx = {v: i for i, v in enumerate(leaves)}
    lane_tables: Dict[int, List[int]] = {}

    def value_of(vreg: int) -> Optional[List[int]]:
        if vreg in var_idx:
            t = _VAR_TABLE[var_idx[vreg]]
            return [t] * 16
        if vreg in const_of:
            c = const_of[vreg]
            return [0xFFFF if (c >> j) & 1 else 0 for j in range(16)]
        if vreg == 0:
            return [0] * 16
        d = defs.get(vreg)
        if d is None:
            return None
        return lane_tables.get(d)

    # evaluate in topo order (instrs are emitted in topo order)
    pending = sorted(_cone_instrs(instrs, root, set(leaves), defs))
    for idx in pending:
        ins = instrs[idx]
        vals = [value_of(s) for s in ins.srcs]
        if any(v is None for v in vals):
            return None
        if ins.op == Op.AND:
            lane_tables[idx] = [a & b for a, b in zip(vals[0], vals[1])]
        elif ins.op == Op.OR:
            lane_tables[idx] = [a | b for a, b in zip(vals[0], vals[1])]
        elif ins.op == Op.XOR:
            lane_tables[idx] = [a ^ b for a, b in zip(vals[0], vals[1])]
        elif ins.op == Op.NOT:
            lane_tables[idx] = [(~a) & WORD_MASK for a in vals[0]]
        else:
            return None
    lanes = lane_tables[root]
    # convert per-lane 16-bit tables into 16 pattern entries of per-lane bits
    return tuple(sum(((lanes[j] >> p) & 1) << j for j in range(16))
                 for p in range(16))


def _cone_instrs(instrs: List[Instr], root: int, leaves: Set[int],
                 defs: Dict[int, int]) -> Set[int]:
    out: Set[int] = set()
    stack = [root]
    while stack:
        idx = stack.pop()
        if idx in out:
            continue
        out.add(idx)
        for s in instrs[idx].srcs:
            if s in leaves:
                continue
            d = defs.get(s)
            if d is not None and instrs[d].op in LOGIC_OPS:
                stack.append(d)
    return out


def synthesize(instrs: List[Instr], vreg_init: Dict[int, object],
               protected: frozenset = frozenset(),
               max_tables: int = NUM_LUTS, max_cuts: int = 8,
               ) -> Tuple[List[Instr], List[Tuple[int, ...]]]:
    """Rewrite one process: fuse logic cones into LUT instructions.

    ``protected`` vregs (next-register values, outputs, sent values) have
    consumers outside the instruction list and must survive as explicit defs
    — they may be LUT roots but never fused-away interiors.

    Since PR 3 the input is the post-opt IR: copy propagation has collapsed
    MOV chains between logic ops (a MOV is not in ``LOGIC_OPS``, so it used
    to sever a logic component in two), which exposes larger fanout-free
    cones to the cut enumeration, and ``vreg_init`` may contain constants
    the middle-end materialized — both fold into tables for free.

    Returns (new instruction list, LUT tables used by this process).
    """
    defs: Dict[int, int] = def_index(instrs)
    const_of = dict(vreg_init)  # caller passes *true constants only*
    uses: Dict[int, List[int]] = use_index(instrs)

    # ---- cut enumeration over logic nodes -----------------------------
    # a cut is a frozenset of *variable* vregs (constants are free)
    cuts: Dict[int, List[frozenset]] = {}

    def leaf_cut(vreg: int) -> Optional[frozenset]:
        if vreg in const_of or vreg == 0:
            return frozenset()
        return frozenset([vreg])

    candidates: List[LutCandidate] = []
    for i, ins in enumerate(instrs):
        if ins.op not in LOGIC_OPS:
            continue
        src_cut_sets: List[List[frozenset]] = []
        for s in ins.srcs:
            d = defs.get(s)
            if d is not None and instrs[d].op in LOGIC_OPS:
                src_cut_sets.append(cuts.get(d, []) + [leaf_cut(s) or
                                                       frozenset([s])])
            else:
                lc = leaf_cut(s)
                src_cut_sets.append([lc if lc is not None else frozenset([s])])
        merged: Set[frozenset] = set()
        if len(src_cut_sets) == 1:
            for a in src_cut_sets[0]:
                if len(a) <= 4:
                    merged.add(a)
        else:
            for a in src_cut_sets[0]:
                for b in src_cut_sets[1]:
                    u = a | b
                    if len(u) <= 4:
                        merged.add(u)
        # prune: prefer small cuts, keep a bounded frontier
        kept = sorted(merged, key=len)[:max_cuts]
        cuts[i] = kept

        # ---- candidate cones at this root ------------------------------
        for cut in kept:
            cone = _cone_instrs(instrs, i, set(cut), defs)
            if len(cone) < 2:
                continue  # no savings
            # MFFC check: interior values must not escape the cone
            ok = True
            for idx in cone:
                if idx == i:
                    continue
                w = instrs[idx].writes()
                if (w is None or w in protected or
                        any(u not in cone for u in uses.get(w, []))):
                    ok = False
                    break
            if not ok:
                continue
            table = _eval_cone(instrs, i, tuple(sorted(cut)), const_of, defs)
            if table is None:
                continue
            candidates.append(LutCandidate(i, tuple(sorted(cut)),
                                           tuple(sorted(cone)), table))

    # ---- greedy selection (largest savings first) -----------------------
    candidates.sort(key=lambda c: (-c.savings, c.root))
    covered: Set[int] = set()
    tables: List[Tuple[int, ...]] = []
    table_idx: Dict[Tuple[int, ...], int] = {}
    chosen: Dict[int, LutCandidate] = {}
    for cand in candidates:
        if cand.savings <= 0 or any(x in covered for x in cand.covered):
            continue
        if cand.table not in table_idx and len(tables) >= max_tables:
            continue
        if cand.table not in table_idx:
            table_idx[cand.table] = len(tables)
            tables.append(cand.table)
        covered.update(cand.covered)
        chosen[cand.root] = cand

    # ---- rewrite ---------------------------------------------------------
    out: List[Instr] = []
    dropped: Set[int] = set()
    for c in chosen.values():
        dropped.update(x for x in c.covered if x != c.root)
    for i, ins in enumerate(instrs):
        if i in dropped:
            continue
        if i in chosen:
            c = chosen[i]
            srcs = list(c.var_leaves) + [0] * (4 - len(c.var_leaves))
            out.append(Instr(Op.LUT, ins.dst, tuple(srcs),
                             imm=table_idx[c.table]))
        else:
            out.append(ins)
    return out, tables
