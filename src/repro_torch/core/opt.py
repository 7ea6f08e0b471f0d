# Copy of src/repro/core/opt.py (commit aa57dc1); imports may differ.
"""Optimizing middle-end: a pass pipeline over the lowered SSA IR (PR 3).

Manticore's premise is that the *compiler* pays for scheduling, so every
instruction deleted before partitioning shrinks VCPL for every engine at
once — and duplicated cones multiply each saved instruction across
processes. This module runs a small pass manager over the monolithic
:class:`~repro.core.lower.Lowered` process, between ``lower`` and
``partition`` (see ``core.compile.compile_circuit(optimize=True)``):

  * **fold** — constant folding + propagation over ``const_vregs`` (true
    constants only — never register state, latched inputs or
    :class:`~repro.core.lower.Reloc` leaves, which is precisely the
    batched-stimulus liveness contract, enforced by ``Lowered.check``);
  * **copyprop** — MOV/copy propagation (protected defs excepted);
  * **strength** — word-level strength reduction and algebraic identities
    (x*2^k -> shifts, ADD/SUB/AND/OR/XOR/MUX identities, carry/borrow
    chains with provably-zero inputs), driven by a known-bits analysis
    seeded from the per-word register widths (``Lowered.cur_word_masks``,
    i.e. the ``_mask_top`` contract) — this is what erases redundant
    top-word masking;
  * **cse** — global value numbering over pure ops *and* memory loads
    (full-cycle semantics order all loads of a memory before its stores,
    so two loads of the same (memory, address) are equivalent), with
    commutative operand canonicalization;
  * **dce** — dead-code elimination from the sink set (stores, EXPECTs,
    next-register and output definitions).

Passes never remove or rename a *protected* definition (next-register and
output vregs — ``Lowered.protected_vregs``): those have consumers outside
the instruction list (the commit plan, SEND payloads, host reads). A
protected def whose value folds is rewritten to ``MOV dst, const`` so the
sink survives. Per-pass instruction deltas and timings are recorded and
surface in ``Program.stats["opt_passes"]`` (see
``benchmarks/table8_compile_time.py``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from .isa import (COMMUTATIVE_OPS, Instr, MEM_READ_OPS, Op, PURE_OPS,
                  SIDE_EFFECT_OPS, WORD_MASK)
from .lower import Lowered, def_index

M = WORD_MASK
_SIGN = 0x8000


# ----------------------------------------------------------------------
# shared machinery
# ----------------------------------------------------------------------

def _find(subst: Dict[int, int], v: int) -> int:
    """Resolve ``v`` through the substitution map (with path compression)."""
    r = v
    while r in subst:
        r = subst[r]
    while v in subst and subst[v] != r:
        subst[v], v = r, subst[v]
    return r


def _resolve(subst: Dict[int, int], srcs: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(_find(subst, s) for s in srcs)


def pure_backward_cone(low: Lowered, vreg: int, max_size: int,
                       defs: Optional[Dict[int, int]] = None):
    """Bounded backward closure of the pure expression computing ``vreg``.

    Walks def-use chains from ``vreg``'s defining instruction. Returns
    ``(instr_indices, state_reads)`` — frozensets of instruction indices
    and of current-register leaves the cone reads — when the whole cone is
    :data:`~repro.core.isa.PURE_OPS` and at most ``max_size`` instructions;
    ``None`` when the cone is impure (loads, sends, side effects), too
    large, or ``vreg`` has no defining instruction. Constant / input /
    Reloc leaves are free (their init is materialized on every core by
    regalloc) and are not reported. Used by
    :mod:`~repro.core.remat` to price rematerialization candidates."""
    if defs is None:
        defs = low.defs()
    d0 = defs.get(vreg)
    if d0 is None:
        return None
    state = low.state_vregs()
    instrs: set = set()
    reads: set = set()
    stack = [d0]
    while stack:
        idx = stack.pop()
        if idx in instrs:
            continue
        if low.instrs[idx].op not in PURE_OPS:
            return None
        instrs.add(idx)
        if len(instrs) > max_size:
            return None
        for s in low.instrs[idx].srcs:
            dd = defs.get(s)
            if dd is not None:
                if dd not in instrs:
                    stack.append(dd)
            elif s in state:
                reads.add(s)
    return frozenset(instrs), frozenset(reads)


class _ConstPool:
    """Reverse map value -> const vreg; materializes new leaves on demand."""

    def __init__(self, low: Lowered):
        self.low = low
        self.rev: Dict[int, int] = {0: 0}
        for v in sorted(low.const_vregs):
            self.rev.setdefault(low.const_vregs[v], v)

    def vreg(self, value: int) -> int:
        value &= M
        v = self.rev.get(value)
        if v is None:
            low = self.low
            v = low.num_vregs
            low.num_vregs += 1
            low.vreg_init[v] = value
            low.const_vregs[v] = value
            self.rev[value] = v
        return v


def eval_op(op: Op, vals: List[int], imm: int) -> Optional[int]:
    """Evaluate one pure op over constant operands (16-bit semantics,
    mirroring ``core.isasim``)."""
    v = list(vals) + [0] * (4 - len(vals))
    if op == Op.MOV:
        return v[0]
    if op == Op.MOVI:
        return imm & M
    if op == Op.ADD:
        return (v[0] + v[1]) & M
    if op == Op.ADDC:
        return (v[0] + v[1] + v[2]) & M
    if op == Op.CARRY:
        return (v[0] + v[1] + v[2]) >> 16
    if op == Op.SUB:
        return (v[0] - v[1]) & M
    if op == Op.SUBB:
        return (v[0] - v[1] - v[2]) & M
    if op == Op.BORROW:
        return int(v[0] - v[1] - v[2] < 0)
    if op == Op.MUL:
        return (v[0] * v[1]) & M
    if op == Op.MULH:
        return ((v[0] * v[1]) >> 16) & M
    if op == Op.AND:
        return v[0] & v[1]
    if op == Op.OR:
        return v[0] | v[1]
    if op == Op.XOR:
        return v[0] ^ v[1]
    if op == Op.NOT:
        return (~v[0]) & M
    if op == Op.MUX:
        return v[1] if v[0] else v[2]
    if op == Op.SEQ:
        return int(v[0] == v[1])
    if op == Op.SNE:
        return int(v[0] != v[1])
    if op == Op.SLTU:
        return int(v[0] < v[1])
    if op == Op.SLL:
        return (v[0] << (imm & 15)) & M
    if op == Op.SRL:
        return v[0] >> (imm & 15)
    if op == Op.SRA:
        return (((v[0] ^ _SIGN) - _SIGN) >> (imm & 15)) & M
    if op == Op.SLLV:
        return (v[0] << (v[1] & 15)) & M
    if op == Op.SRLV:
        return v[0] >> (v[1] & 15)
    if op == Op.SLICE:
        return (v[0] >> (imm >> 5)) & ((1 << (imm & 31)) - 1)
    return None


def _bound(x: int) -> int:
    """Smallest all-ones mask covering every value <= x (16-bit clip)."""
    return M if x >= M else (1 << x.bit_length()) - 1


def maybe_mask(op: Op, m: List[int], imm: int) -> int:
    """Known-bits transfer function: mask of possibly-set result bits given
    the operands' possibly-set masks (a mask is also an upper bound on the
    operand's value)."""
    m = list(m) + [0] * (4 - len(m))
    if op == Op.MOV:
        return m[0]
    if op == Op.MOVI:
        return imm & M
    if op == Op.AND:
        return m[0] & m[1]
    if op in (Op.OR, Op.XOR):
        return m[0] | m[1]
    if op == Op.MUX:
        return m[1] | m[2]
    if op in (Op.SEQ, Op.SNE, Op.SLTU, Op.BORROW):
        return 1
    if op == Op.CARRY:
        return 1 if m[0] + m[1] + m[2] > M else 0
    if op in (Op.ADD, Op.ADDC):
        s = m[0] + m[1] + (m[2] if op == Op.ADDC else 0)
        return M if s > M else _bound(s)
    if op == Op.MUL:
        p = m[0] * m[1]
        return M if p > M else _bound(p)
    if op == Op.MULH:
        return _bound((m[0] * m[1]) >> 16)
    if op == Op.SLL:
        return (m[0] << (imm & 15)) & M
    if op == Op.SRL:
        return m[0] >> (imm & 15)
    if op == Op.SRA:
        return M if m[0] & _SIGN else m[0] >> (imm & 15)
    if op == Op.SLLV:
        return M if m[0] else 0
    if op == Op.SRLV:
        return _bound(m[0])
    if op == Op.SLICE:
        return (m[0] >> (imm >> 5)) & ((1 << (imm & 31)) - 1)
    return M  # NOT, LD, GLD, LUT, unknown: every bit may be set


def _init_masks(low: Lowered) -> Dict[int, int]:
    masks = {0: 0}
    for v in low.vreg_init:
        masks[v] = M                        # inputs / Reloc: opaque
    masks.update(low.const_vregs)           # true constants: exact
    masks.update(low.cur_word_masks())      # register words: width-bounded
    return masks


# ----------------------------------------------------------------------
# passes — each rewrites low.instrs in place and returns a change count
# ----------------------------------------------------------------------

def const_fold(low: Lowered) -> int:
    """Fold pure ops whose operands are all true constants; propagate the
    folded values forward. Protected defs become ``MOV dst, const``."""
    protected = low.protected_vregs()
    pool = _ConstPool(low)
    const_of = dict(low.const_vregs)
    subst: Dict[int, int] = {}
    out: List[Instr] = []
    changed = 0
    for ins in low.instrs:
        srcs = _resolve(subst, ins.srcs)
        w = ins.writes()
        if ins.op in PURE_OPS and w != 0 and \
                all(s == 0 or s in const_of for s in srcs):
            val = eval_op(ins.op, [const_of.get(s, 0) for s in srcs], ins.imm)
            if val is not None:
                cv = pool.vreg(val)
                const_of[w] = val
                if w in protected:
                    if not (ins.op == Op.MOV and srcs == (cv,)):
                        changed += 1
                    out.append(Instr(Op.MOV, w, (cv,)))
                else:
                    subst[w] = cv
                    changed += 1
                continue
        if srcs != ins.srcs:
            ins = Instr(ins.op, ins.dst, srcs, ins.imm, mem=ins.mem)
        out.append(ins)
    low.replace_instrs(out)
    return changed


def copy_prop(low: Lowered) -> int:
    """Remove non-protected MOVs by substituting their source forward."""
    protected = low.protected_vregs()
    subst: Dict[int, int] = {}
    out: List[Instr] = []
    changed = 0
    for ins in low.instrs:
        srcs = _resolve(subst, ins.srcs)
        if ins.op == Op.MOV and ins.dst != 0 and ins.dst not in protected:
            subst[ins.dst] = srcs[0]
            changed += 1
            continue
        if srcs != ins.srcs:
            ins = Instr(ins.op, ins.dst, srcs, ins.imm, mem=ins.mem)
        out.append(ins)
    low.replace_instrs(out)
    return changed


def _pow2(c: Optional[int]) -> Optional[int]:
    if c is not None and c > 0 and c & (c - 1) == 0:
        return c.bit_length() - 1
    return None


def _simplify(op: Op, srcs: Tuple[int, ...], imm: int,
              const_of: Dict[int, int], mb: List[int]):
    """One algebraic rewrite step. Returns ("subst", vreg) |
    ("const", value) | ("rewrite", op, srcs, imm) | None."""
    def c(i):
        s = srcs[i]
        return 0 if s == 0 else const_of.get(s)

    a = srcs[0] if srcs else 0
    b = srcs[1] if len(srcs) > 1 else 0
    if op == Op.ADD:
        if mb[1] == 0:
            return ("subst", a)
        if mb[0] == 0:
            return ("subst", b)
    elif op == Op.ADDC:
        if mb[2] == 0:
            return ("rewrite", Op.ADD, srcs[:2], 0)
    elif op == Op.SUB:
        if mb[1] == 0:
            return ("subst", a)
        if a == b:
            return ("const", 0)
    elif op == Op.SUBB:
        if mb[2] == 0:
            return ("rewrite", Op.SUB, srcs[:2], 0)
    elif op == Op.BORROW:
        if mb[1] == 0 and mb[2] == 0:
            return ("const", 0)
        if a == b and mb[2] == 0:
            return ("const", 0)
    elif op == Op.MUL:
        for x, y in ((0, 1), (1, 0)):
            if c(y) == 1:
                return ("subst", srcs[x])
            k = _pow2(c(y))
            if k is not None and 1 <= k <= 15:
                return ("rewrite", Op.SLL, (srcs[x],), k)
    elif op == Op.MULH:
        for x, y in ((0, 1), (1, 0)):
            k = _pow2(c(y))
            if k is not None and 1 <= k <= 15:
                return ("rewrite", Op.SRL, (srcs[x],), 16 - k)
    elif op == Op.AND:
        if a == b:
            return ("subst", a)
        if mb[0] & mb[1] == 0:
            return ("const", 0)
        for x, y in ((0, 1), (1, 0)):
            cy = c(y)
            if cy is not None and mb[x] & ~cy == 0:
                return ("subst", srcs[x])
    elif op == Op.OR:
        if a == b or mb[1] == 0:
            return ("subst", a)
        if mb[0] == 0:
            return ("subst", b)
        for x, y in ((0, 1), (1, 0)):
            cy = c(y)
            if cy is not None and mb[x] & ~cy == 0:
                return ("const", cy)
    elif op == Op.XOR:
        if a == b:
            return ("const", 0)
        if mb[1] == 0:
            return ("subst", a)
        if mb[0] == 0:
            return ("subst", b)
        for x, y in ((0, 1), (1, 0)):
            if c(y) == M:
                return ("rewrite", Op.NOT, (srcs[x],), 0)
    elif op == Op.MUX:
        sel = c(0)
        if sel is not None:
            return ("subst", srcs[1] if sel else srcs[2])
        if mb[0] == 0:
            return ("subst", srcs[2])
        if srcs[1] == srcs[2]:
            return ("subst", srcs[1])
    elif op == Op.SEQ:
        if a == b:
            return ("const", 1)
    elif op in (Op.SNE, Op.SLTU):
        if a == b:
            return ("const", 0)
        if op == Op.SLTU and mb[1] == 0:
            return ("const", 0)
    elif op in (Op.SLL, Op.SRL, Op.SRA):
        if imm & 15 == 0:
            return ("subst", a)
        if op == Op.SRA and mb[0] & _SIGN == 0:
            return ("rewrite", Op.SRL, srcs, imm)
    elif op in (Op.SLLV, Op.SRLV):
        amt = c(1)
        if amt is not None:
            return ("rewrite", Op.SLL if op == Op.SLLV else Op.SRL,
                    (a,), amt & 15)
        if mb[1] == 0:
            return ("subst", a)
    elif op == Op.SLICE:
        off, width = imm >> 5, imm & 31
        if off == 0 and mb[0] & ~((1 << width) - 1) == 0:
            return ("subst", a)
    return None


def strength_reduce(low: Lowered) -> int:
    """Known-bits-driven identities, strength reduction (x*2^k -> shifts,
    carry/borrow chains with provably-zero inputs), dead predicated stores
    and always-true EXPECTs."""
    protected = low.protected_vregs()
    pool = _ConstPool(low)
    const_of = dict(low.const_vregs)
    maybe = _init_masks(low)
    subst: Dict[int, int] = {}
    out: List[Instr] = []
    changed = 0

    def emit_const(w: int, val: int, cur_op: Op,
                   cur_srcs: Tuple[int, ...]) -> None:
        nonlocal changed
        cv = pool.vreg(val)
        const_of[w] = val
        maybe[cv] = val
        if w in protected:
            maybe[w] = val
            out.append(Instr(Op.MOV, w, (cv,)))
            if not (cur_op == Op.MOV and cur_srcs == (cv,)):
                changed += 1       # already canonical: not a change
        else:
            subst[w] = cv
            changed += 1

    for ins in low.instrs:
        srcs = _resolve(subst, ins.srcs)
        op, imm = ins.op, ins.imm
        w = ins.writes()
        # predicated sinks with provably-false predicates are dead; an
        # EXPECT comparing a value with itself can never raise
        if op in (Op.ST, Op.GST):
            en = srcs[2] if op == Op.ST else srcs[3]
            if maybe.get(en, M) == 0:
                changed += 1
                continue
        if op == Op.EXPECT and srcs[0] == srcs[1]:
            changed += 1
            continue
        if op in PURE_OPS and w is not None and w != 0:
            rewritten = False
            for _ in range(4):  # a rewrite may expose another identity
                mb = [maybe.get(s, M) for s in srcs] + [0] * (4 - len(srcs))
                act = _simplify(op, srcs, imm, const_of, mb)
                if act is None:
                    break
                if act[0] == "subst":
                    v = act[1]
                    if w in protected:
                        maybe[w] = maybe.get(v, M)
                        if v in const_of:
                            const_of[w] = const_of[v]
                        out.append(Instr(Op.MOV, w, (v,)))
                        if not (op == Op.MOV and srcs == (v,)):
                            changed += 1
                    else:
                        subst[w] = v
                        changed += 1
                    break
                if act[0] == "const":
                    emit_const(w, act[1], op, srcs)
                    break
                _, op, srcs, imm = act
                rewritten = True
            else:
                act = None
            if act is not None:
                continue
            mask = maybe_mask(op, [maybe.get(s, M) for s in srcs], imm)
            if mask == 0:
                emit_const(w, 0, op, srcs)
                continue
            maybe[w] = mask
            if rewritten or srcs != ins.srcs:
                if rewritten:
                    changed += 1
                ins = Instr(op, ins.dst, srcs, imm, mem=ins.mem)
            out.append(ins)
            continue
        if w is not None:
            maybe[w] = maybe_mask(op, [maybe.get(s, M) for s in srcs], imm)
        if srcs != ins.srcs:
            ins = Instr(op, ins.dst, srcs, imm, mem=ins.mem)
        out.append(ins)
    low.replace_instrs(out)
    return changed


def cse(low: Lowered) -> int:
    """Global value numbering: identical pure ops (and loads — full-cycle
    semantics order every load before any store of its memory) collapse to
    one definition. Commutative operands are canonicalized."""
    protected = low.protected_vregs()
    subst: Dict[int, int] = {}
    table: Dict[Tuple, int] = {}
    out: List[Instr] = []
    changed = 0
    for ins in low.instrs:
        srcs = _resolve(subst, ins.srcs)
        w = ins.writes()
        key = None
        # MOVs are excluded: numbering a copy saves no instruction (copies
        # are either protected or already gone via copy_prop), would couple
        # otherwise-independent cones, and oscillates against const_fold
        # (MOV w,const <-> MOV w,canon) defeating fixpoint detection.
        if w is not None and w != 0 and ins.op != Op.MOV and \
                (ins.op in PURE_OPS or ins.op in MEM_READ_OPS):
            k_srcs = srcs
            if ins.op in COMMUTATIVE_OPS:
                k_srcs = tuple(sorted(srcs[:2])) + srcs[2:]
            key = (ins.op, k_srcs, ins.imm, ins.mem)
            canon = table.get(key)
            if canon is not None:
                if w in protected:
                    out.append(Instr(Op.MOV, w, (canon,)))
                else:
                    subst[w] = canon
                changed += 1
                continue
            table[key] = w
        if srcs != ins.srcs:
            ins = Instr(ins.op, ins.dst, srcs, ins.imm, mem=ins.mem)
        out.append(ins)
    low.replace_instrs(out)
    return changed


def dce(low: Lowered) -> int:
    """Dead-code elimination from the sink set: stores, EXPECTs and the
    protected (next-register / output) definitions stay live; everything
    not reachable backwards from them goes."""
    protected = low.protected_vregs()
    defs = def_index(low.instrs)
    live: set = set()
    stack: List[int] = []
    for i, ins in enumerate(low.instrs):
        w = ins.writes()
        if ins.op in SIDE_EFFECT_OPS or (w is not None and w in protected):
            stack.append(i)
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        for s in low.instrs[i].srcs:
            d = defs.get(s)
            if d is not None and d not in live:
                stack.append(d)
    removed = len(low.instrs) - len(live)
    if removed:
        low.replace_instrs([ins for i, ins in enumerate(low.instrs)
                            if i in live])
    return removed


# ----------------------------------------------------------------------
# pass manager
# ----------------------------------------------------------------------

# one round of the pipeline; repeated to fixpoint by optimize_lowered
PIPELINE: List[Tuple[str, Callable[[Lowered], int]]] = [
    ("fold", const_fold),
    ("copyprop", copy_prop),
    ("strength", strength_reduce),
    ("copyprop", copy_prop),
    ("cse", cse),
    ("dce", dce),
]

MAX_ROUNDS = 8


def optimize_lowered(low: Lowered,
                     pipeline: Optional[List[Tuple[str, Callable]]] = None,
                     max_rounds: int = MAX_ROUNDS,
                     check: bool = True) -> Tuple[Lowered, List[Dict]]:
    """Run the pass pipeline to fixpoint. Returns ``(low, records)`` where
    ``records`` lists per-pass instruction deltas and wall times (surfaced
    as ``Program.stats["opt_passes"]``)."""
    pipeline = PIPELINE if pipeline is None else pipeline
    records: List[Dict] = []
    if check:
        low.check()
    for rnd in range(max_rounds):
        round_changes = 0
        for name, fn in pipeline:
            before = len(low.instrs)
            t0 = time.perf_counter()
            ch = fn(low)
            records.append({
                "pass": name, "round": rnd, "changed": ch,
                "instrs_before": before, "instrs_after": len(low.instrs),
                "seconds": time.perf_counter() - t0,
            })
            round_changes += ch
        if not round_changes:
            break
    low.compact()
    if check:
        low.check()
    return low, records
