# Copy of src/repro/core/lower.py (commit aa57dc1); imports may differ.
"""Netlist -> lower assembly (16-bit datapath legalization).

Mirrors the paper's backend step (§6): *"We then transform the netlist
assembly instructions into an equivalent sequence of lower assembly
instructions whose operands match Manticore's 16-bit data path."*

Every netlist signal of width W becomes ceil(W/16) virtual registers (LSW
first). Wide arithmetic is legalized into ADDC/CARRY (resp. SUBB/BORROW)
chains — the paper's overflow-bit mechanism — wide shifts into word-level
shift/or networks, and memory accesses into LD/ST (scratchpad) or GLD/GST
(privileged, off-chip) with relocatable base addresses resolved at placement
time.

The output is a *monolithic process*: a flat SSA instruction list, exactly
what the paper's partitioner consumes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .isa import Instr, Op, WORD_BITS, WORD_MASK
from .netlist import Circuit, Memory, NOp, Node


def nwords(width: int) -> int:
    return (width + WORD_BITS - 1) // WORD_BITS


def def_index(instrs: Sequence[Instr]) -> Dict[int, int]:
    """vreg -> index of its (unique, SSA) defining instruction."""
    out: Dict[int, int] = {}
    for i, ins in enumerate(instrs):
        w = ins.writes()
        if w is not None and w != 0:
            out[w] = i
    return out


def use_index(instrs: Sequence[Instr]) -> Dict[int, List[int]]:
    """vreg -> indices of instructions reading it (def-use chains)."""
    out: Dict[int, List[int]] = {}
    for i, ins in enumerate(instrs):
        for s in ins.srcs:
            out.setdefault(s, []).append(i)
    return out


@dataclass(frozen=True)
class Reloc:
    """Relocatable constant: memory base address, resolved at placement."""
    mem: str
    part: str  # "lo" | "hi"
    offset: int = 0


InitVal = Union[int, Reloc]


@dataclass
class RegWords:
    """Lowered view of one RTL register."""
    name: str
    width: int
    cur: Tuple[int, ...]    # leaf vregs holding the current value
    nxt: Tuple[int, ...]    # vregs computed each Vcycle (the next value)
    init: int


@dataclass
class MemLayout:
    name: str
    depth: int
    width: int
    stride: int             # 16-bit words per entry
    is_global: bool
    init_words: List[int]


@dataclass
class Lowered:
    """Monolithic lower-assembly process (pre-partitioning).

    Since PR 3 this is a proper pass-friendly SSA IR: virtual registers are
    defined at most once, every definition precedes its uses (the list is
    topologically ordered), and the helpers below expose def-use chains,
    liveness roots and an invariant checker so optimization passes
    (``core.opt``) can rewrite the instruction stream safely.

    Liveness contract (the batched-stimulus roots, see ``docs/compiler.md``):

      * every next-register vreg (``regs[*].nxt``) keeps a *unique* defining
        instruction — it is a partitioning sink and commit source;
      * current-register vregs (``regs[*].cur``), including ``Planes`` init
        carriers, and :class:`Reloc` leaves are opaque state — they are never
        in ``const_vregs`` and must never be folded as constants (their value
        is patched per stimulus / at placement);
      * output vregs keep their defining instructions.
    """
    name: str
    instrs: List[Instr]
    vreg_init: Dict[int, InitVal]          # leaf vregs (consts/inputs/state)
    regs: List[RegWords]
    mems: Dict[str, MemLayout]
    outputs: Dict[str, List[int]]          # name -> vregs (in priv process)
    num_vregs: int
    # vregs that are *true constants* (foldable into LUT truth tables);
    # register state and latched inputs are NOT here.
    const_vregs: Dict[int, int] = field(default_factory=dict)

    def stats(self) -> Dict[str, int]:
        per_op: Dict[str, int] = {}
        for i in self.instrs:
            per_op[i.op.name] = per_op.get(i.op.name, 0) + 1
        return {"instrs": len(self.instrs), "vregs": self.num_vregs,
                "regs": len(self.regs), **per_op}

    # ---- pass-support helpers (PR 3) ---------------------------------
    def defs(self) -> Dict[int, int]:
        return def_index(self.instrs)

    def uses(self) -> Dict[int, List[int]]:
        return use_index(self.instrs)

    def protected_vregs(self) -> set:
        """Vregs with consumers outside the instruction list: next-register
        words (commit sources / SEND payloads) and host-visible outputs.
        Their defining instructions must survive every pass and must keep
        their ``dst``."""
        out = set()
        for r in self.regs:
            out.update(r.nxt)
        for vs in self.outputs.values():
            out.update(vs)
        return out

    def state_vregs(self) -> set:
        """Current-register leaves (incl. batched init-plane carriers)."""
        out = set()
        for r in self.regs:
            out.update(r.cur)
        return out

    def cur_word_masks(self) -> Dict[int, int]:
        """Per current-register-word mask of bits that can ever be set.

        Word ``j`` of a ``W``-bit register holds at most ``min(16, W-16j)``
        bits: inits are masked by the netlist builders (``Circuit.reg`` /
        ``circuits.common.Planes``) and every lowered next-value is masked
        via ``_mask_top``. The known-bits pass in ``core.opt`` leans on
        this to erase redundant top-word masking."""
        masks: Dict[int, int] = {}
        for r in self.regs:
            for j, cw in enumerate(r.cur):
                bits = min(WORD_BITS, r.width - WORD_BITS * j)
                masks[cw] = (1 << max(bits, 0)) - 1
        return masks

    def replace_instrs(self, instrs: List[Instr]) -> None:
        """Install a rewritten instruction list (passes call this so future
        bookkeeping has a single choke point)."""
        self.instrs = instrs

    def compact(self) -> Dict[int, int]:
        """Renumber vregs densely (0 stays 0), dropping leaf-init entries no
        longer referenced by instructions, register state or outputs.
        Returns the old->new mapping applied."""
        live: set = {0}
        for ins in self.instrs:
            live.update(ins.srcs)
            w = ins.writes()
            if w is not None:
                live.add(w)
        for r in self.regs:
            live.update(r.cur)
            live.update(r.nxt)
        for vs in self.outputs.values():
            live.update(vs)
        remap = {v: i for i, v in enumerate(sorted(live))}

        def m(v: int) -> int:
            return remap[v]

        self.instrs = [
            Instr(ins.op, m(ins.dst) if ins.writes() is not None else 0,
                  tuple(m(s) for s in ins.srcs), ins.imm, mem=ins.mem)
            for ins in self.instrs]
        self.vreg_init = {m(v): iv for v, iv in self.vreg_init.items()
                          if v in remap}
        self.const_vregs = {m(v): c for v, c in self.const_vregs.items()
                            if v in remap}
        self.regs = [RegWords(r.name, r.width, tuple(m(v) for v in r.cur),
                              tuple(m(v) for v in r.nxt), r.init)
                     for r in self.regs]
        self.outputs = {k: [m(v) for v in vs]
                        for k, vs in self.outputs.items()}
        self.num_vregs = len(remap)
        return remap

    def check(self) -> None:
        """Invariant checker: SSA well-formedness plus the batched-stimulus
        liveness contract. Raises AssertionError on violation."""
        defined: Dict[int, int] = {}
        for i, ins in enumerate(self.instrs):
            w = ins.writes()
            assert w != 0, \
                f"instr {i} writes the architectural zero register v0"
            if w is not None:
                assert w not in defined, \
                    f"vreg v{w} defined twice (instrs {defined[w]} and {i})"
                assert w not in self.vreg_init, \
                    f"leaf vreg v{w} redefined by instr {i}"
                assert 0 < w < self.num_vregs, (i, w)
                defined[w] = i
            for s in ins.srcs:
                assert 0 <= s < self.num_vregs, (i, s)
                if s != 0 and s not in self.vreg_init:
                    assert s in defined and defined[s] < i, \
                        f"instr {i} reads v{s} before its definition"
            if ins.op in (Op.LD, Op.ST, Op.GLD, Op.GST):
                assert ins.mem in self.mems, (i, ins.mem)
        # constants are true constants: int inits matching const_vregs,
        # never register state, never relocatable addresses
        state = self.state_vregs()
        for v, c in self.const_vregs.items():
            if v == 0:
                assert c == 0
                continue
            iv = self.vreg_init.get(v)
            assert isinstance(iv, int) and iv == c, \
                f"const vreg v{v} init {iv!r} != folded value {c}"
            assert v not in state, f"state vreg v{v} marked constant"
        for v, iv in self.vreg_init.items():
            if isinstance(iv, Reloc):
                assert v not in self.const_vregs, \
                    f"relocatable leaf v{v} marked constant"
        # batched-stimulus roots: every register word keeps its state leaf
        # and a unique next-value definition
        seen_nxt: set = set()
        for r in self.regs:
            assert len(r.cur) == len(r.nxt) == nwords(r.width), r.name
            for cw in r.cur:
                assert cw in self.vreg_init, \
                    f"state leaf v{cw} of {r.name} lost its init"
            for nw in r.nxt:
                assert nw in defined, \
                    f"next-register v{nw} of {r.name} has no definition"
                assert nw not in seen_nxt, \
                    f"next-register v{nw} of {r.name} shared between words"
                seen_nxt.add(nw)
        for name, vs in self.outputs.items():
            for v in vs:
                assert v in defined, f"output {name!r} vreg v{v} undefined"


class Lowerer:
    def __init__(self, circuit: Circuit):
        circuit.validate()
        self.c = circuit
        self.instrs: List[Instr] = []
        self.vreg_init: Dict[int, InitVal] = {}
        self._next_vreg = 1                      # vreg 0 == constant zero
        self._const_cache: Dict[int, int] = {0: 0}
        self.const_vregs: Dict[int, int] = {0: 0}  # vreg -> folded value
        self.words: Dict[int, List[int]] = {}    # netlist nid -> vregs (LSW..)
        self.outputs: Dict[str, List[int]] = {}
        self.mems: Dict[str, MemLayout] = {}

    # ------------------------------------------------------------------
    def vreg(self) -> int:
        v = self._next_vreg
        self._next_vreg += 1
        return v

    def const(self, value: int) -> int:
        value &= WORD_MASK
        if value not in self._const_cache:
            v = self.vreg()
            self.vreg_init[v] = value
            self._const_cache[value] = v
            self.const_vregs[v] = value
        return self._const_cache[value]

    def leaf(self, init: InitVal) -> int:
        v = self.vreg()
        self.vreg_init[v] = init
        return v

    def emit(self, op: Op, srcs: Sequence[int] = (), imm: int = 0,
             mem: Optional[str] = None, dst: Optional[int] = None) -> int:
        d = self.vreg() if dst is None else dst
        self.instrs.append(Instr(op, d, tuple(srcs), imm, mem=mem))
        return d

    # ---- word-vector helpers -----------------------------------------
    def _mask_top(self, ws: List[int], width: int) -> List[int]:
        """Mask the top word so stored words never exceed ``width`` bits."""
        top_bits = width % WORD_BITS
        if top_bits:
            m = self.const((1 << top_bits) - 1)
            ws = ws[:-1] + [self.emit(Op.AND, [ws[-1], m])]
        return ws

    def _add(self, a: List[int], b: List[int], width: int,
             sub: bool = False) -> List[int]:
        n = nwords(width)
        out, carry = [], 0  # vreg 0 == zero
        lo_op, hi_op = (Op.SUBB, Op.BORROW) if sub else (Op.ADDC, Op.CARRY)
        for j in range(n):
            out.append(self.emit(lo_op, [a[j], b[j], carry]))
            if j + 1 < n:
                carry = self.emit(hi_op, [a[j], b[j], carry])
        return self._mask_top(out, width)

    def _mul(self, a: List[int], b: List[int], width: int) -> List[int]:
        n = nwords(width)
        if n == 1:
            return self._mask_top([self.emit(Op.MUL, [a[0], b[0]])], width)
        # schoolbook: acc[k] accumulates lo(a_i*b_j) for i+j==k and
        # hi(a_i*b_j) for i+j==k-1, with full carry propagation.
        acc: List[int] = [0] * n
        for i in range(n):
            for j in range(n - i):
                k = i + j
                lo = self.emit(Op.MUL, [a[i], b[j]])
                acc = self._acc_into(acc, k, lo, n)
                if k + 1 < n:
                    hi = self.emit(Op.MULH, [a[i], b[j]])
                    acc = self._acc_into(acc, k + 1, hi, n)
        return self._mask_top(acc, width)

    def _acc_into(self, acc: List[int], k: int, v: int, n: int) -> List[int]:
        carry = 0
        for j in range(k, n):
            add = v if j == k else 0
            if add == 0 and carry == 0:
                break
            new = self.emit(Op.ADDC, [acc[j], add, carry])
            if j + 1 < n:
                carry = self.emit(Op.CARRY, [acc[j], add, carry])
            acc[j] = new
        return acc

    def _shift_static(self, ws: List[int], width: int, amount: int,
                      kind: str) -> List[int]:
        """Static SHL/SHR/SRA on a word vector."""
        n = nwords(width)
        if amount == 0:
            return list(ws)
        if amount >= width:
            if kind != "sra":
                return [0] * n
            amount = width - 1
        wsh, bsh = amount // WORD_BITS, amount % WORD_BITS

        fill = 0
        if kind == "sra":
            # fill word = 0xffff if sign bit set else 0
            top_bits = (width - 1) % WORD_BITS
            sign = self.emit(Op.SLICE, [ws[-1]], imm=top_bits * 32 + 1)
            fill = self.emit(Op.MUX, [sign, self.const(WORD_MASK), 0])
            # pre-extend the top word to a full 16 bits of sign
            tb = width % WORD_BITS
            if tb:
                ext = self.emit(Op.AND, [fill,
                                         self.const(WORD_MASK ^ ((1 << tb) - 1))])
                ws = ws[:-1] + [self.emit(Op.OR, [ws[-1], ext])]

        def src(j: int) -> int:
            if 0 <= j < n:
                return ws[j]
            return fill if kind == "sra" and j >= n else 0

        out = []
        for j in range(n):
            if kind == "shl":
                lo_w, hi_w = src(j - wsh - 1), src(j - wsh)
                if bsh == 0:
                    out.append(hi_w)
                else:
                    hi = self.emit(Op.SLL, [hi_w], imm=bsh)
                    lo = self.emit(Op.SRL, [lo_w], imm=WORD_BITS - bsh)
                    out.append(self.emit(Op.OR, [hi, lo]))
            else:
                lo_w, hi_w = src(j + wsh), src(j + wsh + 1)
                if bsh == 0:
                    out.append(lo_w)
                else:
                    lo = self.emit(Op.SRL, [lo_w], imm=bsh)
                    hi = self.emit(Op.SLL, [hi_w], imm=WORD_BITS - bsh)
                    out.append(self.emit(Op.OR, [hi, lo]))
        return self._mask_top(out, width)

    def _ne_acc(self, a: List[int], b: List[int]) -> int:
        """OR-reduction of per-word XOR: 0 iff equal."""
        diffs = [self.emit(Op.XOR, [x, y]) if (x or y) else 0
                 for x, y in zip(a, b)]
        acc = diffs[0]
        for d in diffs[1:]:
            acc = self.emit(Op.OR, [acc, d])
        return acc

    def _ltu(self, a: List[int], b: List[int]) -> int:
        borrow = 0
        for x, y in zip(a, b):
            borrow = self.emit(Op.BORROW, [x, y, borrow])
        return borrow

    # ---- memory addressing ---------------------------------------------
    def _local_addr(self, m: MemLayout, idx: List[int], word: int) -> int:
        base = self.leaf(Reloc(m.name, "lo", word))
        i = idx[0]
        if m.stride == 1:
            scaled = i
        elif m.stride & (m.stride - 1) == 0:
            scaled = self.emit(Op.SLL, [i], imm=m.stride.bit_length() - 1)
        else:
            scaled = self.emit(Op.MUL, [i, self.const(m.stride)])
        return self.emit(Op.ADD, [base, scaled])

    def _global_addr(self, m: MemLayout, idx: List[int],
                     word: int) -> Tuple[int, int]:
        """32-bit (hi, lo) word address into global memory."""
        base_lo = self.leaf(Reloc(m.name, "lo", word))
        base_hi = self.leaf(Reloc(m.name, "hi", word))
        i_lo = idx[0]
        i_hi = idx[1] if len(idx) > 1 else 0
        s = self.const(m.stride)
        lo = self.emit(Op.MUL, [i_lo, s])
        hi_c = self.emit(Op.MULH, [i_lo, s])
        hi_p = self.emit(Op.MUL, [i_hi, s]) if i_hi else 0
        hi = self.emit(Op.ADD, [hi_c, hi_p]) if hi_p else hi_c
        alo = self.emit(Op.ADDC, [base_lo, lo, 0])
        ac = self.emit(Op.CARRY, [base_lo, lo, 0])
        ahi0 = self.emit(Op.ADD, [base_hi, hi])
        ahi = self.emit(Op.ADD, [ahi0, ac])
        return ahi, alo

    # ------------------------------------------------------------------
    def run(self) -> Lowered:
        c = self.c
        # memory layouts first (strides known before any access)
        for name, m in c.mems.items():
            stride = nwords(m.width)
            init_words: List[int] = []
            for v in m.init:
                for w in range(stride):
                    init_words.append((v >> (w * WORD_BITS)) & WORD_MASK)
            self.mems[name] = MemLayout(name, m.depth, m.width, stride,
                                        m.is_global, init_words)

        regs: List[RegWords] = []
        order = _toposort(c)
        for n in order:
            self._lower_node(n)

        # Every next-register word must have a *unique* defining instruction
        # (it is a partitioning sink and a commit source); alias cases
        # (next = const / another register's current value / a value shared
        # with another register's next) get an explicit MOV. Never mutate
        # self.words — those vregs are other signals' identities.
        defined = {i.dst for i in self.instrs if i.writes() is not None}
        used_nxt: set = set()
        for rid, nxt_nid in c.reg_next.items():
            node = c.nodes[rid]
            ws = self.words[nxt_nid]
            fixed = []
            for w in ws:
                if w not in defined or w in used_nxt:
                    w = self.emit(Op.MOV, [w])
                used_nxt.add(w)
                fixed.append(w)
            regs.append(RegWords(
                name=c.reg_names.get(rid, f"reg{rid}"),
                width=node.width,
                cur=tuple(self.words[rid]),
                nxt=tuple(fixed),
                init=c.reg_init[rid]))

        return Lowered(c.name, self.instrs, self.vreg_init, regs, self.mems,
                       self.outputs, self._next_vreg,
                       const_vregs=dict(self.const_vregs))

    # ------------------------------------------------------------------
    def _lower_node(self, n: Node) -> None:
        c, a = self.c, n.args
        W = n.width
        get = lambda i: self.words[a[i]]

        if n.op == NOp.CONST:
            v = n.params["value"]
            self.words[n.nid] = [self.const((v >> (16 * j)) & WORD_MASK)
                                 for j in range(nwords(W))]
        elif n.op == NOp.INPUT:
            v = c.input_values[n.nid]
            self.words[n.nid] = [self.leaf((v >> (16 * j)) & WORD_MASK)
                                 for j in range(nwords(W))]
        elif n.op == NOp.REG:
            init = c.reg_init[n.nid]
            self.words[n.nid] = [self.leaf((init >> (16 * j)) & WORD_MASK)
                                 for j in range(nwords(W))]
        elif n.op in (NOp.AND, NOp.OR, NOp.XOR):
            op = {NOp.AND: Op.AND, NOp.OR: Op.OR, NOp.XOR: Op.XOR}[n.op]
            self.words[n.nid] = [self.emit(op, [x, y])
                                 for x, y in zip(get(0), get(1))]
        elif n.op == NOp.NOT:
            out = [self.emit(Op.NOT, [x]) for x in get(0)]
            self.words[n.nid] = self._mask_top(out, W)
        elif n.op == NOp.ADD:
            self.words[n.nid] = self._add(get(0), get(1), W)
        elif n.op == NOp.SUB:
            self.words[n.nid] = self._add(get(0), get(1), W, sub=True)
        elif n.op == NOp.MUL:
            self.words[n.nid] = self._mul(get(0), get(1), W)
        elif n.op in (NOp.EQ, NOp.NE):
            acc = self._ne_acc(get(0), get(1))
            op = Op.SEQ if n.op == NOp.EQ else Op.SNE
            self.words[n.nid] = [self.emit(op, [acc, 0])]
        elif n.op == NOp.LTU:
            self.words[n.nid] = [self._ltu(get(0), get(1))]
        elif n.op in (NOp.SHL, NOp.SHR, NOp.SRA):
            kind = {NOp.SHL: "shl", NOp.SHR: "shr", NOp.SRA: "sra"}[n.op]
            src_w = c.nodes[a[0]].width
            ws = self._shift_static(get(0), src_w, n.params["amount"], kind)
            self.words[n.nid] = ws[:nwords(W)]
        elif n.op == NOp.MUX:
            sel = get(0)[0]
            self.words[n.nid] = [self.emit(Op.MUX, [sel, x, y])
                                 for x, y in zip(get(1), get(2))]
        elif n.op == NOp.SLICE:
            off, width = n.params["off"], n.params["w"]
            src_w = c.nodes[a[0]].width
            shifted = self._shift_static(get(0), src_w, off, "shr")
            out = shifted[:nwords(width)]
            self.words[n.nid] = self._mask_top(out, width)
        elif n.op == NOp.CAT:
            hi, lo = get(0), get(1)
            lo_w = c.nodes[a[1]].width
            n_out = nwords(W)
            # shift hi left by lo_w within the W-bit result
            hi_ext = list(hi) + [0] * (n_out - len(hi))
            hi_shifted = self._shift_static(hi_ext, W, lo_w, "shl")
            lo_ext = lo + [0] * (n_out - len(lo))
            self.words[n.nid] = [
                self.emit(Op.OR, [h, l]) if (h and l) else (h or l)
                for h, l in zip(hi_shifted, lo_ext)]
        elif n.op == NOp.MEMRD:
            m = self.mems[n.params["mem"]]
            idx = get(0)
            out = []
            for w in range(m.stride):
                if m.is_global:
                    ahi, alo = self._global_addr(m, idx, w)
                    out.append(self.emit(Op.GLD, [ahi, alo], mem=m.name))
                else:
                    addr = self._local_addr(m, idx, w)
                    out.append(self.emit(Op.LD, [addr], mem=m.name))
            self.words[n.nid] = self._mask_top(out[:nwords(W)], W)
        elif n.op == NOp.MEMWR:
            m = self.mems[n.params["mem"]]
            idx, data, en = get(0), get(1), get(2)[0]
            for w in range(m.stride):
                d = data[w] if w < len(data) else 0
                if m.is_global:
                    ahi, alo = self._global_addr(m, idx, w)
                    self.emit(Op.GST, [ahi, alo, d, en], mem=m.name)
                else:
                    addr = self._local_addr(m, idx, w)
                    self.emit(Op.ST, [addr, d, en], mem=m.name)
        elif n.op == NOp.EXPECT:
            acc = self._ne_acc(get(0), get(1))
            self.emit(Op.EXPECT, [acc, 0], imm=n.params["eid"])
        elif n.op == NOp.OUTPUT:
            name = n.params["name"]
            outs = [self.emit(Op.MOV, [w]) for w in get(0)]
            self.outputs[name] = outs
        else:  # pragma: no cover
            raise NotImplementedError(n.op)


def _toposort(c: Circuit) -> List[Node]:
    order: List[Node] = []
    state = [0] * len(c.nodes)
    for root in range(len(c.nodes)):
        if state[root]:
            continue
        stack = [(root, 0)]
        while stack:
            nid, ai = stack.pop()
            node = c.nodes[nid]
            if ai == 0:
                if state[nid] == 2:
                    continue
                state[nid] = 1
            if ai < len(node.args):
                stack.append((nid, ai + 1))
                if state[node.args[ai]] == 0:
                    stack.append((node.args[ai], 0))
            else:
                state[nid] = 2
                order.append(node)
    return order


def lower(circuit: Circuit) -> Lowered:
    return Lowerer(circuit).run()
