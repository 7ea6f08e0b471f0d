# Copy of src/repro/core/netlist.py (commit aa57dc1); imports may differ.
"""Netlist IR + circuit-builder DSL.

The paper's frontend is Yosys (Verilog -> netlist assembly). Rebuilding Yosys
is out of scope; this module provides the equivalent *netlist IR* plus an
embedded-Python builder DSL so the 9 evaluation benchmarks can be expressed
directly (see ``repro.circuits``). Semantics are single-clock, full-cycle,
cycle-accurate (paper §2):

  * a cycle evaluates the combinational DAG from *current* register / memory
    state, producing *next* register values, memory writes, and exceptions;
  * state commits atomically at the cycle boundary.

Signals are SSA values with a width of 1..64 bits (wider RTL values are
composed from several signals by the benchmark builders, exactly as the
paper's frontend legalizes wide Verilog vectors into 16-bit words later on).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

MAX_WIDTH = 64


class NOp(enum.Enum):
    """Netlist node kinds (word-level, arbitrary width <= 64)."""
    INPUT = "input"      # host-driven primary input (constant-latched)
    CONST = "const"
    REG = "reg"          # current value of a register
    AND = "and"
    OR = "or"
    XOR = "xor"
    NOT = "not"
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    EQ = "eq"
    NE = "ne"
    LTU = "ltu"
    SHL = "shl"          # static shift, params["amount"]
    SHR = "shr"
    SRA = "sra"
    MUX = "mux"          # args = (sel, a, b): sel ? a : b
    SLICE = "slice"      # params: off, width
    CAT = "cat"          # args = (hi, lo); width = hi.w + lo.w
    MEMRD = "memrd"      # combinational read of memory params["mem"]
    # sinks (no value):
    MEMWR = "memwr"      # args = (addr, data, en)
    EXPECT = "expect"    # args = (a, b); raise params["eid"] if a != b
    OUTPUT = "output"    # host-visible value, params["name"]

SINK_OPS = frozenset({NOp.MEMWR, NOp.EXPECT, NOp.OUTPUT})
LOGIC_NOPS = frozenset({NOp.AND, NOp.OR, NOp.XOR, NOp.NOT})


@dataclass(frozen=True)
class Sig:
    """Handle to a netlist node (SSA value)."""
    nid: int
    width: int
    circuit: "Circuit" = field(repr=False, compare=False, hash=False)

    # -- operator sugar -------------------------------------------------
    def _lift(self, other) -> "Sig":
        if isinstance(other, Sig):
            return other
        return self.circuit.const(int(other), self.width)

    def __and__(self, o): return self.circuit._bin(NOp.AND, self, self._lift(o))
    def __or__(self, o):  return self.circuit._bin(NOp.OR, self, self._lift(o))
    def __xor__(self, o): return self.circuit._bin(NOp.XOR, self, self._lift(o))
    def __invert__(self): return self.circuit._node(NOp.NOT, [self], self.width)
    def __add__(self, o): return self.circuit._bin(NOp.ADD, self, self._lift(o))
    def __sub__(self, o): return self.circuit._bin(NOp.SUB, self, self._lift(o))
    def __mul__(self, o): return self.circuit._bin(NOp.MUL, self, self._lift(o))
    def __lshift__(self, k: int):
        return self.circuit._node(NOp.SHL, [self], self.width, amount=int(k))
    def __rshift__(self, k: int):
        return self.circuit._node(NOp.SHR, [self], self.width, amount=int(k))

    def eq(self, o):  return self.circuit._cmp(NOp.EQ, self, self._lift(o))
    def ne(self, o):  return self.circuit._cmp(NOp.NE, self, self._lift(o))
    def ltu(self, o): return self.circuit._cmp(NOp.LTU, self, self._lift(o))
    def geu(self, o): return ~self.ltu(o)

    def __getitem__(self, sl) -> "Sig":
        """Bit slicing: s[3], s[7:4] (verilog-style msb:lsb inclusive)."""
        if isinstance(sl, int):
            off, width = sl, 1
        else:
            msb = sl.start if sl.start is not None else self.width - 1
            lsb = sl.stop if sl.stop is not None else 0
            off, width = lsb, msb - lsb + 1
        assert 0 <= off and off + width <= self.width, (off, width, self.width)
        return self.circuit._node(NOp.SLICE, [self], width, off=off, w=width)

    def cat(self, lo: "Sig") -> "Sig":
        """{self, lo} — self becomes the high bits."""
        return self.circuit._node(NOp.CAT, [self, lo], self.width + lo.width)

    def zext(self, width: int) -> "Sig":
        if width == self.width:
            return self
        assert width > self.width
        return self.circuit.const(0, width - self.width).cat(self)

    def sext(self, width: int) -> "Sig":
        if width == self.width:
            return self
        sign = self[self.width - 1]
        ext = self.circuit.mux(sign,
                               self.circuit.const((1 << (width - self.width)) - 1,
                                                  width - self.width),
                               self.circuit.const(0, width - self.width))
        return ext.cat(self)

    def trunc(self, width: int) -> "Sig":
        return self if width == self.width else self[width - 1:0]


@dataclass
class Node:
    nid: int
    op: NOp
    args: Tuple[int, ...]
    width: int
    params: Dict

@dataclass
class Memory:
    name: str
    depth: int
    width: int
    init: List[int]
    is_global: bool = False   # does not fit scratchpads -> privileged GLD/GST


class Circuit:
    """Builder + container for a single-clock netlist."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []
        self.mems: Dict[str, Memory] = {}
        self.reg_next: Dict[int, int] = {}     # reg nid -> next-value nid
        self.reg_init: Dict[int, int] = {}     # reg nid -> reset value
        self.reg_names: Dict[int, str] = {}
        self.input_values: Dict[int, int] = {}  # INPUT nid -> latched value
        self._const_cache: Dict[Tuple[int, int], int] = {}

    # ---- node construction --------------------------------------------
    def _node(self, op: NOp, args: Sequence[Sig], width: int, **params) -> Sig:
        assert 1 <= width <= MAX_WIDTH, width
        nid = len(self.nodes)
        self.nodes.append(Node(nid, op, tuple(a.nid for a in args), width,
                               params))
        return Sig(nid, width, self)

    def _bin(self, op: NOp, a: Sig, b: Sig) -> Sig:
        assert a.width == b.width, (op, a.width, b.width)
        return self._node(op, [a, b], a.width)

    def _cmp(self, op: NOp, a: Sig, b: Sig) -> Sig:
        assert a.width == b.width, (op, a.width, b.width)
        return self._node(op, [a, b], 1)

    def input(self, name: str, width: int, value: int = 0) -> Sig:
        s = self._node(NOp.INPUT, [], width, name=name)
        self.input_values[s.nid] = value & ((1 << width) - 1)
        return s

    def const(self, value: int, width: int) -> Sig:
        value &= (1 << width) - 1
        key = (value, width)
        if key not in self._const_cache:
            s = self._node(NOp.CONST, [], width, value=value)
            self._const_cache[key] = s.nid
        return Sig(self._const_cache[key], width, self)

    def reg(self, width: int, init: int = 0, name: Optional[str] = None) -> Sig:
        s = self._node(NOp.REG, [], width)
        self.reg_init[s.nid] = init & ((1 << width) - 1)
        if name:
            self.reg_names[s.nid] = name
        return s

    def set_next(self, r: Sig, nxt: Sig) -> None:
        assert self.nodes[r.nid].op == NOp.REG
        assert r.width == nxt.width, (r.width, nxt.width)
        assert r.nid not in self.reg_next, "register already driven"
        self.reg_next[r.nid] = nxt.nid

    def mux(self, sel: Sig, a: Sig, b: Sig) -> Sig:
        """sel ? a : b"""
        assert sel.width == 1 and a.width == b.width
        return self._node(NOp.MUX, [sel, a, b], a.width)

    # ---- memories ------------------------------------------------------
    def mem(self, name: str, depth: int, width: int,
            init: Optional[Sequence[int]] = None,
            is_global: bool = False) -> Memory:
        assert name not in self.mems
        vals = list(init) if init is not None else [0] * depth
        assert len(vals) == depth
        m = Memory(name, depth, width, [v & ((1 << width) - 1) for v in vals],
                   is_global=is_global)
        self.mems[name] = m
        return m

    def mem_read(self, m: Memory, addr: Sig) -> Sig:
        return self._node(NOp.MEMRD, [addr], m.width, mem=m.name)

    def mem_write(self, m: Memory, addr: Sig, data: Sig, en: Sig) -> None:
        assert data.width == m.width and en.width == 1
        self._node(NOp.MEMWR, [addr, data, en], 1, mem=m.name)

    # ---- sinks -----------------------------------------------------------
    def expect_eq(self, a: Sig, b: Sig, eid: int) -> None:
        """Raise exception ``eid`` when a != b (paper's EXPECT, §4.2)."""
        assert a.width == b.width
        self._node(NOp.EXPECT, [a, b], 1, eid=eid)

    def finish_when(self, cond: Sig, eid: int = 1) -> None:
        """$finish analogue: raise ``eid`` when cond is non-zero."""
        assert cond.width == 1
        self.expect_eq(cond, self.const(0, 1), eid)

    def output(self, name: str, sig: Sig) -> None:
        self._node(NOp.OUTPUT, [sig], sig.width, name=name)

    # ---- composite helpers used by benchmark circuits -------------------
    def shl_dyn(self, v: Sig, amt: Sig) -> Sig:
        """Dynamic left shift via a mux barrel (log2 stages of static shifts)."""
        out = v
        for k in range(amt.width):
            if (1 << k) >= v.width:
                break
            out = self.mux(amt[k], out << (1 << k), out)
        # amounts >= width zero the value
        big = self.const(0, v.width)
        hi_bits = [amt[k] for k in range(amt.width) if (1 << k) >= v.width]
        for b in hi_bits:
            out = self.mux(b, big, out)
        return out

    def shr_dyn(self, v: Sig, amt: Sig, arith: bool = False) -> Sig:
        out = v
        for k in range(amt.width):
            if (1 << k) >= v.width:
                break
            shifted = self._node(NOp.SRA if arith else NOp.SHR, [out], v.width,
                                 amount=(1 << k))
            out = self.mux(amt[k], shifted, out)
        if not arith:
            big = self.const(0, v.width)
            hi_bits = [amt[k] for k in range(amt.width) if (1 << k) >= v.width]
            for b in hi_bits:
                out = self.mux(b, big, out)
        return out

    def sra(self, v: Sig, k: int) -> Sig:
        return self._node(NOp.SRA, [v], v.width, amount=int(k))

    def lts(self, a: Sig, b: Sig) -> Sig:
        """Signed less-than via the unsigned compare with flipped sign bits."""
        bias = self.const(1 << (a.width - 1), a.width)
        return (a ^ bias).ltu(b ^ bias)

    def reduce_or(self, s: Sig) -> Sig:
        return s.ne(self.const(0, s.width))

    def onehot_mux(self, sel: Sig, options: Sequence[Sig]) -> Sig:
        """options[sel] as a mux tree (sel is an index)."""
        opts = list(options)
        assert opts, "empty mux"
        k = 0
        while len(opts) > 1:
            nxt = []
            for i in range(0, len(opts) - 1, 2):
                nxt.append(self.mux(sel[k], opts[i + 1], opts[i]))
            if len(opts) % 2 == 1:
                nxt.append(opts[-1])
            opts = nxt
            k += 1
        return opts[0]

    # ---- stats -----------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        per_op: Dict[str, int] = {}
        for n in self.nodes:
            per_op[n.op.value] = per_op.get(n.op.value, 0) + 1
        return {
            "nodes": len(self.nodes),
            "regs": len(self.reg_init),
            "mems": len(self.mems),
            "mem_bits": sum(m.depth * m.width for m in self.mems.values()),
            **{f"op_{k}": v for k, v in sorted(per_op.items())},
        }

    def validate(self) -> None:
        for rid in self.reg_init:
            assert rid in self.reg_next, \
                f"register {self.reg_names.get(rid, rid)} has no next value"
        for n in self.nodes:
            if n.op == NOp.MEMRD or n.op == NOp.MEMWR:
                assert n.params["mem"] in self.mems

    def fingerprint(self) -> str:
        """Structural SHA-256 of the netlist — the identity the
        ``repro.sim`` compile cache keys on. Covers everything that can
        change simulation semantics or the compiled binary: every node
        (op, args, width, params), every memory (shape + init image +
        placement class), the register init/next/name maps and the latched
        input values. Two independent builds of the same design hash
        equal; any semantic difference does not.
        """
        import hashlib
        h = hashlib.sha256()

        def feed(*parts) -> None:
            for p in parts:
                h.update(repr(p).encode("utf-8"))
                h.update(b"\x00")

        feed("circuit", self.name, len(self.nodes))
        for n in self.nodes:
            feed(n.nid, n.op.value, n.args, n.width,
                 sorted(n.params.items()))
        for name in sorted(self.mems):
            m = self.mems[name]
            feed("mem", name, m.depth, m.width, tuple(m.init), m.is_global)
        feed("reg_next", sorted(self.reg_next.items()))
        feed("reg_init", sorted(self.reg_init.items()))
        feed("reg_names", sorted(self.reg_names.items()))
        feed("inputs", sorted(self.input_values.items()))
        return h.hexdigest()
