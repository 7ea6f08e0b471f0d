# Copy of src/repro/core/isa.py (commit aa57dc1); imports may differ.
"""Manticore lower-assembly ISA (16-bit datapath).

The ISA mirrors the paper (§4.2): word size is 16 bits, every instruction has
fixed unit latency from the scheduler's point of view (data hazards are
resolved by compiler-inserted NOps), branches do not exist (predication only),
and the only cross-core primitive is SEND whose register update is deferred to
the end of the virtual cycle (Vcycle).

Instruction layout (7 int fields, unpacked):

    (op, dst, s1, s2, s3, s4, imm)

``dst``/``s*`` are register indices into the per-core register file
(default 2048 entries, r0 hard-wired to zero). ``imm`` is an opcode-specific
immediate (shift amount, slice spec, LUT table index, exception id, SEND
destination encoding).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WORD_BITS = 16
WORD_MASK = (1 << WORD_BITS) - 1
NUM_REGS = 2048           # paper: 2048-entry BRAM register file
NUM_LUTS = 32             # paper: 32 programmable custom functions per core
LUT_INPUTS = 4
SPAD_WORDS = 16384        # paper: 128 KiB URAM scratchpad as 16384 x 16-bit
ZERO_REG = 0              # r0 == 0 by convention (reserved by regalloc)


class Op(enum.IntEnum):
    NOP = 0
    MOV = 1       # dst = s1
    MOVI = 2      # dst = imm                      (used by boot/setup only)
    ADD = 3       # dst = (s1 + s2) & mask
    ADDC = 4      # dst = (s1 + s2 + s3) & mask    (s3 is a 0/1 carry reg)
    CARRY = 5     # dst = (s1 + s2 + s3) >> 16     (carry out of wide add)
    SUB = 6       # dst = (s1 - s2) & mask
    SUBB = 7      # dst = (s1 - s2 - s3) & mask    (s3 is a 0/1 borrow reg)
    BORROW = 8    # dst = 1 if s1 - s2 - s3 < 0 else 0
    MUL = 9       # dst = (s1 * s2) & mask
    MULH = 10     # dst = (s1 * s2) >> 16
    AND = 11
    OR = 12
    XOR = 13
    NOT = 14      # dst = ~s1
    MUX = 15      # dst = s2 if s1 != 0 else s3
    SEQ = 16      # dst = (s1 == s2)
    SNE = 17      # dst = (s1 != s2)
    SLTU = 18     # dst = (s1 < s2), unsigned
    SLL = 19      # dst = (s1 << imm) & mask
    SRL = 20      # dst = s1 >> imm
    SRA = 21      # dst = sign-extended s1 >> imm
    SLLV = 22     # dst = (s1 << (s2 & 15)) & mask
    SRLV = 23     # dst = s1 >> (s2 & 15)
    SLICE = 24    # dst = (s1 >> off) & ((1<<width)-1); imm = off*32 + width
    LUT = 25      # dst = CFU[imm](s1, s2, s3, s4)   (per-bit-lane 4-LUT)
    LD = 26       # dst = spad[s1]
    ST = 27       # if s3: spad[s1] = s2             (stores are predicated)
    GLD = 28      # dst = gmem[s1*65536 + s2]        (privileged)
    GST = 29      # if s4: gmem[s1*65536 + s2] = s3  (privileged)
    SEND = 30     # send s1 to core imm>>16, register imm&0xffff (dst mirrors)
    EXPECT = 31   # if s1 != s2: raise exception imm (privileged)


# Opcodes that only the privileged core may execute (paper §4.2).
PRIVILEGED_OPS = frozenset({Op.GLD, Op.GST, Op.EXPECT})
# Bitwise ops eligible for custom-function (LUT) fusion (paper §6.2).
LOGIC_OPS = frozenset({Op.AND, Op.OR, Op.XOR, Op.NOT})
# Ops with no register result.
NO_RESULT_OPS = frozenset({Op.NOP, Op.ST, Op.GST, Op.EXPECT})
# SEND "result" is defined as the forwarded value (the engine traces it).

# Opcodes with observable effects beyond their register result — never
# eliminated, reordered across same-memory ops, or value-numbered.
SIDE_EFFECT_OPS = frozenset({Op.ST, Op.GST, Op.EXPECT, Op.SEND})
# Memory reads: not pure (result depends on memory state), but full-cycle
# semantics order every load of a memory before its first store, so two
# loads of the same (memory, address) within one Vcycle are equivalent.
MEM_READ_OPS = frozenset({Op.LD, Op.GLD})
# Register-to-register opcodes whose result is a pure function of operands
# and imm — foldable, substitutable and value-numberable by core.opt.
PURE_OPS = frozenset({
    Op.MOV, Op.MOVI, Op.ADD, Op.ADDC, Op.CARRY, Op.SUB, Op.SUBB, Op.BORROW,
    Op.MUL, Op.MULH, Op.AND, Op.OR, Op.XOR, Op.NOT, Op.MUX, Op.SEQ, Op.SNE,
    Op.SLTU, Op.SLL, Op.SRL, Op.SRA, Op.SLLV, Op.SRLV, Op.SLICE,
})
# Pure ops where the first two operands commute (canonicalized by GVN).
COMMUTATIVE_OPS = frozenset({
    Op.ADD, Op.ADDC, Op.CARRY, Op.MUL, Op.MULH, Op.AND, Op.OR, Op.XOR,
    Op.SEQ, Op.SNE,
})

NUM_FIELDS = 7  # (op, dst, s1, s2, s3, s4, imm)


@dataclass
class Instr:
    """One lower-assembly instruction over *virtual* registers.

    Virtual register namespace is global (SSA values); regalloc maps them to
    per-core machine registers.
    """
    op: Op
    dst: int = 0
    srcs: Tuple[int, ...] = ()
    imm: int = 0
    # --- metadata used by the compiler (not encoded) ---
    # memory identity for LD/ST (keeps same-memory ops in one process)
    mem: Optional[str] = None
    # SEND routing (filled by partitioner): destination process / vreg
    send_dst_proc: Optional[int] = None
    send_dst_vreg: Optional[int] = None

    def reads(self) -> Tuple[int, ...]:
        return self.srcs

    def writes(self) -> Optional[int]:
        if self.op in NO_RESULT_OPS:
            return None
        return self.dst

    def is_privileged(self) -> bool:
        return self.op in PRIVILEGED_OPS

    def __repr__(self) -> str:  # compact, for debugging
        s = ",".join(f"v{r}" for r in self.srcs)
        return f"{self.op.name} v{self.dst} {s} #{self.imm}"


def encode(op: Op, dst: int, s1: int = 0, s2: int = 0, s3: int = 0,
           s4: int = 0, imm: int = 0) -> Tuple[int, ...]:
    """Encode to the 7-int machine form consumed by the executors."""
    return (int(op), dst, s1, s2, s3, s4, imm)


@dataclass
class HardwareConfig:
    """Machine parameters. Defaults mirror the paper's U200 prototype."""
    grid_width: int = 15
    grid_height: int = 15
    num_regs: int = NUM_REGS
    num_luts: int = NUM_LUTS
    spad_words: int = SPAD_WORDS
    imem_slots: int = 4096          # paper: 4096 x 64b URAM instruction memory
    raw_latency: int = 4            # slots until a result is readable (exec
                                    # stage is pipelined over 4 stages, §5.1)
    send_latency: int = 1           # slots per NoC hop (unidirectional torus)
    gmem_words: int = 1 << 22       # 8 MiB of 16-bit global memory
    cache_words: int = 1 << 16      # 128 KiB direct-mapped cache (§5.3)
    cache_line_words: int = 32      # 64-byte lines
    cache_hit_stall: int = 14       # global stall cycles on a cache hit
    cache_miss_stall: int = 120     # global stall cycles on a miss (DRAM)

    @property
    def num_cores(self) -> int:
        return self.grid_width * self.grid_height

    def core_xy(self, core: int) -> Tuple[int, int]:
        return core % self.grid_width, core // self.grid_width

    def xy_core(self, x: int, y: int) -> int:
        return (y % self.grid_height) * self.grid_width + (x % self.grid_width)

    def route_hops(self, src: int, dst: int) -> int:
        """Hop count of the dimension-ordered (+x then +y) route on the
        uni-directional torus; 0 for a self-send (a local move that never
        touches the NoC)."""
        sx, sy = self.core_xy(src)
        dx, dy = self.core_xy(dst)
        return (dx - sx) % self.grid_width + (dy - sy) % self.grid_height
