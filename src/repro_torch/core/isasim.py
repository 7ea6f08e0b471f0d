# Copy of src/repro/core/isasim.py (commit aa57dc1); imports may differ.
"""Numpy ISA simulator for compiled Programs.

The paper (§6) keeps interpreters for both IRs to validate compiler passes;
this is ours for the *lower* level: a direct, jit-free executor of the
binary + exchange schedule. Used heavily by the hypothesis property tests
(fast per-example, no XLA compile) and as a second, independent oracle
against the jnp/Pallas engines.

Like the engines, the simulator is partially evaluated against the static
code stream: at construction every slot is grouped by opcode (the groups
never change — the schedule is static), so a Vcycle is a handful of
vectorized numpy ops over core batches instead of a Python loop over every
(slot, core) pair, and SEND values are captured compactly instead of via a
full [T, C] trace.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .compile import Program
from .isa import Op

M = 0xFFFF


class IsaSim:
    def __init__(self, prog: Program):
        self.p = prog
        C = prog.used_cores
        self.C = C
        self.code = prog.code[:C]          # [C, T, 7]
        self.luts = prog.luts[:C].astype(np.uint32)
        # active-register compaction, mirroring core.bsp.Machine
        self.R = prog.used_reg_count()
        self.regs = prog.reg_init[:C, :self.R].astype(np.uint32).copy()
        self.spads = prog.spad_init[:C].astype(np.uint32).copy()
        self.gmem = prog.gmem_init.astype(np.uint32).copy()
        self.flags = np.zeros((C,), np.uint32)
        self.cycle = 0
        # ---- static partial evaluation of the slot loop ----
        # per slot: one entry per opcode present, with the core batch
        # executing it (see compile.slot_groups)
        from .compile import slot_groups
        slots = slot_groups(prog, C)
        self._n_sends = prog.n_sends
        self._xd_core = prog.xchg_dst_core
        self._xd_reg = prog.xchg_dst_reg
        # Rotated dispatch for modulo-pipelined programs: the first
        # ``pipe_prologue`` slots of the stream are pure recomputations of
        # the next Vcycle's hoisted carries.  They run once up front
        # (iteration 0's prologue) and thereafter as a gated tail after each
        # exchange, so every ``step()`` boundary observes fully committed
        # architectural state.
        self._P = int(prog.pipe_prologue)
        self._pro = slots[:self._P]
        self._body = slots[self._P:]
        if self._P:
            self._run_groups(self._pro)

    # ------------------------------------------------------------------
    def _exec_group(self, op: Op, cores, dst, s1, s2, s3, s4, imm,
                    sbuf, sid) -> None:
        """Execute one (opcode, core-batch) group of a slot, vectorized."""
        r = self.regs
        v1 = r[cores, s1]
        v2 = r[cores, s2]
        if op == Op.ST:
            v3 = r[cores, s3]
            addr = v1 % self.spads.shape[1]
            m = v3 != 0
            self.spads[cores[m], addr[m]] = v2[m]
            return
        if op == Op.GST:
            v3 = r[cores, s3]
            v4 = r[cores, s4]
            addr = ((v1.astype(np.uint64) << 16) | v2) % len(self.gmem)
            m = v4 != 0
            self.gmem[addr[m]] = v3[m]
            return
        if op == Op.EXPECT:
            m = (v1 != v2) & (self.flags[cores] == 0)
            self.flags[cores[m]] = imm[m]
            return

        if op == Op.MOV:
            res = v1
        elif op == Op.MOVI:
            res = imm & M
        elif op == Op.ADD:
            res = (v1 + v2) & M
        elif op == Op.ADDC:
            res = (v1 + v2 + r[cores, s3]) & M
        elif op == Op.CARRY:
            res = (v1 + v2 + r[cores, s3]) >> 16
        elif op == Op.SUB:
            res = (v1 - v2) & M
        elif op == Op.SUBB:
            res = (v1 - v2 - r[cores, s3]) & M
        elif op == Op.BORROW:
            res = (v1 < v2 + r[cores, s3]).astype(np.uint32)
        elif op == Op.MUL:
            res = (v1 * v2) & M
        elif op == Op.MULH:
            res = (v1 * v2) >> 16
        elif op == Op.AND:
            res = v1 & v2
        elif op == Op.OR:
            res = v1 | v2
        elif op == Op.XOR:
            res = v1 ^ v2
        elif op == Op.NOT:
            res = (~v1) & M
        elif op == Op.MUX:
            res = np.where(v1 != 0, v2, r[cores, s3])
        elif op == Op.SEQ:
            res = (v1 == v2).astype(np.uint32)
        elif op == Op.SNE:
            res = (v1 != v2).astype(np.uint32)
        elif op == Op.SLTU:
            res = (v1 < v2).astype(np.uint32)
        elif op == Op.SLL:
            res = (v1 << (imm & 15)) & M
        elif op == Op.SRL:
            res = v1 >> (imm & 15)
        elif op == Op.SRA:
            sv = ((v1 ^ 0x8000).astype(np.uint32) - 0x8000).astype(np.int32)
            res = (sv >> (imm & 15)).astype(np.uint32) & M
        elif op == Op.SLLV:
            res = (v1 << (v2 & 15)) & M
        elif op == Op.SRLV:
            res = v1 >> (v2 & 15)
        elif op == Op.SLICE:
            res = (v1 >> (imm >> 5)) & \
                ((np.uint32(1) << (imm & 31)) - 1)
        elif op == Op.LUT:
            tt = self.luts[cores,
                           np.minimum(imm, self.luts.shape[1] - 1)]  # [n,16]
            v3 = r[cores, s3]
            v4 = r[cores, s4]
            nv = [(~x) & M for x in (v1, v2, v3, v4)]
            res = np.zeros(len(cores), np.uint32)
            for p in range(16):
                pm = (v1 if p & 1 else nv[0]) & (v2 if p & 2 else nv[1]) \
                    & (v3 if p & 4 else nv[2]) & (v4 if p & 8 else nv[3])
                res = res | (pm & tt[:, p])
        elif op == Op.LD:
            res = self.spads[cores, v1 % self.spads.shape[1]]
        elif op == Op.GLD:
            addr = ((v1.astype(np.uint64) << 16) | v2) % len(self.gmem)
            res = self.gmem[addr]
        elif op == Op.SEND:
            sbuf[sid] = v1 & M
            return
        else:  # pragma: no cover — exhaustive over the ISA
            raise ValueError(f"unhandled opcode {op}")

        res = (res & M).astype(np.uint32)
        sbuf[sid] = res
        m = dst != 0
        self.regs[cores[m], dst[m]] = res[m]

    def _run_groups(self, slot_list) -> None:
        """Execute a list of slot groups against a throwaway send buffer."""
        sbuf = np.zeros((self._n_sends + 1,), np.uint32)
        for groups in slot_list:
            for (op, cores, dst, s1, s2, s3, s4, imm, sid) in groups:
                self._exec_group(op, cores, dst, s1, s2, s3, s4, imm,
                                 sbuf, sid)

    def step(self) -> None:
        """One Vcycle: grouped vectorized slot loop + compact BSP exchange."""
        sbuf = np.zeros((self._n_sends + 1,), np.uint32)
        for groups in self._body:
            for (op, cores, dst, s1, s2, s3, s4, imm, sid) in groups:
                self._exec_group(op, cores, dst, s1, s2, s3, s4, imm,
                                 sbuf, sid)
        if self._n_sends:
            self.regs[self._xd_core, self._xd_reg] = sbuf[:self._n_sends]
        self.cycle += 1
        if self._P and not self.flags.any():
            self._run_groups(self._pro)

    def run(self, max_cycles: int) -> int:
        for _ in range(max_cycles):
            if self.flags.any():
                break
            self.step()
        return self.cycle

    def read_reg(self, name: str) -> int:
        out = 0
        for j, locs in enumerate(self.p.state_regs[name]):
            c, r = locs[0]
            out |= int(self.regs[c, r]) << (16 * j)
        return out

    def exceptions(self) -> Dict[int, int]:
        return {c: int(e) for c, e in enumerate(self.flags) if e}
