"""The 32-byte code row both Vcycle kernels execute, laid out at bind time.

A row holds one instruction of one core in eight 32-bit words: two 16-byte
loads bring it, and the first 16 bytes hold all that a row needs but its
capture index, so the kernels stage those in shared memory
(``csrc/isa.cuh``, ``StagedRows``)::

    word 0   op | WRITES | GLOBAL | dst << 16
    word 1   s1 | s2 << 16
    word 2   s3 | s4 << 16
    word 3   imm; for a LUT row, the index of its truth table in ``tts``
    word 4   the capture index into the SEND buffer (outside
             ``[0, n_sends)``: the row captures nothing)
    word 5   the row's slot t in the dense stream
    words 6, 7   zero

The opcode takes 5 bits; ``WRITES`` (bit 5) marks a row that writes its
destination (``dst != 0`` and an opcode with a register result) and
``GLOBAL`` (bit 6) a GLD or GST, so a kernel tests one bit for each. Register fields are
16-bit halves. ``pack`` raises on an opcode outside the ISA and on a
register index the row cannot hold. A LUT row's table is resolved here, once: its
immediate clamped to the core's last table as the ISA clamps it (unsigned
``min(imm, L - 1)``), the 16 words looked up, and the row pointed at that
table's index in ``tts [U, 16]``, which holds each distinct table once.

``chunk_rows`` lays out the chunk kernel's per-core compacted lists: core
c's live body rows ``[num_pro, T)``, then its live prologue rows
``[0, num_pro)``, each in slot order. A row is live when its opcode is not
NOP; a body NOP row that captures a SEND value is kept too, since it
writes 0 into the buffer. Within a Vcycle a core touches only its own
registers, scratchpad and flag, and GLD/GST sit on one core, so running
each core's live rows back to back in slot order gives the dense stream's
results. ``seed_rows`` lays out the seed kernel's dense stream: every slot
of every core, NOPs included, in slot order.

``walk_chunk``, ``walk_prologue`` and ``walk_seed`` are plain walkers over
these tables: in Python, row by row and core by core, what the kernels do.
The tests hold them against ``vcycle_chunk_ref``, ``prologue_ref`` and
``vcycle_seed_ref``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.isa import Op
from .ref import NO_WRITE_OPS

ROW_WORDS = 8
FIELD_LIMIT = 1 << 16      # register fields are 16 bits wide
OP_BITS = 0x1F
WRITES = 0x20
GLOBAL = 0x40
MASK = 0xFFFF
U32 = 0xFFFFFFFF
NO_CAPTURE = -1


class RowTables(NamedTuple):
    """One program's code rows on the kernel's device.

    ``rows [N, 8]``: each core's rows, core after core. ``ctab [C, 4]``:
    core c's first row, its body rows, its prologue rows, 0. ``tts
    [max(U, 1), 16]``: the distinct LUT truth tables (``n_tts = U``).
    ``busy``: the most rows one core runs a Vcycle."""
    rows: torch.Tensor
    ctab: torch.Tensor
    tts: torch.Tensor
    n_tts: int
    busy: int

    @property
    def n_rows(self) -> int:
        return int(self.rows.shape[0])


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def pack(fields: np.ndarray, cap: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """``fields [n, 7]`` (op, dst, s1..s4, imm), ``cap [n]`` and ``slot
    [n]`` -> int32 rows ``[n, 8]``. Raises ``ValueError`` on an opcode
    outside the ISA or a register index outside ``[0, 2**16)``."""
    f = fields.astype(np.int64)
    op, regs = f[:, 0], f[:, 1:6]
    if op.size and (op.min() < 0 or op.max() >= len(Op)):
        bad = op[(op < 0) | (op >= len(Op))][0]
        raise ValueError(f"code row: opcode {int(bad)} is not an ISA "
                         "opcode")
    if regs.size and (regs.min() < 0 or regs.max() >= FIELD_LIMIT):
        bad = regs[(regs < 0) | (regs >= FIELD_LIMIT)][0]
        raise ValueError(f"code row: register field {int(bad)} does not fit "
                         "the row's 16 bits")
    writes = (f[:, 1] != 0) & ~np.isin(op, [int(o) for o in NO_WRITE_OPS])
    glob = (op == int(Op.GLD)) | (op == int(Op.GST))
    w = np.zeros((f.shape[0], ROW_WORDS), np.uint64)
    w[:, 0] = op | np.where(writes, WRITES, 0) | np.where(glob, GLOBAL, 0) \
        | f[:, 1] << 16
    w[:, 1] = f[:, 2] | f[:, 3] << 16
    w[:, 2] = f[:, 4] | f[:, 5] << 16
    w[:, 3] = f[:, 6] & U32
    w[:, 4] = cap.astype(np.int64) & U32
    w[:, 5] = slot
    return w.astype(np.uint32).view(np.int32)


def decode(tables: RowTables) -> dict:
    """The fields of every row, as int64 numpy arrays: ``op``, the
    ``writes`` and ``global`` bits, ``dst``, ``src [N, 4]``, ``imm`` (uint32
    value; a LUT row's table index), ``cap`` (int32 value) and ``slot``;
    plus ``ctab [C, 4]`` and ``tts [U, 16]`` (uint32 values)."""
    w = _host(tables.rows).view(np.uint32).astype(np.int64)
    src = np.stack([w[:, 1] & MASK, w[:, 1] >> 16, w[:, 2] & MASK,
                    w[:, 2] >> 16], axis=1)
    tts = _host(tables.tts).view(np.uint32).astype(np.int64)
    return {"op": w[:, 0] & OP_BITS, "writes": (w[:, 0] & WRITES) != 0,
            "global": (w[:, 0] & GLOBAL) != 0, "dst": w[:, 0] >> 16,
            "src": src,
            "imm": w[:, 3], "cap": w[:, 4].astype(np.uint32).view(np.int32)
            .astype(np.int64), "slot": w[:, 5],
            "ctab": _host(tables.ctab).astype(np.int64),
            "tts": tts[:tables.n_tts]}


def _build(code, cap, luts, C: int, keep, body, device) -> RowTables:
    """Rows of the kept ``(t, c)`` entries of ``code [T, Cp, 7]``, ordered
    by core, then body before prologue (``body [T]``), then slot."""
    T = code.shape[0]
    tt, cc = np.nonzero(keep)
    key = cc * 2 * T + np.where(body[tt], tt, T + tt)
    order = np.argsort(key, kind="stable")
    tt, cc = tt[order], cc[order]
    fields = code[tt, cc].astype(np.int64)
    n_body = np.bincount(cc[body[tt]], minlength=C)
    n_pro = np.bincount(cc[~body[tt]], minlength=C)
    start = np.concatenate([[0], np.cumsum(n_body + n_pro)[:-1]])
    # LUT rows: the clamped table of the row's core, each distinct one once
    lut = fields[:, 0] == int(Op.LUT)
    L = luts.shape[1]
    tabs = luts[cc[lut], np.minimum(fields[lut, 6] & U32, L - 1)]
    tabs = tabs.astype(np.uint32).reshape(-1, 16)
    uniq, inv = np.unique(tabs, axis=0, return_inverse=True)
    fields[lut, 6] = inv.reshape(-1)
    rows = pack(fields, np.where(body[tt], cap[tt, cc], NO_CAPTURE), tt)
    tts = np.zeros((max(len(uniq), 1), 16), np.uint32)
    tts[:len(uniq)] = uniq
    ctab = np.stack([start, n_body, n_pro, np.zeros_like(start)], 1)
    return RowTables(
        torch.from_numpy(rows.reshape(-1, ROW_WORDS)).to(device),
        torch.from_numpy(ctab.astype(np.int32)).to(device),
        torch.from_numpy(tts.view(np.int32)).to(device), len(uniq),
        int((n_body + n_pro).max(initial=0)))


def chunk_rows(code, cap, luts, C: int, num_pro: int, n_sends: int,
               device="cuda") -> RowTables:
    """The chunk kernel's per-core compacted lists of the first C cores of
    ``code [T, Cp, 7]``, ``cap [T, Cp]`` and ``luts [Cp, L, 16]`` (host
    arrays or tensors): each core's live body rows, then its live
    prologue rows (a prologue row never captures)."""
    code, cap = _host(code)[:, :C], _host(cap)[:, :C]
    luts = _host(luts)[:C]
    T = code.shape[0]
    body = np.arange(T) >= num_pro
    captures = (cap >= 0) & (cap < n_sends)
    keep = (code[..., 0] != int(Op.NOP)) | (body[:, None] & captures)
    return _build(code, cap, luts, C, keep, body, device)


def seed_rows(code, luts, C: int, device="cuda") -> RowTables:
    """The seed kernel's dense stream of the first C cores: every slot of
    every core in slot order, core c's row t at ``c * T + t``."""
    code = _host(code)[:, :C]
    luts = _host(luts)[:C]
    T = code.shape[0]
    return _build(code, np.full(code.shape[:2], NO_CAPTURE, np.int32),
                  luts, C, np.ones(code.shape[:2], bool),
                  np.ones(T, bool), device)


# ---------------------------------------------------------------- walkers ----
def _lut4(tt, a, b, c, d) -> int:
    out = 0
    for p in range(16):
        m = ((a if p & 1 else ~a & MASK) & (b if p & 2 else ~b & MASK)
             & (c if p & 4 else ~c & MASK) & (d if p & 8 else ~d & MASK))
        out |= m & tt[p]
    return out


def _alu(op, v1, v2, v3, v4, imm, tts, spad):
    """The result of one row (0 for an opcode without one)."""
    if op == Op.MOV or op == Op.SEND:
        return v1
    if op == Op.MOVI:
        return imm & MASK
    if op == Op.ADD:
        return (v1 + v2) & MASK
    if op == Op.ADDC:
        return (v1 + v2 + v3) & MASK
    if op == Op.CARRY:
        return ((v1 + v2 + v3) >> 16) & MASK
    if op == Op.SUB:
        return (v1 - v2) & MASK
    if op == Op.SUBB:
        return (v1 - v2 - v3) & MASK
    if op == Op.BORROW:
        return int(v1 < ((v2 + v3) & U32))
    if op == Op.MUL:
        return (v1 * v2) & MASK
    if op == Op.MULH:
        return (((v1 * v2) & U32) >> 16) & MASK
    if op == Op.AND:
        return v1 & v2
    if op == Op.OR:
        return v1 | v2
    if op == Op.XOR:
        return v1 ^ v2
    if op == Op.NOT:
        return ~v1 & MASK
    if op == Op.MUX:
        return v2 if v1 else v3
    if op == Op.SEQ:
        return int(v1 == v2)
    if op == Op.SNE:
        return int(v1 != v2)
    if op == Op.SLTU:
        return int(v1 < v2)
    if op == Op.SLL:
        return (v1 << (imm & 15)) & MASK
    if op == Op.SRL:
        return v1 >> (imm & 15)
    if op == Op.SRA:
        x = ((v1 ^ 0x8000) - 0x8000) & U32
        x = x - (1 << 32) if x >= 1 << 31 else x
        return (x >> (imm & 15)) & MASK
    if op == Op.SLLV:
        return (v1 << (v2 & 15)) & MASK
    if op == Op.SRLV:
        return v1 >> (v2 & 15)
    if op == Op.SLICE:
        off = imm >> 5
        return (0 if off >= 32 else v1 >> off) & ((1 << (imm & 31)) - 1)
    if op == Op.LUT:
        return _lut4(tts[imm], v1, v2, v3, v4)
    if op == Op.LD:
        return spad[v1 % len(spad)]
    return 0


class _Glob:
    """One element's global memory, cache tags and counters (Python ints),
    owned by the privileged core's walk."""

    def __init__(self, gmem, tags, counters, cache):
        self.gmem, self.tags, self.cnt = gmem, tags, counters
        self.cache = cache

    def access(self, a: int) -> None:
        line = a // self.cache.line_words
        i = line % len(self.tags)
        hit = self.tags[i] == line
        self.tags[i] = line
        self.cnt[1 if hit else 2] = (self.cnt[1 if hit else 2] + 1) & U32
        self.cnt[3] = (self.cnt[3] + (self.cache.hit_stall if hit else
                                      self.cache.miss_stall)) & U32


def _exec(row, regs, spad, flag, tts, glob, side_effects: bool,
          masked: bool):
    """One row on one core, in place; returns (result, flag)."""
    op, writes, dst, s1, s2, s3, s4, imm = row[:8]
    v1, v2, v3, v4 = regs[s1], regs[s2], regs[s3], regs[s4]
    if op == Op.GLD:
        res = glob.gmem[(((v1 << 16) & U32) | v2) % len(glob.gmem)] \
            if glob is not None else 0
    else:
        res = _alu(op, v1, v2, v3, v4, imm, tts, spad)
    if writes:
        regs[dst] = res & MASK if masked else res
    if side_effects:
        if op == Op.ST and v3:
            spad[v1 % len(spad)] = v2
        if glob is not None and (op == Op.GLD or (op == Op.GST and v4)):
            a = (((v1 << 16) & U32) | v2) % len(glob.gmem)
            if op == Op.GST:
                glob.gmem[a] = v3
            glob.access(a)
        if op == Op.EXPECT and v1 != v2 and flag == 0:
            flag = imm
    return res, flag


def _rows_of(tables: RowTables):
    f = decode(tables)
    rows = [tuple(int(x) for x in r) for r in np.column_stack(
        [f["op"], f["writes"], f["dst"], f["src"], f["imm"], f["cap"]])]
    return rows, f["ctab"].tolist(), f["tts"].tolist()


def _lists(t: torch.Tensor):
    return (t.to(torch.int64) & U32).tolist()


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x, np.int64) & U32
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def walk_chunk(tables: RowTables, dcore, dreg, regs, spads, flags, cyc,
               budget: int, *, K: int, n_sends: int, gmem=None, tags=None,
               counters=None, cache=None):
    """Up to K Vcycles of B elements over ``chunk_rows`` tables, as the
    chunk kernel runs them: per element and Vcycle, freeze on a flag or the
    budget; each core's body rows in order, capturing SEND values; the
    exchange; each core's prologue rows iff the Vcycle raised nothing.
    CPU int32 tensors in and out, as ``vcycle_chunk_ref``."""
    rows, ctab, tts = _rows_of(tables)
    R, S, F = _lists(regs), _lists(spads), _lists(flags)
    gl = None if gmem is None else (_lists(gmem), tags.tolist(),
                                    _lists(counters))
    dc, dr = dcore[:n_sends].tolist(), dreg[:n_sends].tolist()
    nexec = []
    for b in range(len(R)):
        r, s, f = R[b], S[b], F[b]
        g = None if gl is None else _Glob(gl[0][b], gl[1][b], gl[2][b],
                                          cache)
        n = 0
        for _ in range(K):
            if any(f) or int(cyc[b]) + n >= budget:
                break
            sbuf = [0] * (n_sends + 1)
            for c, (start, nb, _, _) in enumerate(ctab):
                for row in rows[start:start + nb]:
                    res, f[c] = _exec(row, r[c], s[c], f[c], tts, g, True,
                                      False)
                    if 0 <= row[8] < n_sends:
                        sbuf[row[8]] = res & MASK
            for i in range(n_sends):
                r[dc[i]][dr[i]] = sbuf[i]
            if not any(f):
                for c, (start, nb, npro, _) in enumerate(ctab):
                    for row in rows[start + nb:start + nb + npro]:
                        _exec(row, r[c], s[c], 0, tts, None, False, False)
            n += 1
        nexec.append(n)
    out = (_tensor(R), _tensor(S), _tensor(F),
           torch.tensor(nexec, dtype=torch.int32))
    if gl is None:
        return out
    return out + (_tensor(gl[0]), torch.tensor(gl[1], dtype=torch.int32),
                  _tensor(gl[2]))


def walk_prologue(tables: RowTables, regs, spads) -> torch.Tensor:
    """Each core's prologue rows once on every element (register writes
    only), as the chunk kernel's prologue-only launch runs them."""
    rows, ctab, tts = _rows_of(tables)
    R, S = _lists(regs), _lists(spads)
    for r, s in zip(R, S):
        for c, (start, nb, npro, _) in enumerate(ctab):
            for row in rows[start + nb:start + nb + npro]:
                _exec(row, r[c], s[c], 0, tts, None, False, False)
    return _tensor(R)


def walk_seed(tables: RowTables, regs, spads, flags, gmem=None, tags=None,
              counters=None, cache=None):
    """One seed Vcycle over ``seed_rows`` tables, as the seed kernel runs
    it: every row of every core in slot order, results masked to 16 bits
    before the register write, the ``[T, C]`` trace. CPU int32 tensors in
    and out, as ``vcycle_seed_ref``."""
    rows, ctab, tts = _rows_of(tables)
    r, s, f = _lists(regs), _lists(spads), _lists(flags)
    g = None if gmem is None else _Glob(_lists(gmem), tags.tolist(),
                                        _lists(counters), cache)
    T = ctab[0][1] if ctab else 0
    trace = np.zeros((T, len(ctab)), np.int64)
    for c, (start, nb, _, _) in enumerate(ctab):
        for t, row in enumerate(rows[start:start + nb]):
            res, f[c] = _exec(row, r[c], s[c], f[c], tts, g, True, True)
            trace[t, c] = res & MASK
    out = (_tensor(r), _tensor(s), _tensor(f), _tensor(trace))
    if g is None:
        return out
    return out + (_tensor(g.gmem), torch.tensor(g.tags, dtype=torch.int32),
                  _tensor(g.cnt))
