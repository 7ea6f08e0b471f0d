"""Plain PyTorch semantics of the ISA: the oracle the CUDA kernel is held to.

Port of ``repro.core.bsp._alu_branches`` and of ``repro.kernels.ref``
(``slot_ref``/``vcycle_ref``). Machine words are 32-bit: the reference
holds them in ``uint32``, the port's state tensors store the same bit
patterns in ``int32``. PyTorch's CPU build has almost no ``uint32``
arithmetic and ``int32`` overflows on MULH's ``0xFFFF * 0xFFFF``, so this
module computes on ``int64`` values in ``[0, 2**32)`` and re-creates every
place where the reference's ``uint32`` arithmetic wraps:

* SUB/SUBB wrap before the 16-bit mask (two's complement low bits agree);
* BORROW compares against ``(v2 + v3) mod 2**32``;
* MULH takes bits 16..31 of the 32-bit product, computed in halves so no
  ``int64`` product can overflow;
* SRA sign-extends through ``int32(uint32((v1 ^ 0x8000) - 0x8000))``;
* SLICE's ``v1 >> off`` is 0 for ``off >= 32``, as XLA's logical shift is;
* ``imm`` is the instruction's field reinterpreted as ``uint32``: the LUT
  row is ``min(imm, L - 1)`` in unsigned order, MOVI masks it and EXPECT
  keeps all 32 bits in the flag.

Register writes store the unmasked result (as the reference's slot step
does); a SEND's capture is masked to 16 bits. The seed form
(``vcycle_seed_ref``, the plain version of ``_vcycle_kernel``) masks the
result to 16 bits before the register write, as that kernel does; the two
forms agree on every compiled Program, whose words never reach 2**16.

``flash_ref`` is the plain version of the flash-attention kernels
(``csrc/flash_attention_sm90.cu``, ``csrc/flash_attention.cu``), the port
of ``repro.kernels.ref.flash_ref``.

Global memory (GLD/GST) and the privileged core's direct-mapped cache and
stall model are ``repro.core.bsp.make_window_step``'s: the address is
``((v1 << 16) | v2) % G`` in uint32 with G the length of ``gmem``; GST
stores ``v3`` iff ``v4 != 0``; every GLD and every storing GST is one
cache access, a hit when ``tags[line % lines] == line``, after which the
tag is ``line``; ``counters[1..3]`` count hits, misses and stall cycles.
"""
from __future__ import annotations

import math
from typing import FrozenSet, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.isa import Op

MASK = 0xFFFF
U32 = 0xFFFFFFFF

# opcodes with no register result (SEND's value goes to the exchange only)
NO_WRITE_OPS = (Op.NOP, Op.ST, Op.GST, Op.EXPECT, Op.SEND)
# opcodes whose third / fourth operand is read
V3_OPS = frozenset({Op.ADDC, Op.CARRY, Op.SUBB, Op.BORROW, Op.MUX, Op.ST,
                    Op.GST, Op.LUT})
V4_OPS = frozenset({Op.LUT, Op.GST})
# the privileged core's off-chip opcodes
GLOBAL_OPS = frozenset({Op.GLD, Op.GST})
# every opcode the Vcycle engines execute
ENGINE_OPS = frozenset(Op)


class CacheModel(NamedTuple):
    """The privileged core's direct-mapped cache (``HardwareConfig``): words
    per line and the global stall cycles charged on a hit and on a miss.
    The number of lines is the length of the cache-tag array."""
    line_words: int
    hit_stall: int
    miss_stall: int

    @classmethod
    def of(cls, hw) -> "CacheModel":
        return cls(int(hw.cache_line_words), int(hw.cache_hit_stall),
                   int(hw.cache_miss_stall))


class Glob(NamedTuple):
    """Global state of B elements for ``exec_slot``, updated in place:
    ``gmem [B, G]`` and ``counters [B, 4]`` int64 words in [0, 2**32),
    ``tags [B, LINES]`` int64 cache tags (-1 = invalid)."""
    gmem: torch.Tensor
    tags: torch.Tensor
    counters: torch.Tensor
    cache: CacheModel


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return x.to(torch.int64) & U32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any) -> int32 holding their low 32 bits."""
    x = x & U32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


_PATTERN_BITS = {}


def _pattern_bits(device) -> torch.Tensor:
    """[4, 16] bool: bit i of LUT pattern p (LUT input i is bit i)."""
    key = str(device)
    if key not in _PATTERN_BITS:
        p = torch.arange(16, device=device)
        _PATTERN_BITS[key] = torch.stack([(p >> i) & 1 == 1
                                          for i in range(4)])
    return _PATTERN_BITS[key]


def lut4(v1, v2, v3, v4, lut_tt) -> torch.Tensor:
    """Per-bit-lane 4-input LUT: ``OR_p (m_p & tt[p])`` where ``m_p`` ANDs
    each input or its 16-bit complement as pattern ``p`` selects.

    The 16 minterm masks are pairwise disjoint (two patterns differ in some
    input ``i``, and ``v_i & (~v_i & 0xFFFF) == 0``; bits above 15 can only
    survive in pattern 15, which negates nothing), so the OR over patterns
    is their sum: one reduction instead of sixteen ORs."""
    bits = _pattern_bits(v1.device)
    m = None
    for i, v in enumerate((v1, v2, v3, v4)):
        sel = torch.where(bits[i], v[..., None], ((~v) & MASK)[..., None])
        m = sel if m is None else m & sel
    return (m & lut_tt).sum(-1)


def alu_branches(ops: FrozenSet[Op], v1, v2, v3, v4, imm, lut_tt=None,
                 ld_val=None, gld_val=None) -> List[Tuple[Op, torch.Tensor]]:
    """(op, value) for every result-producing opcode in ``ops``: the one
    definition of the ALU semantics (``repro.core.bsp._alu_branches``).
    Operands are int64 in [0, 2**32); ``lut_tt`` is the gathered
    ``[..., 16]`` truth table, ``ld_val``/``gld_val`` the gathered
    scratchpad / global memory reads (required iff LUT / LD / GLD is in
    ``ops``)."""
    out = []

    def b(o, thunk):
        if o in ops:
            out.append((o, thunk()))

    def mulh():
        lo1, lo2 = v1 & MASK, v2 & MASK
        return (((lo1 * lo2) >> 16) + (v1 >> 16) * lo2
                + lo1 * (v2 >> 16)) & MASK

    def sra():
        x = ((v1 ^ 0x8000) - 0x8000) & U32
        x = torch.where(x >= 1 << 31, x - (1 << 32), x)
        return (x >> (imm & 15)) & MASK

    def slice_():
        off = imm >> 5
        shifted = torch.where(off >= 32, torch.zeros_like(v1),
                              v1 >> off.clamp(max=31))
        return shifted & ((torch.ones_like(imm) << (imm & 31)) - 1)

    b(Op.MOV, lambda: v1)
    b(Op.MOVI, lambda: imm & MASK)
    b(Op.ADD, lambda: (v1 + v2) & MASK)
    b(Op.ADDC, lambda: (v1 + v2 + v3) & MASK)
    b(Op.CARRY, lambda: ((v1 + v2 + v3) >> 16) & MASK)
    b(Op.SUB, lambda: (v1 - v2) & MASK)
    b(Op.SUBB, lambda: (v1 - v2 - v3) & MASK)
    b(Op.BORROW, lambda: (v1 < ((v2 + v3) & U32)).to(torch.int64))
    b(Op.MUL, lambda: ((v1 & MASK) * (v2 & MASK)) & MASK)
    b(Op.MULH, mulh)
    b(Op.AND, lambda: v1 & v2)
    b(Op.OR, lambda: v1 | v2)
    b(Op.XOR, lambda: v1 ^ v2)
    b(Op.NOT, lambda: (~v1) & MASK)
    b(Op.MUX, lambda: torch.where(v1 != 0, v2, v3))
    b(Op.SEQ, lambda: (v1 == v2).to(torch.int64))
    b(Op.SNE, lambda: (v1 != v2).to(torch.int64))
    b(Op.SLTU, lambda: (v1 < v2).to(torch.int64))
    b(Op.SLL, lambda: (v1 << (imm & 15)) & MASK)
    b(Op.SRL, lambda: v1 >> (imm & 15))
    b(Op.SRA, sra)
    b(Op.SLLV, lambda: (v1 << (v2 & 15)) & MASK)
    b(Op.SRLV, lambda: v1 >> (v2 & 15))
    b(Op.SLICE, slice_)
    if Op.LUT in ops:
        out.append((Op.LUT, lut4(v1, v2, v3, v4, lut_tt)))
    if Op.LD in ops:
        out.append((Op.LD, ld_val))
    if Op.GLD in ops:
        out.append((Op.GLD, gld_val))
    b(Op.SEND, lambda: v1)
    return out


class Slot:
    """One decoded code row ``[C, 7]`` (int64 fields, ``imm`` as uint32)
    plus the set of opcodes it contains — the static knowledge the plain
    engine specializes each slot on."""

    def __init__(self, row: torch.Tensor, ops: FrozenSet[Op],
                 cap: Optional[torch.Tensor] = None):
        f = row.to(torch.int64)
        self.op, self.dst = f[:, 0], f[:, 1]
        self.src = f[:, 2:6]
        self.imm = f[:, 6] & U32
        self.ops = ops
        self.cap = None if cap is None else cap.to(torch.int64)
        no_write = self.dst == 0
        for o in NO_WRITE_OPS:
            no_write = no_write | (self.op == int(o))
        self.no_write = no_write
        self.wdst = torch.where(no_write, 0, self.dst)


def decode(code: torch.Tensor, cap: Optional[torch.Tensor] = None,
           ops: Optional[FrozenSet[Op]] = None) -> List[Slot]:
    """Decode ``code [T, C, 7]`` into per-slot :class:`Slot` records.
    ``ops=None`` specializes every slot on the opcodes it holds (one host
    read of the opcode plane); otherwise every slot selects over ``ops``."""
    T = code.shape[0]
    if ops is None:
        plane = code[:, :, 0].cpu().numpy()
        sets = [frozenset(Op(int(o)) for o in set(plane[t].tolist()))
                for t in range(T)]
    else:
        sets = [ops] * T
    return [Slot(code[t], sets[t], None if cap is None else cap[t])
            for t in range(T)]


def exec_slot(s: Slot, luts: torch.Tensor, regs: torch.Tensor,
              spads: torch.Tensor, flags: torch.Tensor,
              sbuf: Optional[torch.Tensor] = None,
              regs_only: bool = False, glob: Optional[Glob] = None,
              masked: bool = False) -> torch.Tensor:
    """Execute one slot for every lane of every batch element, in place.

    ``regs [B, C, R]``, ``spads [B, C, S]``, ``flags [B, C]`` and
    ``luts [C, L, 16]`` are int64 words in [0, 2**32). All operands are
    read before any write (one instruction per lane per slot). The result
    is written to ``dst`` (never r0, never for NOP/ST/GST/EXPECT/SEND),
    masked to 16 bits first when ``masked``; unless ``regs_only``, ST
    stores ``v2`` at ``v1 % S`` when ``v3 != 0``, GLD/GST go through
    ``glob`` (see ``global_access``), EXPECT raises ``imm`` on a core whose
    flag is still 0, and every lane's ``result & 0xFFFF`` lands in
    ``sbuf [B, n_sends + 1]`` through the slot's capture row. Without
    ``glob`` a GLD yields 0 and a GST does nothing, as in
    ``repro.kernels.ref.slot_ref``. Returns the ``[B, C]`` result."""
    B, C, R = regs.shape
    S = spads.shape[2]
    ops = s.ops if glob is not None else s.ops - GLOBAL_OPS

    def rd(k):
        idx = s.src[:, k].view(1, C, 1).expand(B, C, 1)
        return regs.gather(2, idx).squeeze(2)

    v1, v2 = rd(0), rd(1)
    zero = torch.zeros_like(v1)
    v3 = rd(2) if ops & V3_OPS else zero
    v4 = rd(3) if ops & V4_OPS else zero
    imm = s.imm.view(1, C)
    lut_tt = ld_val = gld_val = g_addr = None
    if Op.LUT in ops:
        rows = torch.clamp(s.imm, max=luts.shape[1] - 1)
        lut_tt = luts[torch.arange(C, device=luts.device), rows][None]
    if Op.LD in ops:
        ld_val = spads.gather(2, (v1 % S)[..., None]).squeeze(2)
    if ops & GLOBAL_OPS:
        g_addr = (((v1 << 16) & U32) | v2) % glob.gmem.shape[1]
        if Op.GLD in ops:
            gld_val = glob.gmem.gather(1, g_addr)
    result = zero
    for o, val in alu_branches(ops, v1, v2, v3, v4, imm, lut_tt, ld_val,
                               gld_val):
        result = torch.where(s.op == int(o), val, result)
    if masked:
        result = result & MASK

    if ops - set(NO_WRITE_OPS):
        wdst = s.wdst.view(1, C, 1).expand(B, C, 1)
        wval = torch.where(s.no_write, regs[:, :, 0], result)
        regs.scatter_(2, wdst, wval[..., None])
    if regs_only:
        return result
    if Op.ST in ops:
        st = (s.op == int(Op.ST)) & (v3 != 0)
        addr = (v1 % S)[..., None]
        old = spads.gather(2, addr).squeeze(2)
        spads.scatter_(2, addr, torch.where(st, v2, old)[..., None])
    if g_addr is not None:
        global_access(s.op, g_addr, v3, v4, glob)
    if Op.EXPECT in ops:
        exc = (s.op == int(Op.EXPECT)) & (v1 != v2) & (flags == 0)
        flags.copy_(torch.where(exc, imm, flags))
    if sbuf is not None:
        sbuf.scatter_(1, s.cap.view(1, C).expand(B, C), result & MASK)
    return result


def global_access(op, g_addr, v3, v4, glob: Glob) -> None:
    """The privileged core's GST and cache/stall model for one slot, in
    place on ``glob`` (``repro.core.bsp.make_window_step``). ``op [C]``;
    ``g_addr``, ``v3``, ``v4`` are ``[B, C]``. The first lane that
    accesses global memory (a GLD, or a GST with ``v4 != 0``) is the one
    access of the slot; the bindings check that only one core holds
    GLD/GST."""
    gst = (op == int(Op.GST)) & (v4 != 0)
    acc = (op == int(Op.GLD)) | gst
    lane = acc.to(torch.int32).argmax(1, keepdim=True)
    any_g = acc.any(1, keepdim=True)
    addr = g_addr.gather(1, lane)
    old = glob.gmem.gather(1, addr)
    glob.gmem.scatter_(1, addr, torch.where(gst.gather(1, lane),
                                            v3.gather(1, lane), old))
    line = addr // glob.cache.line_words
    idx = line % glob.tags.shape[1]
    tag = glob.tags.gather(1, idx)
    hit = (tag == line) & any_g
    miss = (tag != line) & any_g
    glob.tags.scatter_(1, idx, torch.where(any_g, line, tag))
    cnt = glob.counters
    cnt[:, 1:2] += hit
    cnt[:, 2:3] += miss
    cnt[:, 3:4] += hit * glob.cache.hit_stall + miss * glob.cache.miss_stall


def global_core(code, C: int) -> int:
    """The one core among the first C of ``code [T, Cp, 7]`` (host array or
    tensor) that holds GLD/GST, or -1 when none does. Raises
    ``ValueError`` when several do: the partitioner puts every privileged
    instruction on one core, and the kernels model one cache access per
    slot."""
    plane = np.asarray(code[:, :C, 0].cpu() if torch.is_tensor(code)
                       else code[:, :C, 0])
    cores = np.flatnonzero(np.isin(plane, [int(o) for o in GLOBAL_OPS])
                           .any(0))
    if cores.size > 1:
        raise ValueError("GLD/GST on more than one core "
                         f"({cores.tolist()}): only the privileged core "
                         "may touch global memory")
    return int(cores[0]) if cores.size else -1


def to_glob(gmem, tags, counters, cache: Optional[CacheModel]) -> Glob:
    """``Glob`` of int64 words from the int32 tensors ``gmem [B, G]``,
    ``tags [B, LINES]`` and ``counters [B, 4]``."""
    if cache is None:
        raise ValueError("global memory needs its CacheModel")
    return Glob(to_u32(gmem), tags.to(torch.int64), to_u32(counters), cache)


def from_glob(g: Glob) -> Tuple[torch.Tensor, ...]:
    """(gmem, tags, counters) as int32 tensors."""
    return from_u32(g.gmem), g.tags.to(torch.int32), from_u32(g.counters)


def slot_ref(code_t: torch.Tensor, luts: torch.Tensor, regs: torch.Tensor,
             spads: torch.Tensor, flags: torch.Tensor,
             ) -> Tuple[torch.Tensor, ...]:
    """One slot for all lanes, the full ISA select (no global memory).
    code_t [C, 7] int32; luts [C, L, 16], regs [C, R], spads [C, S],
    flags [C] int32 bit patterns. Returns (regs, spads, flags, result &
    0xFFFF), all int32 (``repro.kernels.ref.slot_ref``)."""
    r, s, f = (to_u32(x)[None] for x in (regs, spads, flags))
    res = exec_slot(Slot(code_t, ENGINE_OPS), to_u32(luts), r, s, f)
    return from_u32(r[0]), from_u32(s[0]), from_u32(f[0]), \
        from_u32(res[0] & MASK)


def vcycle_ref(code: torch.Tensor, luts: torch.Tensor, regs: torch.Tensor,
               spads: torch.Tensor, flags: torch.Tensor,
               ) -> Tuple[torch.Tensor, ...]:
    """One Vcycle's slot loop (no exchange, no global memory). code
    [T, C, 7]. Returns (regs, spads, flags, trace [T, C])
    (``repro.kernels.ref.vcycle_ref``)."""
    r, s, f = (to_u32(x)[None] for x in (regs, spads, flags))
    lt = to_u32(luts)
    trace = [exec_slot(sl, lt, r, s, f)[0] & MASK
             for sl in decode(code, ops=ENGINE_OPS)]
    tr = (torch.stack(trace) if trace
          else torch.zeros((0, regs.shape[0]), dtype=torch.int64))
    return from_u32(r[0]), from_u32(s[0]), from_u32(f[0]), from_u32(tr)


def vcycle_seed_ref(code: torch.Tensor, luts: torch.Tensor,
                    regs: torch.Tensor, spads: torch.Tensor,
                    flags: torch.Tensor, gmem: Optional[torch.Tensor] = None,
                    tags: Optional[torch.Tensor] = None,
                    counters: Optional[torch.Tensor] = None,
                    cache: Optional[CacheModel] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """One Vcycle's slot loop as ``repro.kernels.vcycle._vcycle_kernel``
    computes it, plus global memory: the full ISA select on every slot,
    results masked to 16 bits before the register write, no exchange.

    ``code [T, Cp, 7]`` (``Cp >= C``: padded lanes are never read),
    ``luts [Cp, L, 16]``, ``regs [C, R]``, ``spads [C, S]``, ``flags [C]``;
    a program with GLD/GST also needs ``gmem [G]``, ``tags [LINES]``,
    ``counters [4]`` and the ``cache`` model. All int32 bit patterns.
    Returns (regs, spads, flags, trace [T, C]), followed by (gmem, tags,
    counters) when ``gmem`` is given. ``code`` and ``luts`` may lie on
    the host: they are read on ``regs``'s device."""
    C = regs.shape[0]
    code, luts = code.to(regs.device), luts.to(regs.device)
    g = None
    if gmem is not None:
        g = to_glob(gmem[None], tags[None], counters[None], cache)
    elif global_core(code, C) >= 0:
        raise ValueError("vcycle_seed: the program holds GLD/GST but no "
                         "global memory was given")
    r, s, f = (to_u32(x)[None] for x in (regs, spads, flags))
    lt = to_u32(luts[:C])
    trace = [exec_slot(sl, lt, r, s, f, glob=g, masked=True)[0]
             for sl in decode(code[:, :C], ops=ENGINE_OPS)]
    tr = (torch.stack(trace) if trace
          else torch.zeros((0, C), dtype=torch.int64, device=regs.device))
    out = (from_u32(r[0]), from_u32(s[0]), from_u32(f[0]), from_u32(tr))
    if g is None:
        return out
    return out + tuple(x[0] for x in from_glob(g))


def exec_rows(slots: Sequence[Slot], luts, regs, spads, flags, sbuf=None,
              regs_only: bool = False, glob: Optional[Glob] = None) -> None:
    """Execute consecutive decoded slots in place."""
    for s in slots:
        exec_slot(s, luts, regs, spads, flags, sbuf, regs_only, glob)


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """The type the plain flash versions compute in: float64 for float64
    inputs, else fp32."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, return_lse: bool = False):
    """Plain softmax attention, the oracle of both flash kernels:
    fp32 scores over ``sqrt(dh)``, -1e30 above the diagonal when causal,
    softmax, ``P @ V`` in fp32, cast to q's dtype. q ``[BH, S, dh]``; k, v
    ``[BHkv, S, dh]`` with ``BH = G * BHkv``: query row-set i reads
    key/value row-set ``i // G`` (G = 1 is the reference's contract).
    With ``return_lse`` it returns (output, lse): lse ``[BH, S]`` fp32,
    the natural log-sum-exp of each row's masked, scaled fp32 scores, as
    the forward kernels save it for the backward kernels. float64 inputs
    are computed in float64 throughout (a yardstick for the fp32 kernels'
    error)."""
    G = q.shape[0] // k.shape[0]
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
        v = v.repeat_interleave(G, dim=0)
    dh = q.shape[-1]
    acc = _acc_dtype(q)
    s = torch.einsum("bqd,bkd->bqk", q.to(acc), k.to(acc)) / math.sqrt(dh)
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", w, v.to(acc)).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, causal: bool = True,
                  lse: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_ref``, with the backward kernels' own math
    (``csrc/flash_attention_bwd.cu``, and ``flash_attention_bwd_sm90.cu``
    when ``lse`` is given), all in fp32: per query row the log-sum-exp
    ``lse`` of its scores (recomputed from q and k, or the forward's
    ``[BH, S]`` fp32 ``lse`` as given) and
    ``D = rowsum(dO * O)``; ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P (dP - D) / sqrt(dh)``, ``dQ = dS K``,
    ``dK = dS^T Q``. q, o, do ``[BH, S, dh]``; k, v ``[BHkv, S, dh]``:
    dk and dv sum the G = BH / BHkv query row-sets that read each
    key/value row-set (``flash_ref``'s grouping, i // G). Returns
    (dq, dk, dv) in the inputs' dtype; float64 inputs are computed in
    float64 throughout."""
    BH, S, dh = q.shape
    G = BH // k.shape[0]
    acc = _acc_dtype(q)
    qf, of, dof = q.to(acc), o.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(G, dim=0)
    vf = v.to(acc).repeat_interleave(G, dim=0)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) / math.sqrt(dh)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, -1e30)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.to(acc)[..., None])
    D = (dof * of).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - D) / math.sqrt(dh)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds, qf)
    dk = dk.view(-1, G, S, dh).sum(dim=1)
    dv = dv.view(-1, G, S, dh).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
