"""Random programs for holding the Vcycle kernels against their plain
versions (``chip_smoke.py``, ``tests/test_torch_*.py``).

``random_vcycle`` draws one machine and a program for the seed kernel:
every opcode, 32-bit words, EXPECTs that may raise, and optionally GLD/GST
on one core over a small global memory whose cache both hits and misses.

Random chunk programs freeze mid-chunk, for the chunk kernel:

``random_chunk`` draws every non-global opcode with 32-bit register words
and immediates over the whole int32 range, a random SEND table and a random
exchange. Core 0 counts Vcycles in registers R-4..R-1, which nothing else
writes, and raises EXPECT 7 when its count reaches the element's target, so
elements freeze at chosen Vcycles inside a chunk. Every other EXPECT
compares a register with itself and never raises.

``edge_chunk`` is ``random_chunk`` with the edges of the chunk kernel's
compacted rows: its last core has no live row, core 1 is live in every
slot, and the exchange tables are padded to one entry for ``n_sends = 0``.
"""
from typing import Optional, Sequence

import numpy as np

from ..core.isa import Op

TIMER_REGS = 4   # registers R-4..R-1 of every core: core 0's Vcycle timer
TIMER_EID = 7    # the exception id core 0's timer raises


def _words(rng, *shape) -> np.ndarray:
    """Uniform 32-bit words as int32 bit patterns."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


def random_vcycle(rng, C: int, T: int, R: int, S: int, L: int, G: int = 0,
                  lines: int = 8, gcore: int = 0, Cp: Optional[int] = None):
    """One machine's state and a T-slot program of the first C of ``Cp``
    cores (padded lanes are NOP). Every non-global opcode with random
    operands, destinations (r0 included), immediates over the whole int32
    range and 32-bit register, scratchpad and LUT words; a fifth of the
    cores start with a flag set. With ``G > 0`` core ``gcore`` also holds
    GLD/GST in about half its slots, over ``G`` words of global memory with
    ``lines`` cache tags (random, some invalid).

    Returns numpy int32 ``code [T, Cp, 7]``, ``luts [Cp, L, 16]``,
    ``regs [C, R]``, ``spads [C, S]`` and ``flags [C]``, followed by
    ``gmem [G]``, ``tags [lines]`` and ``counters [4]`` when ``G > 0``."""
    Cp = C if Cp is None else Cp
    ops = [int(o) for o in Op if o not in (Op.GLD, Op.GST)]
    code = np.zeros((T, Cp, 7), np.int32)
    code[:, :C, 0] = rng.choice(ops, (T, C))
    code[:, :C, 1] = rng.integers(0, R, (T, C))
    code[:, :C, 2:6] = rng.integers(0, R, (T, C, 4))
    code[:, :C, 6] = rng.integers(-2**31, 2**31, (T, C))
    regs = _words(rng, C, R)
    regs[:, 0] = 0
    flags = np.where(rng.random(C) < 0.2, _words(rng, C), 0).astype(np.int32)
    out = (code, _words(rng, Cp, L, 16), regs, _words(rng, C, S), flags)
    if not G:
        return out
    glob = rng.random(T) < 0.5
    code[glob, gcore, 0] = rng.choice([int(Op.GLD), int(Op.GST)], glob.sum())
    tags = rng.integers(-1, 2 * lines, lines).astype(np.int32)
    counters = rng.integers(0, 1000, 4).astype(np.int32)
    return out + (_words(rng, G), tags, counters)


def random_chunk(rng, targets: Sequence[int], C: int, T: int, R: int, S: int,
                 L: int, n_sends: int, num_pro: int,
                 Cp: Optional[int] = None, G: int = 0, lines: int = 8):
    """One element per entry of ``targets``; element b's core 0 raises at
    its ``targets[b]``-th Vcycle. Rows ``[0, num_pro)`` hold pure opcodes
    only (a prologue). ``Cp >= C`` pads the program tables with NOP lanes.
    With ``G > 0`` core 0 also holds GLD/GST in about half of its body
    rows, over ``G`` words of global memory per element with ``lines``
    cache tags.

    Returns numpy int32 ``code [T, Cp, 7]``, ``cap [T, Cp]``,
    ``luts [Cp, L, 16]``, ``dcore``/``dreg [n_sends]``, ``regs [B, C, R]``
    and ``spads [B, C, S]``, followed by ``gmem [B, G]``, ``tags
    [B, lines]`` and ``counters [B, 4]`` when ``G > 0``."""
    Cp = C if Cp is None else Cp
    B = len(targets)
    F = R - TIMER_REGS                         # freely written registers
    ops = [int(o) for o in Op if o not in (Op.GLD, Op.GST)]
    pure = [o for o in ops if o not in (int(Op.LD), int(Op.ST),
                                        int(Op.EXPECT), int(Op.SEND))]
    code = np.zeros((T, Cp, 7), np.int32)
    code[:, :C, 0] = rng.choice(ops, (T, C))
    code[:num_pro, :C, 0] = rng.choice(pure, (num_pro, C))
    code[:, :C, 1] = rng.integers(1, F, (T, C))
    code[:, :C, 2:6] = rng.integers(0, R, (T, C, 4))
    code[:, :C, 6] = rng.integers(-2**31, 2**31, (T, C))
    exp = code[..., 0] == int(Op.EXPECT)
    code[..., 3] = np.where(exp, code[..., 2], code[..., 3])
    cnt, one, tgt, eq = R - 1, R - 2, R - 3, R - 4
    if G:
        glob = np.zeros(T, bool)
        glob[num_pro:T - 3] = rng.random(T - 3 - num_pro) < 0.5
        code[glob, 0, 0] = rng.choice([int(Op.GLD), int(Op.GST)],
                                      glob.sum())
    code[T - 3, 0] = (int(Op.ADD), cnt, cnt, one, 0, 0, 0)
    code[T - 2, 0] = (int(Op.SEQ), eq, cnt, tgt, 0, 0, 0)
    code[T - 1, 0] = (int(Op.EXPECT), 0, eq, 0, 0, 0, TIMER_EID)
    cap = np.full((T, Cp), n_sends, np.int32)
    lanes = [(t, c) for t in range(num_pro, T - 3) for c in range(C)]
    for i, k in enumerate(rng.choice(len(lanes), n_sends, replace=False)):
        t, c = lanes[k]
        code[t, c, 0] = int(Op.SEND)
        cap[t, c] = i
    cells = rng.choice(C * (F - 1), n_sends, replace=False)
    dcore = (cells // (F - 1)).astype(np.int32)
    dreg = (1 + cells % (F - 1)).astype(np.int32)
    regs = _words(rng, B, C, R)
    regs[:, :, 0] = 0
    regs[:, :, F:] = 0
    regs[:, 0, one] = 1
    regs[:, 0, tgt] = targets
    out = (code, cap, _words(rng, Cp, L, 16), dcore, dreg, regs,
           _words(rng, B, C, S))
    if not G:
        return out
    tags = rng.integers(-1, 2 * lines, (B, lines)).astype(np.int32)
    counters = rng.integers(0, 1000, (B, 4)).astype(np.int32)
    return out + (_words(rng, B, G), tags, counters)


def edge_chunk(rng, targets: Sequence[int], C: int, T: int, R: int, S: int,
               L: int, n_sends: int, num_pro: int,
               Cp: Optional[int] = None, G: int = 0, lines: int = 8):
    """``random_chunk`` (same arguments and returns, C >= 3) whose last
    core holds only NOPs (its SENDs gone, their values 0 at the exchange)
    and whose core 1 holds no NOP (MOVs in its place); ``dcore``/``dreg``
    have ``max(n_sends, 1)`` entries, as the bindings lay them out."""
    out = list(random_chunk(rng, targets, C, T, R, S, L, n_sends, num_pro,
                            Cp=Cp, G=G, lines=lines))
    code, cap = out[0], out[1]
    code[:, C - 1] = 0
    cap[:, C - 1] = n_sends
    code[code[:, 1, 0] == int(Op.NOP), 1, 0] = int(Op.MOV)
    for i in (3, 4):
        pad = np.zeros((max(n_sends, 1),), np.int32)
        pad[:n_sends] = out[i]
        out[i] = pad
    return tuple(out)
