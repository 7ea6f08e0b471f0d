"""Random chunk programs that freeze mid-chunk, for holding the chunk kernel
against its plain version (``chip_smoke.py``, ``tests/test_torch_*.py``).

``random_chunk`` draws every non-global opcode with 32-bit register words
and immediates over the whole int32 range, a random SEND table and a random
exchange. Core 0 counts Vcycles in registers R-4..R-1, which nothing else
writes, and raises EXPECT 7 when its count reaches the element's target, so
elements freeze at chosen Vcycles inside a chunk. Every other EXPECT
compares a register with itself and never raises.
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


def random_chunk(rng, targets: Sequence[int], C: int, T: int, R: int, S: int,
                 L: int, n_sends: int, num_pro: int,
                 Cp: Optional[int] = None):
    """One element per entry of ``targets``; element b's core 0 raises at
    its ``targets[b]``-th Vcycle. Rows ``[0, num_pro)`` hold pure opcodes
    only (a prologue). ``Cp >= C`` pads the program tables with NOP lanes.

    Returns numpy int32 ``code [T, Cp, 7]``, ``cap [T, Cp]``,
    ``luts [Cp, L, 16]``, ``dcore``/``dreg [n_sends]``, ``regs [B, C, R]``
    and ``spads [B, C, S]``."""
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
    return code, cap, _words(rng, Cp, L, 16), dcore, dreg, regs, \
        _words(rng, B, C, S)
