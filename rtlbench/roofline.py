"""The least time of the chunk kernel's work, counted from the Program.

Frozen from ``chip_smoke.py``'s ``table_words`` and ``time_chunk``: a
launch reads every live code row once (its first four words and its
capture index), the per-core table, each distinct LUT truth table, the
exchange tables and register offsets, and reads and writes each
stimulus's registers, scratchpad and flags once (with the global memory,
cache tags and counters where the Program touches global memory). A row
is live where its opcode is not NOP, or where it captures a SEND value.
Every count comes from the compiled Program, never from the kernel's
binding, so a change to the kernel cannot change it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


@dataclass(frozen=True)
class ChunkWork:
    rows: int          # live rows of all cores: instructions a Vcycle
    busiest: int       # live rows of the busiest core
    fixed_words: int   # words a launch reads whatever its batch
    state_words: int   # words of one stimulus's state


def chunk_work(program) -> ChunkWork:
    from repro_torch.core.isa import Op

    C = max(int(program.used_cores), 1)
    R = int(program.used_reg_count())
    code = np.asarray(program.code)[:C]            # [C, T, 7]
    op = code[..., 0]
    live = op != int(Op.NOP)
    pro = int(program.pipe_prologue)
    src_c = np.asarray(program.xchg_src_core, np.int64)
    src_t = np.asarray(program.xchg_src_slot, np.int64)
    body = (src_t >= pro) & (src_c < C)
    live[src_c[body], src_t[body]] = True
    lut = live & (op == int(Op.LUT))
    luts = np.asarray(program.luts)[:C]
    cc, tt = np.nonzero(lut)
    idx = np.minimum(code[cc, tt, 6].astype(np.int64) & 0xFFFFFFFF,
                     luts.shape[1] - 1)
    n_tts = len(np.unique(luts[cc, idx].reshape(len(cc), -1), axis=0)) \
        if len(cc) else 0
    S = np.asarray(program.spad_init).shape[1]
    state = C * R + C * S + C
    if np.isin(op, [int(Op.GLD), int(Op.GST)]).any():
        hw = program.hw
        state += (np.asarray(program.gmem_init).shape[0]
                  + hw.cache_words // hw.cache_line_words + 4)
    M = int(program.n_sends)
    rows = int(live.sum())
    return ChunkWork(rows, int(live.sum(1).max()),
                     5 * rows + 4 * C + 16 * n_tts + 2 * M + C + 1, state)


def launch_bytes(work: ChunkWork, batch: int) -> int:
    """Bytes one launch of a ``batch``-stimulus binding needs."""
    return 4 * (work.fixed_words + 2 * batch * work.state_words + 2 * batch)


def least_s(work: ChunkWork, batch: int, launches: int,
            vcycles: int) -> float:
    """The least time of ``launches`` launches that run ``vcycles``
    stimulus-Vcycles in all: bytes at the memory's rate against
    instructions at the INT32 rate, whichever is larger."""
    t_bytes = launches * launch_bytes(work, batch) / PEAKS["hbm_bytes_per_s"]
    t_ops = vcycles * work.rows / PEAKS["int32_ops_per_s"]
    return max(t_bytes, t_ops)
