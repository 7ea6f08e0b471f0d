"""Bind a compiled Program to the chunked K-Vcycle kernel.

Port of ``repro.kernels.ops.make_vcycle_chunk``: the program's tables are
laid out once on the device (core axis padded to a warp multiple, compact
SEND-capture table, exchange tables), and the returned binding advances a
``MachineState`` carry by up to K Vcycles per call. Programs with
privileged off-chip traffic (GLD/GST) are rejected, as the reference's
kernel path rejects them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .vcycle import reg_layout, vcycle_chunk, vcycle_prologue

# padded lanes of the code/capture/LUT tables are all-NOP; the kernel runs
# one thread per core, so a warp is the natural padding unit
WARP = 32


class VcycleChunk:
    """``program`` laid out for ``vcycle_chunk``, with its packed register
    layout (``reg_layout``) computed once.

    ``chunk(cyc, budget, carry) -> (cyc, carry)``, the contract of
    ``Machine._run_chunk``: one call advances the machine by up to K
    Vcycles, bounded by ``budget`` and frozen by exceptions, with the BSP
    exchange in-kernel and ``counters[..., 0] += nexec``. ``batch=None``
    binds one stimulus (carry leaves ``[C, ...]``, ``cyc`` ``[1]``), run as
    the kernel at B=1; ``batch=B`` binds B stimuli (leaves ``[B, C, ...]``,
    ``cyc`` ``[B]``) with per-element freezing."""

    def __init__(self, program, C: int, K: int, batch: Optional[int] = None,
                 device="cuda"):
        if program.has_global:
            raise ValueError(
                "programs with global memory (privileged GLD/GST) are not "
                "ported yet: see ROADMAP.md, queue A, global memory")
        self.C, self.K, self.batch = C, int(K), batch
        Cp = ((C + WARP - 1) // WARP) * WARP
        T = program.code.shape[1]
        code = np.zeros((T, Cp, 7), dtype=np.int32)
        code[:, :C] = program.code[:C].transpose(1, 0, 2)
        L = program.luts.shape[1]
        luts = np.zeros((Cp, L, 16), dtype=np.uint32)
        luts[:C] = program.luts[:C]
        n = program.n_sends
        dcore = np.zeros((max(n, 1),), np.int32)
        dreg = np.zeros((max(n, 1),), np.int32)
        dcore[:n] = program.xchg_dst_core
        dreg[:n] = program.xchg_dst_reg

        def dev(a):
            a = np.ascontiguousarray(a)
            if a.dtype != np.int32:
                a = a.astype(np.uint32).view(np.int32)
            return torch.from_numpy(a).to(device)

        self.code = dev(code)
        self.cap = dev(program.send_capture(Cp))
        self.luts = dev(luts)
        self.dcore, self.dreg = dev(dcore), dev(dreg)
        self.n_sends = n
        self.num_pro = int(getattr(program, "pipe_prologue", 0))
        self.layout = reg_layout(code, dcore, dreg, C, n, device)

    def tables(self):
        return self.code, self.cap, self.luts, self.dcore, self.dreg

    def __call__(self, cyc: torch.Tensor, budget: int, carry):
        regs, spads, gmem, flags, tags, counters = carry
        single = self.batch is None
        if single:
            regs, spads, flags = regs[None], spads[None], flags[None]
        regs, spads, flags, nexec = vcycle_chunk(
            *self.tables(), regs, spads, flags, cyc, budget, K=self.K,
            n_sends=self.n_sends, num_pro=self.num_pro, layout=self.layout)
        counters = counters.clone()
        if single:
            regs, spads, flags = regs[0], spads[0], flags[0]
            counters[0] += nexec[0]
        else:
            counters[:, 0] += nexec
        return cyc + nexec, (regs, spads, gmem, flags, tags, counters)

    def prologue(self, regs: torch.Tensor,
                 spads: torch.Tensor) -> torch.Tensor:
        """Iteration 0's prologue on ``regs`` (``[C, R]`` or
        ``[B, C, R]``)."""
        if not self.num_pro:
            return regs
        single = regs.dim() == 2
        if single:
            regs, spads = regs[None], spads[None]
        out = vcycle_prologue(*self.tables(), regs.contiguous(),
                              spads.contiguous(), num_pro=self.num_pro,
                              layout=self.layout)
        return out[0] if single else out


def make_vcycle_chunk(program, C: int, K: int, batch: Optional[int] = None,
                      device="cuda") -> VcycleChunk:
    """Bind ``program`` (its first C cores) to the chunk kernel; see
    :class:`VcycleChunk`."""
    return VcycleChunk(program, C, K, batch=batch, device=device)
