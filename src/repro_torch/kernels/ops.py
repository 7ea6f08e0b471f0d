"""Bind a compiled Program to the Vcycle kernels.

Port of ``repro.kernels.ops``. ``make_vcycle_chunk`` lays the program's
tables out once on the device (core axis padded to a warp multiple with
all-NOP lanes, compact SEND-capture table, exchange tables, the global
memory's cache model and privileged core) for the chunked K-Vcycle kernel,
and the returned binding advances a ``MachineState`` carry by up to K
Vcycles per call. ``make_vcycle`` binds the same padded tables to the
per-Vcycle seed kernel, whose call returns the carry and the ``[T, C]``
result trace. Unlike the reference's Pallas path, both bindings execute
programs with privileged off-chip traffic (GLD/GST).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ref import CacheModel, global_core
from .vcycle import (reg_layout, seed_check, vcycle_chunk, vcycle_prologue,
                     vcycle_seed)

# padded lanes of the code/capture/LUT tables are all-NOP; the kernels run
# one thread per core, so a warp is the natural padding unit
WARP = 32


def _dev(a, device) -> torch.Tensor:
    """Host array -> int32 tensor of its (uint32) bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.int32:
        a = a.astype(np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def _padded_tables(program, C: int):
    """``code [T, Cp, 7]`` and ``luts [Cp, L, 16]`` of the first C cores,
    padded with all-NOP lanes to ``Cp``, a warp multiple."""
    Cp = ((C + WARP - 1) // WARP) * WARP
    T = program.code.shape[1]
    code = np.zeros((T, Cp, 7), dtype=np.int32)
    code[:, :C] = program.code[:C].transpose(1, 0, 2)
    luts = np.zeros((Cp, program.luts.shape[1], 16), dtype=np.uint32)
    luts[:C] = program.luts[:C]
    return code, luts


class VcycleChunk:
    """``program`` laid out for ``vcycle_chunk``, with its packed register
    layout (``reg_layout``) and privileged core (``global_core``) computed
    once.

    ``chunk(cyc, budget, carry) -> (cyc, carry)``, the contract of
    ``Machine._run_chunk``: one call advances the machine by up to K
    Vcycles, bounded by ``budget`` and frozen by exceptions, with the BSP
    exchange and global memory in-kernel and ``counters[..., 0] += nexec``.
    ``batch=None`` binds one stimulus (carry leaves ``[C, ...]``, ``cyc``
    ``[1]``), run as the kernel at B=1; ``batch=B`` binds B stimuli (leaves
    ``[B, C, ...]``, ``cyc`` ``[B]``) with per-element freezing."""

    def __init__(self, program, C: int, K: int, batch: Optional[int] = None,
                 device="cuda"):
        self.C, self.K, self.batch = C, int(K), batch
        code, luts = _padded_tables(program, C)
        n = program.n_sends
        dcore = np.zeros((max(n, 1),), np.int32)
        dreg = np.zeros((max(n, 1),), np.int32)
        dcore[:n] = program.xchg_dst_core
        dreg[:n] = program.xchg_dst_reg
        self.code = _dev(code, device)
        self.cap = _dev(program.send_capture(code.shape[1]), device)
        self.luts = _dev(luts, device)
        self.dcore, self.dreg = _dev(dcore, device), _dev(dreg, device)
        self.n_sends = n
        self.num_pro = int(getattr(program, "pipe_prologue", 0))
        self.layout = reg_layout(code, dcore, dreg, C, n, device)
        self.gcore = global_core(code, C)
        self.cache = CacheModel.of(program.hw)

    def tables(self):
        return self.code, self.cap, self.luts, self.dcore, self.dreg

    def __call__(self, cyc: torch.Tensor, budget: int, carry):
        single = self.batch is None
        if single:
            carry = tuple(x[None] for x in carry)
        regs, spads, gmem, flags, tags, counters = carry
        glob = {}
        if self.gcore >= 0:
            glob = dict(gmem=gmem, tags=tags, counters=counters,
                        cache=self.cache)
        out = vcycle_chunk(
            *self.tables(), regs, spads, flags, cyc, budget, K=self.K,
            n_sends=self.n_sends, num_pro=self.num_pro, layout=self.layout,
            gcore=self.gcore, **glob)
        regs, spads, flags, nexec = out[:4]
        # the kernel's global state is already a new tensor
        gmem, tags, counters = out[4:] if glob else (gmem, tags,
                                                     counters.clone())
        counters[:, 0] += nexec
        carry = (regs, spads, gmem, flags, tags, counters)
        if single:
            carry = tuple(x[0] for x in carry)
        return cyc + nexec, carry

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


class SeedVcycle:
    """``program`` laid out for ``vcycle_seed`` (the seed arm's kernel) at
    register width R, checked once (``seed_check``).

    ``vcycle(carry) -> (carry, trace)``: one Vcycle of one machine (carry
    leaves ``[C, ...]``, registers ``[C, R]``), the whole stream with the
    full ISA select and global memory, without the exchange; ``trace
    [T, C]`` holds every slot's 16-bit result, from which the caller
    routes the SENDs."""

    def __init__(self, program, C: int, R: int, device="cuda"):
        self.C, self.R = C, R
        code, luts = _padded_tables(program, C)
        self.gcore = seed_check(code, C, R)
        self.code = _dev(code, device)
        self.luts = _dev(luts, device)
        self.cache = CacheModel.of(program.hw)

    def __call__(self, carry):
        regs, spads, gmem, flags, tags, counters = carry
        if regs.shape != (self.C, self.R):
            raise ValueError(f"vcycle_seed bound for registers "
                             f"{(self.C, self.R)}, got {tuple(regs.shape)}")
        glob = (gmem, tags, counters) if self.gcore >= 0 else ()
        out = vcycle_seed(self.code, self.luts, regs, spads, flags, *glob,
                          cache=self.cache, gcore=self.gcore)
        if glob:
            gmem, tags, counters = out[4:]
        return (out[0], out[1], gmem, out[2], tags, counters), out[3]


def make_vcycle(program, C: int, R: int, device="cuda") -> SeedVcycle:
    """Bind ``program`` (its first C cores, R registers each) to the
    per-Vcycle seed kernel (``repro.kernels.ops.make_vcycle``); see
    :class:`SeedVcycle`."""
    return SeedVcycle(program, C, R, device=device)
