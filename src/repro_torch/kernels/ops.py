"""Bind a compiled Program to the Vcycle kernels.

Port of ``repro.kernels.ops``. ``make_vcycle_chunk`` lays the program's
tables out once for the chunked K-Vcycle kernel (each core's live code
rows, ``rows.chunk_rows``; the exchange tables; the packed register
layout; the global memory's cache model and privileged core), and the
returned binding advances a ``MachineState`` carry by up to K Vcycles per
call; ``make_vcycle_shard`` binds one shard of the multi-device grid
(``core/grid.py``) to the same kernel. ``make_vcycle`` lays every slot's
row out for the per-Vcycle seed kernel, whose call returns the carry and
the ``[T, C]`` result trace.
The dense tables (core axis padded to a warp multiple with all-NOP
lanes) stay on the host: the plain versions read them, and the kernels
are handed only the row tables. Unlike the reference's Pallas path, both
bindings execute programs with privileged off-chip traffic (GLD/GST).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ref import CacheModel, global_core
from .rows import chunk_rows
from .vcycle import (reg_layout, seed_check, seed_layout, vcycle_chunk,
                     vcycle_prologue, vcycle_seed)

# padded lanes of the code/capture/LUT tables are all-NOP; the kernels run
# one thread per core, so a warp is the natural padding unit
WARP = 32


def _dev(a, device="cpu") -> torch.Tensor:
    """Host array -> int32 tensor of its (uint32) bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.int32:
        a = a.astype(np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def _padded_tables(program, C: int):
    """``code [T, Cp, 7]`` and ``luts [Cp, L, 16]`` of the first C cores,
    padded with all-NOP lanes to ``Cp``, a warp multiple."""
    return _pad_cores(program.code[:C], program.luts[:C], C)


def _pad_cores(code, luts, C: int):
    """``code [n, T, 7]`` and ``luts [n, L, 16]`` of n <= C cores laid out
    as ``code [T, Cp, 7]`` and ``luts [Cp, L, 16]`` for C cores, the lanes
    past n all-NOP, ``Cp`` a warp multiple."""
    Cp = ((C + WARP - 1) // WARP) * WARP
    n, T = code.shape[:2]
    dense = np.zeros((T, Cp, 7), dtype=np.int32)
    dense[:, :n] = code.transpose(1, 0, 2)
    tabs = np.zeros((Cp, luts.shape[1], 16), dtype=np.uint32)
    tabs[:n] = luts
    return dense, tabs


class VcycleChunk:
    """A program's tables laid out for ``vcycle_chunk``, with its packed
    register layout (``reg_layout``), privileged core (``global_core``) and
    each core's compacted code rows (``rows.chunk_rows``) computed once.
    The dense ``code``, ``cap`` and ``luts`` stay on the host, for the plain
    version. ``make_vcycle_chunk`` binds a whole program,
    ``make_vcycle_shard`` one shard of the grid.

    ``chunk(cyc, budget, carry) -> (cyc, carry)``, the contract of
    ``Machine._run_chunk``: one call advances the machine by up to K
    Vcycles, bounded by ``budget`` and frozen by exceptions, with the BSP
    exchange and global memory in-kernel and ``counters[..., 0] += nexec``.
    ``batch=None`` binds one stimulus (carry leaves ``[C, ...]``, ``cyc``
    ``[1]``), run as the kernel at B=1; otherwise the carry holds any
    number B of stimuli (leaves ``[B, C, ...]``, ``cyc`` ``[B]``) with
    per-element freezing."""

    def __init__(self, code, cap, luts, C: int, dcore, dreg, n_sends: int,
                 num_pro: int, cache: CacheModel, K: int,
                 batch: Optional[int] = None, device="cuda"):
        self.C, self.K, self.batch = C, int(K), batch
        self.code, self.cap, self.luts = _dev(code), _dev(cap), _dev(luts)
        self.dcore, self.dreg = _dev(dcore, device), _dev(dreg, device)
        self.n_sends = n_sends
        self.num_pro = num_pro
        self.layout = reg_layout(code, dcore, dreg, C, n_sends, device)
        self.rows = chunk_rows(code, cap, luts, C, num_pro, n_sends, device)
        self.gcore = global_core(code, C)
        self.cache = cache

    def tables(self):
        """(code, cap, luts) on the host, (dcore, dreg) on the device."""
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
            gcore=self.gcore, rows=self.rows, **glob)
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
                              layout=self.layout, rows=self.rows)
        return out[0] if single else out


def make_vcycle_chunk(program, C: int, K: int, batch: Optional[int] = None,
                      device="cuda") -> VcycleChunk:
    """Bind ``program`` (its first C cores) to the chunk kernel, its
    modulo-pipelined prologue rotated (``pipe_prologue`` rows run after
    the exchange); see :class:`VcycleChunk`."""
    code, luts = _padded_tables(program, C)
    n = program.n_sends
    dcore = np.zeros((max(n, 1),), np.int32)
    dreg = np.zeros((max(n, 1),), np.int32)
    dcore[:n] = program.xchg_dst_core
    dreg[:n] = program.xchg_dst_reg
    return VcycleChunk(code, program.send_capture(code.shape[1]), luts, C,
                       dcore, dreg, n, int(getattr(program, "pipe_prologue",
                                                   0)),
                       CacheModel.of(program.hw), K, batch=batch,
                       device=device)


def make_vcycle_shard(program, lo: int, cl: int, n_box: int, cap, dcore,
                      dreg, K: int, batch: Optional[int] = None,
                      device="cuda") -> VcycleChunk:
    """Bind one shard of the grid to the chunk kernel: the program's cores
    ``[lo, lo + cl)`` (those past ``used_cores`` run no code) as local
    cores ``[0, cl)``, then ``n_box`` outbox cores that run no code and
    only receive. ``cap [T, cl]`` is the shard's capture table into its
    compact SEND buffer (``core.grid._build_exchange``; an index outside
    ``[0, len(dcore))`` captures nothing) and ``dcore``/``dreg`` route
    each local send: to a local core's register, or to an outbox register
    that the caller copies to the receiving shard after the launch. The
    program runs unrotated, all T rows in order (no prologue of its own),
    as the reference's grid runs it."""
    hi = min(lo + cl, program.used_cores)
    C = cl + n_box
    code, luts = _pad_cores(program.code[lo:hi], program.luts[lo:hi], C)
    n = len(dcore)
    caps = np.full((code.shape[0], code.shape[1]), n, np.int32)
    caps[:, :cl] = np.where((cap >= 0) & (cap < n), cap, n)
    pad = lambda a: np.concatenate(
        [np.asarray(a, np.int32), np.zeros((max(n, 1) - n,), np.int32)])
    return VcycleChunk(code, caps, luts, C, pad(dcore), pad(dreg), n, 0,
                       CacheModel.of(program.hw), K, batch=batch,
                       device=device)


class SeedVcycle:
    """``program`` laid out for ``vcycle_seed`` (the seed arm's kernel) at
    register width R, checked once (``seed_check``), with every slot's code
    row and each block's packed registers (``seed_layout``). The dense
    ``code`` and ``luts`` stay on the host, for the plain version.

    ``vcycle(carry) -> (carry, trace)``: one Vcycle of one machine (carry
    leaves ``[C, ...]``, registers ``[C, R]``), the whole stream with the
    full ISA select and global memory, without the exchange; ``trace
    [T, C]`` holds every slot's 16-bit result, from which the caller
    routes the SENDs."""

    def __init__(self, program, C: int, R: int, device="cuda"):
        self.C, self.R = C, R
        code, luts = _padded_tables(program, C)
        self.gcore = seed_check(code, C, R)
        self.code, self.luts = _dev(code), _dev(luts)
        self.tables = seed_layout(code, luts, C, device)
        self.cache = CacheModel.of(program.hw)

    def __call__(self, carry):
        regs, spads, gmem, flags, tags, counters = carry
        if regs.shape != (self.C, self.R):
            raise ValueError(f"vcycle_seed bound for registers "
                             f"{(self.C, self.R)}, got {tuple(regs.shape)}")
        glob = (gmem, tags, counters) if self.gcore >= 0 else ()
        out = vcycle_seed(self.code, self.luts, regs, spads, flags, *glob,
                          cache=self.cache, gcore=self.gcore,
                          tables=self.tables)
        if glob:
            gmem, tags, counters = out[4:]
        return (out[0], out[1], gmem, out[2], tags, counters), out[3]


def make_vcycle(program, C: int, R: int, device="cuda") -> SeedVcycle:
    """Bind ``program`` (its first C cores, R registers each) to the
    per-Vcycle seed kernel (``repro.kernels.ops.make_vcycle``); see
    :class:`SeedVcycle`."""
    return SeedVcycle(program, C, R, device=device)
