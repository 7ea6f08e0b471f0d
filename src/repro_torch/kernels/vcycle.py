"""The Vcycle engines' CUDA kernels for Hopper and their plain twins.

``vcycle_chunk`` runs up to K Vcycles of B whole machines in one launch of
``csrc/vcycle_chunk.cu``. It replaces both TPU kernels on the main path,
``repro/kernels/vcycle.py:199 _chunk_kernel`` (one stimulus, bound here as
B=1) and ``repro/kernels/vcycle.py:262 _chunk_kernel_batched`` (a grid over
B). ``vcycle_prologue`` is the same kernel in its prologue-only mode: it
applies a modulo-pipelined program's iteration-0 prologue once.

``vcycle_seed`` runs one Vcycle of one machine with the full ISA select and
the whole ``[T, C]`` result trace, in ``csrc/vcycle_seed.cu``. It replaces
``repro/kernels/vcycle.py:45 _vcycle_kernel``, the kernel of the seed arm
``Machine(specialize=False)``.

Both kernels execute global memory (GLD/GST) on the privileged core, with
its direct-mapped cache and stall counters (``kernels/ref.py``).

``vcycle_chunk_ref``/``prologue_ref``/``vcycle_seed_ref`` are the plain
PyTorch versions. A wrapper runs them only when it is handed CPU tensors;
on CUDA tensors it launches the kernel or raises.

Both kernels execute 32-byte code rows laid out once at bind time
(``kernels/rows.py``): the chunk kernel each core's live rows only
(``chunk_rows``), the seed kernel every slot (``seed_rows``). A wrapper
handed no such tables lays them out from the dense ones; handed them, it
neither reads nor checks the dense tables, which may then lie on the
host.

Both kernels are built at first use with ``nvcc``, with every other kernel
of the port, into one shared library with a plain C interface
(``kernels/build.py``) and loaded through ``ctypes``.

Layouts (all int32 tensors; machine words are uint32 bit patterns):
code ``[T, Cp, 7]`` | cap ``[T, Cp]`` | luts ``[Cp, L, 16]`` | dcore/dreg
``[max(n_sends, 1)]`` | regs ``[B, C, R]`` | spads ``[B, C, S]`` | flags
``[B, C]`` | cyc ``[B]`` | gmem ``[B, G]`` | tags ``[B, LINES]`` | counters
``[B, 4]``. ``Cp >= C`` is the padded core count of the program tables;
only the first C cores carry state. ``vcycle_seed`` takes one machine: the
same state without the leading ``[B]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .build import check, load
from .ref import (CacheModel, Glob, decode, exec_rows, from_glob, from_u32,
                  global_core, to_glob, to_u32, vcycle_seed_ref)
from .rows import RowTables, chunk_rows, seed_rows

# launches of each CUDA kernel since the last reset (the CPU path and the
# plain versions never count)
COUNTS = {"vcycle_chunk": 0, "vcycle_seed": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------- plain ----
def vcycle_chunk_ref(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                     budget: int, *, K: int, n_sends: int, num_pro: int = 0,
                     gmem=None, tags=None, counters=None,
                     cache: Optional[CacheModel] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Up to K Vcycles of B machines, slot by slot, as
    ``repro.kernels.vcycle._chunk_kernel_batched`` computes them. Per
    element and Vcycle: freeze unless ``cyc + nexec < budget`` and no flag
    is set; run body rows ``[num_pro, T)`` with compact SEND capture and,
    for a program with GLD/GST, global memory through the cache model;
    the exchange ``regs[dcore, dreg] = sbuf``; then prologue rows
    ``[0, num_pro)``, committed iff the Vcycle raised no flag. Returns
    (regs, spads, flags, nexec [B]), int32, followed by (gmem, tags,
    counters) when ``gmem`` is given (``counters[:, 0]`` is left to the
    caller). The code tables may lie on the host: they are read on
    ``regs``'s device."""
    B, C, _ = regs.shape
    code, cap, luts, dcore, dreg = (t.to(regs.device) for t in
                                    (code, cap, luts, dcore, dreg))
    g = None
    if gmem is not None:
        g = to_glob(gmem, tags, counters, cache)
    elif global_core(code, C) >= 0:
        raise ValueError("vcycle_chunk: the program holds GLD/GST but no "
                         "global memory was given")
    slots = decode(code[:, :C], cap[:, :C])
    body, pro = slots[num_pro:], slots[:num_pro]
    lt = to_u32(luts[:C])
    r, s, f = to_u32(regs), to_u32(spads), to_u32(flags)
    dc, dr = dcore[:n_sends].long(), dreg[:n_sends].long()
    base = cyc.to(torch.int64)
    nexec = torch.zeros(B, dtype=torch.int64, device=regs.device)
    for _ in range(K):
        active = (base + nexec < budget) & (f == 0).all(1)
        if not bool(active.any()):
            break
        r2, s2, f2 = r.clone(), s.clone(), f.clone()
        g2 = None if g is None else Glob(
            *(x.clone() for x in g[:3]), g.cache)
        sbuf = torch.zeros((B, n_sends + 1), dtype=torch.int64,
                           device=regs.device)
        exec_rows(body, lt, r2, s2, f2, sbuf, glob=g2)
        if n_sends:
            r2[:, dc, dr] = sbuf[:, :n_sends]
        if pro:
            r3 = r2.clone()
            exec_rows(pro, lt, r3, s2, f2, regs_only=True)
            r2 = torch.where((f2 == 0).all(1)[:, None, None], r3, r2)
        a = active[:, None]
        r = torch.where(a[..., None], r2, r)
        s = torch.where(a[..., None], s2, s)
        f = torch.where(a, f2, f)
        if g is not None:
            g = Glob(*(torch.where(a, n, o) for n, o in zip(g2[:3], g[:3])),
                     g.cache)
        nexec += active.to(torch.int64)
    out = (from_u32(r), from_u32(s), from_u32(f), nexec.to(torch.int32))
    return out if g is None else out + from_glob(g)


def prologue_ref(code, luts, regs, spads, *, num_pro: int) -> torch.Tensor:
    """Code rows ``[0, num_pro)`` once on every element (register writes
    only: a prologue holds pure opcodes). Returns the new regs. ``code``
    and ``luts`` may lie on the host."""
    B, C, _ = regs.shape
    code, luts = code.to(regs.device), luts.to(regs.device)
    r = to_u32(regs)
    exec_rows(decode(code[:num_pro, :C]), to_u32(luts[:C]), r,
              to_u32(spads), torch.zeros((B, C), dtype=torch.int64,
                                         device=regs.device),
              regs_only=True)
    return from_u32(r)


class RegLayout(NamedTuple):
    """The kernel's packed register file: core c keeps registers
    ``[0, rows[c])`` at shared-memory word ``roff[c]`` (``roff`` has C+1
    entries, on the kernel's device). A core's rows are every register its
    own code or the exchange names, so the packing changes no result."""
    roff: torch.Tensor
    words: int          # roff[C]
    rmax: int           # max rows[c]


def reg_layout(code, dcore, dreg, C: int, n_sends: int,
               device="cuda") -> RegLayout:
    """Packed register layout for the first C cores of ``code [T, Cp, 7]``
    (host arrays or tensors) and the exchange ``dcore``/``dreg``. Raises
    on a negative register index or an exchange outside the C cores, which
    would address shared memory outside the element's state."""
    code, dcore, dreg = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                         for x in (code, dcore, dreg))
    fields = code[:, :C, 1:6]
    dcore, dreg = dcore[:n_sends], dreg[:n_sends]
    if (fields.min(initial=0) < 0 or dreg.min(initial=0) < 0
            or not np.all((0 <= dcore) & (dcore < C))):
        raise ValueError("vcycle_chunk: negative register index or an "
                         f"exchange outside the {C} cores")
    rows = fields.max(axis=(0, 2)).astype(np.int64) + 1
    np.maximum.at(rows, dcore, dreg.astype(np.int64) + 1)
    roff = np.concatenate([[0], np.cumsum(rows)]).astype(np.int32)
    return RegLayout(torch.from_numpy(roff).to(device), int(roff[-1]),
                     int(rows.max()))


# the distinct LUT truth tables are staged in a block's shared memory up to
# this size; past it the kernels read them from global memory. Staged, a
# LUT row's table read leaves device memory and L1 out of the row's chain:
# on the card the chunk kernel ran 1-4% faster with them staged and the
# seed kernel up to 19% (PERF.md). The nine circuits need 0.2-2.9 KB; the
# limit keeps staging under a third of the ~56 KB a block may take while
# four blocks share an SM (mc at 512 seeds in one wave).
STAGE_LUT_BYTES = 16384
# cores one block of the seed kernel runs (kCores in csrc/vcycle_seed.cu)
SEED_CORES_PER_BLOCK = 4


def stage_luts(n_tts: int) -> bool:
    return 64 * n_tts <= STAGE_LUT_BYTES


class SeedLayout(NamedTuple):
    """The seed kernel's tables: every slot's row (``seed_rows``) of the
    first C cores over T slots, and the packed registers each block
    stages: core c's registers ``[0, rows[c])`` at word ``roff[c] -
    roff[c0]`` of its block (first core c0), rows[c] being every register
    its code names; ``block_words`` is the most words a block holds and
    ``rmax`` the largest rows[c]."""
    rows: RowTables
    roff: torch.Tensor
    block_words: int
    T: int
    rmax: int


def seed_layout(code, luts, C: int, device="cuda") -> SeedLayout:
    """``SeedLayout`` of the first C cores of ``code [T, Cp, 7]`` and
    ``luts [Cp, L, 16]`` (host arrays or tensors)."""
    none = np.zeros((0,), np.int32)
    lay = reg_layout(code, none, none, C, 0, device)
    firsts = np.r_[0:C:SEED_CORES_PER_BLOCK, C]
    words = np.diff(lay.roff.cpu().numpy()[firsts])
    return SeedLayout(seed_rows(code, luts, C, device), lay.roff,
                      int(words.max(initial=0)), int(code.shape[0]),
                      lay.rmax)


_MAX_SMEM = {}


def max_smem() -> int:
    """Opt-in shared memory per block on the current device."""
    dev = torch.cuda.current_device()
    if dev not in _MAX_SMEM:
        out = ctypes.c_int(0)
        check("vcycle_chunk", load().vcycle_max_smem(ctypes.byref(out)))
        _MAX_SMEM[dev] = out.value
    return _MAX_SMEM[dev]


def _cuda_int32(kernel: str, tensors, device) -> None:
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError(f"{kernel} takes int32 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
        if t.device != device:
            raise ValueError(f"{kernel} tensors on different devices")


def _global_args(kernel: str, gmem, tags, counters, cache, gcore: int,
                 lead: tuple, device):
    """Copies of the global state for the kernel to update in place, and
    the launch's (G, lines, line_words, hit_stall, miss_stall, gcore).
    Null pointers and zeros for a program without GLD/GST."""
    if gmem is None:
        if gcore >= 0:
            raise ValueError(f"{kernel}: the program holds GLD/GST but no "
                             "global memory was given")
        return (None, None, None), (None, None, None), (0, 0, 0, 0, 0, -1)
    _cuda_int32(kernel, (gmem, tags, counters), device)
    if (cache is None or gmem.dim() != len(lead) + 1
            or tags.dim() != len(lead) + 1 or gmem.shape[:-1] != lead
            or tags.shape[:-1] != lead or counters.shape != lead + (4,)
            or gmem.shape[-1] < 1 or tags.shape[-1] < 1
            or cache.line_words < 1):
        raise ValueError(f"{kernel} global memory mismatch: gmem "
                         f"{tuple(gmem.shape)}, tags {tuple(tags.shape)}, "
                         f"counters {tuple(counters.shape)}, cache {cache}")
    bufs = tuple(t.clone(memory_format=torch.contiguous_format)
                 for t in (gmem, tags, counters))
    return bufs, tuple(t.data_ptr() for t in bufs), (
        gmem.shape[-1], tags.shape[-1], cache.line_words, cache.hit_stall,
        cache.miss_stall, gcore)


def _dense_shapes(kernel: str, code, luts, C: int, cap=None) -> int:
    """Check the dense tables (``code [T, Cp, 7]``, ``luts [Cp, L, 16]``,
    ``cap [T, Cp]``) that a wrapper lays out itself; returns T."""
    T, Cp, _ = code.shape
    L = luts.shape[1]
    if (Cp < C or tuple(luts.shape) != (Cp, L, 16) or L < 1
            or (cap is not None and tuple(cap.shape) != (T, Cp))):
        raise ValueError(f"{kernel} shape mismatch: code "
                         f"{tuple(code.shape)}, luts {tuple(luts.shape)}, "
                         f"cap {None if cap is None else tuple(cap.shape)} "
                         f"for C={C} cores")
    return T


def _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
            budget: int, K: int, n_sends: int, num_pro: int,
            prologue_only: bool, layout: Optional[RegLayout],
            glob=(None, None, None), cache: Optional[CacheModel] = None,
            gcore: Optional[int] = None, rows: Optional[RowTables] = None):
    B, C, R = regs.shape
    if rows is None or layout is None or gcore is None:
        T = _dense_shapes("vcycle_chunk", code, luts, C, cap)
        if not 0 <= num_pro <= T:
            raise ValueError(f"vcycle_chunk: num_pro={num_pro} outside "
                             f"[0, {T}]")
        if rows is None:
            rows = chunk_rows(code, cap, luts, C, num_pro, n_sends,
                              regs.device)
        if layout is None:
            layout = reg_layout(code, dcore, dreg, C, n_sends, regs.device)
        if gcore is None:
            gcore = global_core(code, C)
    tensors = (*rows[:3], dcore, dreg, layout.roff, regs, spads, flags, cyc)
    _cuda_int32("vcycle_chunk", tensors, regs.device)
    S = spads.shape[2]
    if (spads.shape[:2] != (B, C) or flags.shape != (B, C)
            or cyc.shape != (B,) or dcore.shape[0] < max(n_sends, 1)
            or dreg.shape[0] < max(n_sends, 1) or S < 1
            or layout.roff.shape != (C + 1,) or layout.rmax > R
            or rows.ctab.shape != (C, 4)):
        raise ValueError(f"vcycle_chunk shape mismatch: regs "
                         f"{tuple(regs.shape)}, spads {tuple(spads.shape)}, "
                         f"flags {tuple(flags.shape)}, cyc "
                         f"{tuple(cyc.shape)}, register rows up to "
                         f"{layout.rmax}, row tables of "
                         f"{rows.ctab.shape[0]} cores")
    bufs, gptrs, gints = _global_args("vcycle_chunk", *glob, cache, gcore,
                                      (B,), regs.device)
    with torch.cuda.device(regs.device):
        lib = load()
        need, in_smem, staged = _chunk_plan(
            torch.cuda.current_device(), C, rows.n_rows, layout.words, S,
            n_sends, rows.n_tts)
        args = [t.contiguous() for t in tensors[3:]]
        regs_o = torch.empty_like(regs)
        spads_o = torch.empty_like(spads)
        flags_o = torch.empty_like(flags)
        nexec = torch.empty((B,), dtype=torch.int32, device=regs.device)
        stream = torch.cuda.current_stream(regs.device).cuda_stream
        err = lib.vcycle_chunk_launch(
            *(t.data_ptr() for t in rows[:3]), *(t.data_ptr() for t in args),
            regs_o.data_ptr(), spads_o.data_ptr(), flags_o.data_ptr(),
            nexec.data_ptr(), *gptrs, B, C, R, S, n_sends, rows.n_rows,
            rows.n_tts, in_smem, staged, K, min(int(budget), 2**31 - 1),
            int(prologue_only), layout.words, *gints, stream)
        check("vcycle_chunk", err)
    COUNTS["vcycle_chunk"] += 1
    out = (regs_o, spads_o, flags_o, nexec)
    return out if bufs[0] is None else out + bufs


@functools.lru_cache(maxsize=None)
def _chunk_plan(dev: int, C: int, n_rows: int, reg_words: int, S: int,
                n_sends: int, n_tts: int) -> Tuple[int, int, int]:
    """(shared memory bytes a block takes, stage_luts, stage_rows) for the
    chunk kernel at this shape on device ``dev`` (the current one): the
    rows are staged in shared memory when they fit a block, else
    streamed. Raises when the thread count or the state does not fit."""
    lib = load()
    if C > lib.vcycle_chunk_max_threads():
        raise ValueError(f"vcycle_chunk runs one thread per core: C={C} "
                         f"exceeds {lib.vcycle_chunk_max_threads()} "
                         "threads per block")
    in_smem = int(stage_luts(n_tts))
    shape = (C, n_rows, reg_words, S, n_sends, n_tts, in_smem)
    have = max_smem()
    need, staged = lib.vcycle_chunk_smem(*shape, 1), 1
    if need > have:
        need, staged = lib.vcycle_chunk_smem(*shape, 0), 0
    if need > have:
        raise ValueError(
            "vcycle_chunk state does not fit one block's shared memory: "
            f"{reg_words} packed registers + C={C} cores x S={S} scratchpad "
            f"words + {n_sends + 1} SEND words = {need} bytes > {have} "
            "bytes")
    return need, in_smem, staged


def chunk_occupancy(C: int, rows: RowTables, reg_words: int, S: int,
                    n_sends: int, has_global: bool) -> Tuple[int, int, bool]:
    """(dynamic shared memory bytes a block takes, blocks one SM of the
    current device holds, whether the rows are staged) for the chunk
    kernel at this shape, for a program with or without GLD/GST."""
    lib, out = load(), ctypes.c_int(0)
    smem, in_smem, staged = _chunk_plan(torch.cuda.current_device(), C,
                                        rows.n_rows, reg_words, S, n_sends,
                                        rows.n_tts)
    check("vcycle_chunk", lib.vcycle_chunk_blocks_per_sm(
        C, rows.n_rows, reg_words, S, n_sends, rows.n_tts, in_smem, staged,
        int(has_global), ctypes.byref(out)))
    return smem, out.value, bool(staged)


def seed_check(code, C: int, R: int) -> int:
    """Validate ``code [T, Cp, 7]`` (host array or tensor) for the seed
    kernel, which indexes its cores' register rows without bounds: every
    register field of the first C cores must lie in ``[0, R)``. Returns
    the privileged core (``global_core``)."""
    fields = np.asarray(code[:, :C, 1:6].cpu() if torch.is_tensor(code)
                        else code[:, :C, 1:6])
    if fields.size and (fields.min() < 0 or fields.max() >= R):
        raise ValueError(f"vcycle_seed: a register index outside [0, {R})")
    return global_core(code, C)


@functools.lru_cache(maxsize=None)
def _seed_plan(dev: int, T: int, block_words: int, S: int,
               n_tts: int) -> Tuple[int, int, int]:
    """(shared memory bytes a block takes, stage_luts, stage_rows) for the
    seed kernel at this shape on device ``dev`` (the current one). Raises
    when the state does not fit."""
    lib = load()
    in_smem = int(stage_luts(n_tts))
    shape = (T, block_words, S, n_tts, in_smem)
    have = max_smem()
    need, staged = lib.vcycle_seed_smem(*shape, 1), 1
    if need > have:
        need, staged = lib.vcycle_seed_smem(*shape, 0), 0
    if need > have:
        raise ValueError(
            "vcycle_seed state does not fit one block's shared memory: "
            f"{block_words} packed registers + {SEED_CORES_PER_BLOCK} cores "
            f"x S={S} scratchpad words = {need} bytes > {have} bytes")
    return need, in_smem, staged


def _launch_seed(code, luts, regs, spads, flags, glob, cache, gcore,
                 tables: Optional[SeedLayout]):
    C, R = regs.shape
    if tables is None or gcore is None:
        _dense_shapes("vcycle_seed", code, luts, C)
        if gcore is None:
            gcore = seed_check(code, C, R)
        if tables is None:
            tables = seed_layout(code, luts, C, regs.device)
    rows = tables.rows
    _cuda_int32("vcycle_seed", (regs, spads, flags), regs.device)
    S = spads.shape[1]
    T = tables.T
    if (spads.shape != (C, S) or flags.shape != (C,) or S < 1
            or tables.roff.shape != (C + 1,) or tables.rmax > R
            or rows.n_rows != C * T or rows.rows.device != regs.device):
        raise ValueError(f"vcycle_seed shape mismatch: regs "
                         f"{tuple(regs.shape)}, spads {tuple(spads.shape)}, "
                         f"flags {tuple(flags.shape)}, tables of "
                         f"{rows.n_rows} rows for C={C} cores x T={T} "
                         f"slots on {rows.rows.device}, register rows up to "
                         f"{tables.rmax}")
    bufs, gptrs, gints = _global_args("vcycle_seed", *glob, cache, gcore,
                                      (), regs.device)
    with torch.cuda.device(regs.device):
        lib = load()
        need, in_smem, staged = _seed_plan(
            torch.cuda.current_device(), T, tables.block_words, S,
            rows.n_tts)
        state = [t.contiguous() for t in (regs, spads, flags)]
        regs_o = torch.empty_like(regs)
        spads_o = torch.empty_like(spads)
        flags_o = torch.empty_like(flags)
        trace = torch.empty((T, C), dtype=torch.int32, device=regs.device)
        stream = torch.cuda.current_stream(regs.device).cuda_stream
        err = lib.vcycle_seed_launch(
            rows.rows.data_ptr(), rows.tts.data_ptr(),
            tables.roff.data_ptr(), *(t.data_ptr() for t in state),
            regs_o.data_ptr(), spads_o.data_ptr(), flags_o.data_ptr(),
            trace.data_ptr(), *gptrs, C, T, R, S, rows.n_tts, in_smem,
            staged, tables.block_words, *gints, stream)
        check("vcycle_seed", err)
    COUNTS["vcycle_seed"] += 1
    out = (regs_o, spads_o, flags_o, trace)
    return out if bufs[0] is None else out + bufs


# ------------------------------------------------------------- wrappers ----
def vcycle_chunk(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                 budget: int, *, K: int, n_sends: int, num_pro: int = 0,
                 layout: Optional[RegLayout] = None, gmem=None, tags=None,
                 counters=None, cache: Optional[CacheModel] = None,
                 gcore: Optional[int] = None,
                 rows: Optional[RowTables] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Up to K Vcycles of B machines in one launch; see
    ``vcycle_chunk_ref`` for the semantics. Returns (regs, spads, flags,
    nexec [B]) as new tensors, followed by new (gmem, tags, counters) when
    ``gmem`` is given. ``layout`` is the program's packed register layout
    (``reg_layout``), ``gcore`` its privileged core (``global_core``) and
    ``rows`` its compacted code rows (``rows.chunk_rows`` of the same
    tables, ``n_sends`` and ``num_pro``), each computed here when not
    given."""
    if regs.device.type == "cpu":
        return vcycle_chunk_ref(code, cap, luts, dcore, dreg, regs, spads,
                                flags, cyc, budget, K=K, n_sends=n_sends,
                                num_pro=num_pro, gmem=gmem, tags=tags,
                                counters=counters, cache=cache)
    return _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                   budget, K, n_sends, num_pro, False, layout,
                   (gmem, tags, counters), cache, gcore, rows)


def vcycle_prologue(code, cap, luts, dcore, dreg, regs, spads, *,
                    num_pro: int, layout: Optional[RegLayout] = None,
                    rows: Optional[RowTables] = None) -> torch.Tensor:
    """Iteration 0's prologue (code rows ``[0, num_pro)``, register writes
    only) on every element, through the chunk kernel's prologue-only
    mode. Returns the new regs."""
    if regs.device.type == "cpu":
        return prologue_ref(code, luts, regs, spads, num_pro=num_pro)
    B, C, _ = regs.shape
    flags = torch.zeros((B, C), dtype=torch.int32, device=regs.device)
    cyc = torch.zeros((B,), dtype=torch.int32, device=regs.device)
    return _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                   0, 0, 0, num_pro, True, layout, gcore=-1, rows=rows)[0]


def vcycle_seed(code, luts, regs, spads, flags, gmem=None, tags=None,
                counters=None, *, cache: Optional[CacheModel] = None,
                gcore: Optional[int] = None,
                tables: Optional[SeedLayout] = None
                ) -> Tuple[torch.Tensor, ...]:
    """One Vcycle of one machine in one launch; see ``vcycle_seed_ref`` for
    the semantics and the shapes. Returns (regs, spads, flags, trace
    [T, C]) as new tensors, followed by new (gmem, tags, counters) when
    ``gmem`` is given. ``gcore`` is the privileged core from
    ``seed_check`` and ``tables`` the program's ``seed_layout``, each
    computed here when not given."""
    if regs.device.type == "cpu":
        return vcycle_seed_ref(code, luts, regs, spads, flags, gmem, tags,
                               counters, cache)
    return _launch_seed(code, luts, regs, spads, flags,
                        (gmem, tags, counters), cache, gcore, tables)
