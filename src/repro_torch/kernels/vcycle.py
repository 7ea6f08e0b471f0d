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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .build import check, load
from .ref import (CacheModel, Glob, decode, exec_rows, from_glob, from_u32,
                  global_core, to_glob, to_u32, vcycle_seed_ref)

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
    caller)."""
    B, C, _ = regs.shape
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
    only: a prologue holds pure opcodes). Returns the new regs."""
    B, C, _ = regs.shape
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


def smem_bytes(reg_words: int, C: int, S: int, n_sends: int) -> int:
    """Dynamic shared memory one block holds: the element's packed register
    file and scratchpad for the whole launch, plus the SEND buffer."""
    return 4 * (reg_words + C * max(S, 1) + n_sends + 1)


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


def _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
            budget: int, K: int, n_sends: int, num_pro: int,
            prologue_only: bool, layout: Optional[RegLayout],
            glob=(None, None, None), cache: Optional[CacheModel] = None,
            gcore: Optional[int] = None):
    if layout is None:
        layout = reg_layout(code, dcore, dreg, regs.shape[1], n_sends,
                            regs.device)
    tensors = (code, cap, luts, dcore, dreg, layout.roff, regs, spads,
               flags, cyc)
    _cuda_int32("vcycle_chunk", tensors, regs.device)
    T, Cp, _ = code.shape
    B, C, R = regs.shape
    S = spads.shape[2]
    L = luts.shape[1]
    if (Cp < C or cap.shape != (T, Cp) or luts.shape != (Cp, L, 16)
            or spads.shape[:2] != (B, C) or flags.shape != (B, C)
            or cyc.shape != (B,) or dcore.shape[0] < max(n_sends, 1)
            or dreg.shape[0] < max(n_sends, 1) or S < 1 or L < 1
            or not 0 <= num_pro <= T or layout.roff.shape != (C + 1,)
            or layout.rmax > R):
        raise ValueError("vcycle_chunk shape mismatch: code "
                         f"{tuple(code.shape)}, cap {tuple(cap.shape)}, luts "
                         f"{tuple(luts.shape)}, regs {tuple(regs.shape)}, "
                         f"spads {tuple(spads.shape)}, flags "
                         f"{tuple(flags.shape)}, cyc {tuple(cyc.shape)}, "
                         f"register rows up to {layout.rmax}")
    if C > 1024:
        raise ValueError(f"vcycle_chunk runs one thread per core: C={C} "
                         "exceeds 1024 threads per block")
    if gcore is None:
        gcore = global_core(code, C)
    bufs, gptrs, gints = _global_args("vcycle_chunk", *glob, cache, gcore,
                                      (B,), regs.device)
    with torch.cuda.device(regs.device):
        lib = load()
        need = smem_bytes(layout.words, C, S, n_sends)
        have = max_smem()
        if need > have:
            raise ValueError(
                "vcycle_chunk state does not fit one block's shared memory: "
                f"{layout.words} packed registers + C={C} cores x S={S} "
                f"scratchpad words + {n_sends + 1} SEND words = {need} "
                f"bytes > {have} bytes")
        args = [t.contiguous() for t in tensors]
        regs_o = torch.empty_like(args[6])
        spads_o = torch.empty_like(args[7])
        flags_o = torch.empty_like(args[8])
        nexec = torch.empty((B,), dtype=torch.int32, device=regs.device)
        stream = torch.cuda.current_stream(regs.device).cuda_stream
        err = lib.vcycle_chunk_launch(
            *(t.data_ptr() for t in args), regs_o.data_ptr(),
            spads_o.data_ptr(), flags_o.data_ptr(), nexec.data_ptr(), *gptrs,
            B, C, Cp, T, R, S, L, n_sends, num_pro, K,
            min(int(budget), 2**31 - 1), int(prologue_only), layout.words,
            *gints, stream)
        check("vcycle_chunk", err)
    COUNTS["vcycle_chunk"] += 1
    out = (regs_o, spads_o, flags_o, nexec)
    return out if bufs[0] is None else out + bufs


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


def _launch_seed(code, luts, regs, spads, flags, glob, cache, gcore):
    _cuda_int32("vcycle_seed", (code, luts, regs, spads, flags), regs.device)
    T, Cp, _ = code.shape
    C, R = regs.shape
    S = spads.shape[1]
    L = luts.shape[1]
    if (Cp < C or luts.shape != (Cp, L, 16) or spads.shape != (C, S)
            or flags.shape != (C,) or S < 1 or L < 1 or R < 1):
        raise ValueError("vcycle_seed shape mismatch: code "
                         f"{tuple(code.shape)}, luts {tuple(luts.shape)}, "
                         f"regs {tuple(regs.shape)}, spads "
                         f"{tuple(spads.shape)}, flags {tuple(flags.shape)}")
    if gcore is None:
        gcore = seed_check(code, C, R)
    bufs, gptrs, gints = _global_args("vcycle_seed", *glob, cache, gcore,
                                      (), regs.device)
    with torch.cuda.device(regs.device):
        lib = load()
        args = [t.contiguous() for t in (code, luts, regs, spads, flags)]
        regs_o = torch.empty_like(args[2])
        spads_o = torch.empty_like(args[3])
        flags_o = torch.empty_like(args[4])
        trace = torch.empty((T, C), dtype=torch.int32, device=regs.device)
        stream = torch.cuda.current_stream(regs.device).cuda_stream
        err = lib.vcycle_seed_launch(
            *(t.data_ptr() for t in args), regs_o.data_ptr(),
            spads_o.data_ptr(), flags_o.data_ptr(), trace.data_ptr(), *gptrs,
            C, Cp, T, R, S, L, *gints, stream)
        check("vcycle_seed", err)
    COUNTS["vcycle_seed"] += 1
    out = (regs_o, spads_o, flags_o, trace)
    return out if bufs[0] is None else out + bufs


# ------------------------------------------------------------- wrappers ----
def vcycle_chunk(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                 budget: int, *, K: int, n_sends: int, num_pro: int = 0,
                 layout: Optional[RegLayout] = None, gmem=None, tags=None,
                 counters=None, cache: Optional[CacheModel] = None,
                 gcore: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Up to K Vcycles of B machines in one launch; see
    ``vcycle_chunk_ref`` for the semantics. Returns (regs, spads, flags,
    nexec [B]) as new tensors, followed by new (gmem, tags, counters) when
    ``gmem`` is given. ``layout`` is the program's packed register layout
    (``reg_layout``) and ``gcore`` its privileged core (``global_core``),
    computed here when not given."""
    if regs.device.type == "cpu":
        return vcycle_chunk_ref(code, cap, luts, dcore, dreg, regs, spads,
                                flags, cyc, budget, K=K, n_sends=n_sends,
                                num_pro=num_pro, gmem=gmem, tags=tags,
                                counters=counters, cache=cache)
    return _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                   budget, K, n_sends, num_pro, False, layout,
                   (gmem, tags, counters), cache, gcore)


def vcycle_prologue(code, cap, luts, dcore, dreg, regs, spads, *,
                    num_pro: int, layout: Optional[RegLayout] = None
                    ) -> torch.Tensor:
    """Iteration 0's prologue (code rows ``[0, num_pro)``, register writes
    only) on every element, through the chunk kernel's prologue-only
    mode. Returns the new regs."""
    if regs.device.type == "cpu":
        return prologue_ref(code, luts, regs, spads, num_pro=num_pro)
    B, C, _ = regs.shape
    flags = torch.zeros((B, C), dtype=torch.int32, device=regs.device)
    cyc = torch.zeros((B,), dtype=torch.int32, device=regs.device)
    return _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                   0, 0, 0, num_pro, True, layout, gcore=-1)[0]


def vcycle_seed(code, luts, regs, spads, flags, gmem=None, tags=None,
                counters=None, *, cache: Optional[CacheModel] = None,
                gcore: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """One Vcycle of one machine in one launch; see ``vcycle_seed_ref`` for
    the semantics and the shapes. Returns (regs, spads, flags, trace
    [T, C]) as new tensors, followed by new (gmem, tags, counters) when
    ``gmem`` is given. ``gcore`` is the privileged core from
    ``seed_check``, which runs here when it is not given."""
    if regs.device.type == "cpu":
        return vcycle_seed_ref(code, luts, regs, spads, flags, gmem, tags,
                               counters, cache)
    return _launch_seed(code, luts, regs, spads, flags,
                        (gmem, tags, counters), cache, gcore)
