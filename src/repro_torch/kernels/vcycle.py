"""The chunked K-Vcycle engine: a CUDA kernel for Hopper and its plain twin.

``vcycle_chunk`` runs up to K Vcycles of B whole machines in one launch of
``csrc/vcycle_chunk.cu``. It replaces both TPU kernels on the main path,
``repro/kernels/vcycle.py:199 _chunk_kernel`` (one stimulus, bound here as
B=1) and ``repro/kernels/vcycle.py:262 _chunk_kernel_batched`` (a grid over
B). ``vcycle_prologue`` is the same kernel in its prologue-only mode: it
applies a modulo-pipelined program's iteration-0 prologue once.

``vcycle_chunk_ref``/``prologue_ref`` are the plain PyTorch versions. A
wrapper runs them only when it is handed CPU tensors; on CUDA tensors it
launches the kernel or raises.

The kernel is built at first use with ``nvcc`` into a shared library with a
plain C interface (``build/`` beside this file, named by the hash of the
source and flags) and loaded through ``ctypes``.

Layouts (all int32 tensors; machine words are uint32 bit patterns):
code ``[T, Cp, 7]`` | cap ``[T, Cp]`` | luts ``[Cp, L, 16]`` | dcore/dreg
``[max(n_sends, 1)]`` | regs ``[B, C, R]`` | spads ``[B, C, S]`` | flags
``[B, C]`` | cyc ``[B]``. ``Cp >= C`` is the padded core count of the
program tables; only the first C cores carry state.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .ref import decode, exec_rows, from_u32, to_u32

# launches of each CUDA kernel since the last reset (the CPU path and the
# plain versions never count)
COUNTS = {"vcycle_chunk": 0}

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "vcycle_chunk.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------- plain ----
def vcycle_chunk_ref(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                     budget: int, *, K: int, n_sends: int, num_pro: int = 0
                     ) -> Tuple[torch.Tensor, ...]:
    """Up to K Vcycles of B machines, slot by slot, as
    ``repro.kernels.vcycle._chunk_kernel_batched`` computes them. Per
    element and Vcycle: freeze unless ``cyc + nexec < budget`` and no flag
    is set; run body rows ``[num_pro, T)`` with compact SEND capture; the
    exchange ``regs[dcore, dreg] = sbuf``; then prologue rows
    ``[0, num_pro)``, committed iff the Vcycle raised no flag. Returns
    (regs, spads, flags, nexec [B]), int32."""
    B, C, _ = regs.shape
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
        sbuf = torch.zeros((B, n_sends + 1), dtype=torch.int64,
                           device=regs.device)
        exec_rows(body, lt, r2, s2, f2, sbuf)
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
        nexec += active.to(torch.int64)
    return from_u32(r), from_u32(s), from_u32(f), nexec.to(torch.int32)


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


# ---------------------------------------------------------------- build ----
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the vcycle_chunk CUDA kernel")


def build() -> Tuple[Path, str]:
    """Compile ``csrc/vcycle_chunk.cu`` for sm_90a unless a library built
    from the same source and flags exists. Returns (library path, the
    compiler's ``-Xptxas -v`` report)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"vcycle_chunk_{tag[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    tmp.replace(lib)
    return lib, log.read_text()


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.vcycle_chunk_launch.argtypes = [p] * 14 + [i] * 13 + [p]
            lib.vcycle_chunk_launch.restype = i
            lib.vcycle_error_string.argtypes = [i]
            lib.vcycle_error_string.restype = ctypes.c_char_p
            lib.vcycle_max_smem.argtypes = [ctypes.POINTER(i)]
            lib.vcycle_max_smem.restype = i
            _lib = lib
    return _lib


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
        lib = _load()
        out = ctypes.c_int(0)
        _check(lib, lib.vcycle_max_smem(ctypes.byref(out)))
        _MAX_SMEM[dev] = out.value
    return _MAX_SMEM[dev]


def _check(lib, err: int) -> None:
    if err:
        raise RuntimeError("vcycle_chunk CUDA error "
                           f"{err}: {lib.vcycle_error_string(err).decode()}")


def _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
            budget: int, K: int, n_sends: int, num_pro: int,
            prologue_only: bool, layout: Optional[RegLayout]):
    if layout is None:
        layout = reg_layout(code, dcore, dreg, regs.shape[1], n_sends,
                            regs.device)
    tensors = (code, cap, luts, dcore, dreg, layout.roff, regs, spads,
               flags, cyc)
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.int32:
            raise ValueError("vcycle_chunk takes int32 CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
        if t.device != regs.device:
            raise ValueError("vcycle_chunk tensors on different devices")
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
    with torch.cuda.device(regs.device):
        lib = _load()
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
            spads_o.data_ptr(), flags_o.data_ptr(), nexec.data_ptr(), B, C,
            Cp, T, R, S, L, n_sends, num_pro, K,
            min(int(budget), 2**31 - 1), int(prologue_only), layout.words,
            stream)
        _check(lib, err)
    COUNTS["vcycle_chunk"] += 1
    return regs_o, spads_o, flags_o, nexec


# ------------------------------------------------------------- wrappers ----
def vcycle_chunk(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                 budget: int, *, K: int, n_sends: int, num_pro: int = 0,
                 layout: Optional[RegLayout] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """Up to K Vcycles of B machines in one launch; see
    ``vcycle_chunk_ref`` for the semantics. Returns (regs, spads, flags,
    nexec [B]) as new tensors. ``layout`` is the program's packed register
    layout (``reg_layout``), computed here when not given."""
    if regs.device.type == "cpu":
        return vcycle_chunk_ref(code, cap, luts, dcore, dreg, regs, spads,
                                flags, cyc, budget, K=K, n_sends=n_sends,
                                num_pro=num_pro)
    return _launch(code, cap, luts, dcore, dreg, regs, spads, flags, cyc,
                   budget, K, n_sends, num_pro, False, layout)


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
                   0, 0, 0, num_pro, True, layout)[0]

