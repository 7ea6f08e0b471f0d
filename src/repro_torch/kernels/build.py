"""Build and load the port's CUDA kernels: every ``csrc/*.cu`` in one library.

Each source is compiled for sm_90a by its own ``nvcc -c``, all started
together, and the objects are linked into one shared library with a plain
C interface, ``build/kernels_<hash>.so`` beside this file, named by the
hash of every source, header and flag. It is built at first use and loaded
through ``ctypes``; no module builds anything when it is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build() -> Tuple[Path, str]:
    """Compile ``SOURCES`` for sm_90a into one shared library, unless one
    built from the same sources, headers and flags exists: one ``nvcc -c``
    per source, all started together, then one link. Returns (library
    path, the compiler's -Xptxas -v report)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (*SOURCES, *HEADERS):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"kernels_{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tmp = _nvcc(), lib.with_name(f".{lib.name}.{os.getpid()}")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for obj, src in zip(objs, SOURCES)]
    report = "".join(p.communicate()[0] for p in procs)
    try:
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed on "
                               f"{', '.join(s.name for s in SOURCES)}:\n"
                               f"{report}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    log.write_text(report)
    tmp.replace(lib)
    return lib, report


def load() -> ctypes.CDLL:
    """The built library, with every C entry point's argument types set
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()[0]))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.vcycle_chunk_launch.argtypes = [p] * 17 + [i] * 19 + [p]
            lib.vcycle_chunk_launch.restype = i
            lib.vcycle_chunk_smem.argtypes = [i] * 8
            lib.vcycle_chunk_smem.restype = ctypes.c_size_t
            lib.vcycle_chunk_blocks_per_sm.argtypes = [i] * 9 + [
                ctypes.POINTER(i)]
            lib.vcycle_chunk_blocks_per_sm.restype = i
            lib.vcycle_chunk_max_threads.argtypes = []
            lib.vcycle_chunk_max_threads.restype = i
            lib.vcycle_seed_launch.argtypes = [p] * 13 + [i] * 14 + [p]
            lib.vcycle_seed_launch.restype = i
            lib.vcycle_seed_smem.argtypes = [i] * 6
            lib.vcycle_seed_smem.restype = ctypes.c_size_t
            lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 6 + [
                ctypes.c_float, p]
            lib.flash_attention_launch.restype = i
            lib.flash_attention_sm90_launch.argtypes = [p] * 5 + [i] * 5 + [
                ctypes.c_float, p]
            lib.flash_attention_sm90_launch.restype = i
            lib.flash_attention_bwd_launch.argtypes = [p] * 10 + [i] * 6 + [
                ctypes.c_float, p]
            lib.flash_attention_bwd_launch.restype = i
            lib.flash_attention_smem_bytes.argtypes = [i, i]
            lib.flash_attention_smem_bytes.restype = i
            lib.flash_attention_blocks_per_sm.argtypes = [i]
            lib.flash_attention_blocks_per_sm.restype = i
            lib.flash_attention_bwd_smem_bytes.argtypes = [i, i, i]
            lib.flash_attention_bwd_smem_bytes.restype = i
            lib.flash_attention_bwd_blocks_per_sm.argtypes = [i, i]
            lib.flash_attention_bwd_blocks_per_sm.restype = i
            lib.tf32x3_rounding_mismatches.argtypes = [p, i, p, p]
            lib.tf32x3_rounding_mismatches.restype = i
            lib.flash_attention_bwd_sm90_launch.argtypes = [p] * 10 + [
                i] * 5 + [ctypes.c_float, p]
            lib.flash_attention_bwd_sm90_launch.restype = i
            lib.flash_attention_bwd_sm90_smem_bytes.argtypes = [i, i]
            lib.flash_attention_bwd_sm90_smem_bytes.restype = i
            lib.flash_attention_sm90_smem_bytes.argtypes = [i]
            lib.flash_attention_sm90_smem_bytes.restype = i
            lib.vcycle_error_string.argtypes = [i]
            lib.vcycle_error_string.restype = ctypes.c_char_p
            lib.vcycle_max_smem.argtypes = [ctypes.POINTER(i)]
            lib.vcycle_max_smem.restype = i
            _lib = lib
    return _lib


def check(kernel: str, err: int) -> None:
    """Raise when a C entry point returned a CUDA error (the launch was
    refused or a runtime call failed)."""
    if err:
        msg = load().vcycle_error_string(err).decode()
        raise RuntimeError(f"{kernel} CUDA error {err}: {msg}")
