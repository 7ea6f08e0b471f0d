#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the chunked Vcycle kernel from ``src/repro_torch/kernels/csrc``,
holds it bit for bit against its plain PyTorch version on the card (all
nine full circuits on the paper's 15x15 grid at B=8 seeds, both the single
and the batched binding, run to the end; random programs with mid-chunk
exceptions, budgets and prologues), then drives the main path
``repro_torch.sim.compile("mc", scale="full", seeds=range(512)).run()`` and
checks every result. Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, with no such line, when
any phase fails, when no CUDA device is present, or when run outside a
checkout.
"""
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

NAMES = ("bc", "blur", "cgra", "jpeg", "mc", "mm", "noc", "rv32r", "vta")
CHECK_SEEDS = 8
MAIN_SCALE = "full"
MAIN_SEEDS = 512
MAIN_FINISH = 130          # mc/full raises FINISH at cycle n_cycles + 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# INT32 issue rate: the H100 SXM's 67 TFLOP/s FP32 peak is 132 SMs x 128
# lanes x 2 (FMA) x 1.98 GHz; each SM has 64 INT32 lanes, one op per clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def compile_full(name: str, n_seeds: int):
    """Worker: build and compile one full circuit on the default 15x15 grid
    with ``n_seeds`` stimuli (host-only numpy work)."""
    from repro_torch.circuits import build
    from repro_torch.core.compile import compile_circuit
    from repro_torch.core.isa import HardwareConfig
    t0 = time.perf_counter()
    b = build(name, "full", seeds=range(n_seeds))
    prog = compile_circuit(b.circuit, HardwareConfig())
    images = b.images_batch(prog)
    return name, b.n_cycles, prog, images, time.perf_counter() - t0


# ------------------------------------------------------------ phases ----
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build(kv, build_future):
    path, log = build_future.result()
    info = [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "registers" in ln]
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "ptxas": info})


def _same(a, b) -> int:
    """Max |a - b| over int32 tensors (0 iff bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_chunk(kv, args, budget, kw, tag, layout=None):
    """One chunk through the kernel and the plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_chunk(*args, budget, layout=layout, **kw)
    out_p = kv.vcycle_chunk_ref(*args, budget, **kw)
    for name, a, b in zip(("regs", "spads", "flags", "nexec"), out_k,
                          out_p):
        err = _same(a, b)
        if err:
            raise AssertionError(f"{tag}: kernel != plain in {name} "
                                 f"(max abs err {err})")
    return out_k


def phase_circuit(torch, kv, bsp, IsaSim, item):
    """Kernel vs plain, chunk by chunk to the end, for one full circuit:
    batched binding on all elements, single binding on element 0, and the
    prologue-only launch at init."""
    name, n_cycles, prog, images, compile_s = item
    cells = set(zip(prog.xchg_dst_core.tolist(), prog.xchg_dst_reg.tolist()))
    if len(cells) != prog.n_sends:
        raise AssertionError(f"{name}: two exchange entries share a "
                             "destination register")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    bm = bsp.BatchedMachine(prog, images=images, device=dev)
    sm = bsp.Machine(prog, device=dev)
    kb, ks = bm._kernel, sm._kernel
    C, R = bm.C, bm.R
    raw = bsp.to_words(np.asarray(images[0])[:, :C, :R], dev)
    if kb.num_pro:
        pro = kv.prologue_ref(kb.code, kb.luts, raw, bm.bspad0,
                              num_pro=kb.num_pro)
        if _same(pro, bm.breg0):
            raise AssertionError(f"{name}: prologue kernel != plain")
    st = bm.init_state()
    regs, spads, flags = st.regs, st.spads, st.flags
    cyc = torch.zeros((bm.B,), dtype=torch.int32, device=dev)
    budget = n_cycles + 10
    kw = dict(K=kb.K, n_sends=kb.n_sends, num_pro=kb.num_pro)
    chunks = 0
    while True:
        args = (*kb.tables(), regs, spads, flags, cyc)
        regs2, spads2, flags2, nexec = check_chunk(
            kv, args, budget, kw, f"{name} chunk {chunks}", kb.layout)
        carry0 = tuple(x[0] for x in (regs, spads, st.gmem, flags,
                                      st.cache_tags, st.counters))
        cyc1, out1 = ks(cyc[:1].clone(), budget, carry0)
        for nm, a, b in (("regs", out1[0], regs2[0]),
                         ("spads", out1[1], spads2[0]),
                         ("flags", out1[3], flags2[0]),
                         ("cyc", cyc1, cyc[:1] + nexec[:1])):
            if _same(a, b):
                raise AssertionError(f"{name}: single binding != batched "
                                     f"in {nm}")
        regs, spads, flags, cyc = regs2, spads2, flags2, cyc + nexec
        chunks += 1
        if bool(flags.ne(0).any(1).all()) or int(cyc.min()) >= budget:
            break
    exc = [sorted(set(int(e) for e in row if e))
           for row in bsp.from_words(flags)]
    cycles = cyc.tolist()
    if any(e != [1] for e in exc) or any(c != n_cycles for c in cycles):
        raise AssertionError(f"{name}: not all FINISH at {n_cycles}: "
                             f"{exc} {cycles}")
    # element 0's images as the program's own init: IsaSim then applies
    # iteration 0's prologue to them itself
    isa = IsaSim(dataclasses.replace(prog, reg_init=images[0][0],
                                     spad_init=images[1][0]))
    isa.run(budget)
    if not np.array_equal(isa.regs, bsp.from_words(regs[0])):
        raise AssertionError(f"{name}: element 0 != IsaSim")
    S = int(prog.spad_init.shape[1])
    emit({"phase": "kernel_vs_plain", "circuit": name, "B": bm.B, "C": C,
          "T": int(prog.code.shape[1]), "R": R, "S": S,
          "state_kb_dense": 4 * C * (R + S) / 1024,
          "state_kb_packed": 4 * (kb.layout.words + C * S) / 1024,
          "n_sends": kb.n_sends,
          "prologue": kb.num_pro, "finish_cycle": n_cycles,
          "chunks": chunks, "max_abs_err": 0, "compile_s": compile_s,
          "check_s": time.perf_counter() - t0})


def phase_random(torch, kv, random_chunk):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2023)
    cases = []
    K = 16
    C, T, R, S, L, n_sends = 90, 48, 40, 24, 32, 40
    for B, num_pro, budget in ((1, 0, 1000), (8, 0, 20), (8, 4, 1000),
                               (3, 6, 9)):
        arrays = random_chunk(rng, rng.choice([3, 7, 11, 100], B), C, T, R,
                              S, L, n_sends, num_pro, Cp=((C + 31) // 32) * 32)
        args = tuple(torch.from_numpy(a).to(dev) for a in arrays) + (
            torch.zeros((B, C), dtype=torch.int32, device=dev),
            torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev))
        kw = dict(K=K, n_sends=n_sends, num_pro=num_pro)
        _, _, flags, nexec = check_chunk(kv, args, budget, kw,
                                         f"random B={B} pro={num_pro}")
        cases.append({"B": B, "num_pro": num_pro, "budget": budget,
                      "nexec": nexec.tolist(),
                      "raised": flags.ne(0).any(1).tolist()})
    mid = [n for c in cases for n, r in zip(c["nexec"], c["raised"])
           if r and 0 < n < K]
    if not mid:
        raise AssertionError("no random program froze mid-chunk")
    emit({"phase": "random_programs", "cases": cases, "max_abs_err": 0})


def phase_main(torch, kv, sim, IsaEngine):
    """The user's call at full width, counted and checked."""
    t0 = time.perf_counter()
    s = sim.compile("mc", scale=MAIN_SCALE, seeds=range(MAIN_SEEDS))
    compile_s = time.perf_counter() - t0
    kv.reset_counts()
    t0 = time.perf_counter()
    results = s.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = kv.COUNTS["vcycle_chunk"]
    if launches <= 0:
        raise AssertionError("main path launched no vcycle_chunk kernel")
    if len(results) != MAIN_SEEDS:
        raise AssertionError(f"{len(results)} results, not {MAIN_SEEDS}")
    bad = [r.batch_index for r in results
           if not r.finished or r.cycles != MAIN_FINISH]
    if bad:
        raise AssertionError(f"elements not FINISHed at {MAIN_FINISH}: "
                             f"{bad[:10]}")
    t0 = time.perf_counter()
    stacked = s.images_stacked()
    images_s = time.perf_counter() - t0
    for i in range(4):
        ref = IsaEngine(s.program, images=tuple(a[i] for a in stacked)) \
            .run(s.default_cycles())
        r = results[i]
        if (ref.cycles, ref.exceptions, ref.registers) != \
                (r.cycles, r.exceptions, r.registers):
            raise AssertionError(f"element {i} != IsaSim")
    # aggregate simulated Vcycles/s: the engine alone, host clock around
    # work that ends in a synchronize
    eng = s.engine()
    rates = []
    for _ in range(3):
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.m.run(eng.state, s.default_cycles())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(eng.m.perf(st)["vcycles"] / dt)
    # the same run plus the per-element RunResult snapshots
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_batch(s.default_cycles())
    run_batch_s = time.perf_counter() - t0
    emit({"phase": "main_path", "call": "repro_torch.sim.compile('mc', "
          f"scale='{MAIN_SCALE}', seeds=range({MAIN_SEEDS})).run()",
          "B": MAIN_SEEDS,
          "all_finished_at": MAIN_FINISH, "isasim_checked": 4,
          "launches": launches, "compile_s": compile_s, "run_s": run_s,
          "images_s": images_s, "run_batch_s": run_batch_s,
          "vcycles_per_s": rates, "C": eng.m.C, "R": eng.m.R,
          "T": int(s.program.code.shape[1])})
    return eng, launches


def phase_timing(torch, kv, eng):
    """One chunk at the main path's shapes: kernel (CUDA events, after
    warm-up), plain version, and the bound."""
    m = eng.m
    k = m._kernel
    st = m.init_state()
    cyc = torch.zeros((m.B,), dtype=torch.int32, device=m.device)
    args = (*k.tables(), st.regs, st.spads, st.flags, cyc)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro)
    budget = 10**6
    for _ in range(3):
        out = kv.vcycle_chunk(*args, budget, layout=k.layout, **kw)
    n = 20
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        out = kv.vcycle_chunk(*args, budget, layout=k.layout, **kw)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / n
    e0.record()
    ref = kv.vcycle_chunk_ref(*args, budget, **kw)
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)
    err = max(_same(a, b) for a, b in zip(out, ref))
    if err:
        raise AssertionError(f"timed chunk: kernel != plain ({err})")
    nexec = out[3].long()
    T, Cp, _ = k.code.shape
    B, C, R = st.regs.shape
    S = st.spads.shape[2]
    L = k.luts.shape[1]
    M = k.dcore.shape[0]
    nbytes = 4 * (T * Cp * 7 + T * Cp + Cp * L * 16 + 2 * M
                  + 2 * (B * C * R + B * C * S + B * C) + 2 * B)
    ops = int(nexec.sum()) * T * C
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err, "shape": {"B": B, "C": C, "T": T, "R": R,
                                          "S": S, "K": k.K},
            "vcycles_per_chunk": nexec.tolist()[:1], "bytes": nbytes,
            "int_ops": ops}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch.sim as sim
        from repro_torch.core import bsp
        from repro_torch.core.isasim import IsaSim
        from repro_torch.kernels import vcycle as kv
        from repro_torch.kernels.randprog import random_chunk
        from repro_torch.sim.engine import IsaEngine
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    workers = max(1, min(len(NAMES), (os.cpu_count() or 2) - 1))
    with cf.ThreadPoolExecutor(1) as nvcc, cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn")) as pool:
        build_future = nvcc.submit(kv.build)
        compiles = [pool.submit(compile_full, n, CHECK_SEEDS) for n in NAMES]
        smi = phase_device(torch)
        phase_build(kv, build_future)
        phase_random(torch, kv, random_chunk)
        for fut in cf.as_completed(compiles):
            phase_circuit(torch, kv, bsp, IsaSim, fut.result())
    eng, launches = phase_main(torch, kv, sim, IsaEngine)
    timing = phase_timing(torch, kv, eng)
    kernel = {"name": "vcycle_chunk", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/vcycle_chunk.cu",
              "replaces": "src/repro/kernels/vcycle.py:199 _chunk_kernel; "
                          "src/repro/kernels/vcycle.py:262 "
                          "_chunk_kernel_batched",
              "launches": launches, "max_abs_err": timing["max_abs_err"],
              "ms": timing["ms"], "plain_ms": timing["plain_ms"],
              "bound_ms": timing["bound_ms"],
              "bound_by": timing["bound_by"], "library_ms": None}
    emit({"phase": "timing", **timing})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
