#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc -c``
per source, all in parallel, linked into one library) and holds each
against its plain PyTorch version on the card:

* the chunk kernel, bit for bit, on all nine full circuits on the paper's
  15x15 grid at B=8 seeds, both the single and the batched binding, run to
  the end, and on random programs with mid-chunk exceptions, budgets,
  prologues and global memory;
* the seed kernel, bit for bit, on random programs (32-bit words, global
  memory) and on the first two Vcycles of each of the nine full circuits;
* flash attention against ``flash_ref`` (fp32 within 1e-4, bf16 within
  2e-2) at the reference kernel test's five shapes, GQA, a tail tile, a
  non-causal shape and the qwen3-0.6b prefill's, each on the kernel that
  ``flash_attention`` routes it to: bf16 (dh 64 or 128) on the wgmma
  kernel ``flash_attention_sm90.cu``, float32 (and bf16 at other head
  dims) on the 3xTF32 kernel ``flash_attention.cu``, there also saving lse
  (within 1e-5 of ``flash_ref``'s in fp32); each case's error against
  ``flash_ref`` in float64 beside it; the 3xTF32 split's rounding against
  ``cvt.rna.tf32.f32``;
* the backward flash kernel ``flash_attention_bwd.cu`` against
  ``flash_bwd_ref`` (each of dq, dk, dv within 1e-4 of its max in fp32,
  2e-2 in bf16) at the same cases, launched twice for the same bits,
  computing lse itself and, at the cases ``flash_attention.cu`` runs,
  given that kernel's lse (against ``flash_bwd_ref(lse=)``, with the error
  against ``flash_bwd_ref`` in float64 beside it); and at the bf16 cases
  with dh 64 or 128 the wgmma backward kernel
  ``flash_attention_bwd_sm90.cu`` against ``flash_bwd_ref(lse=)`` with lse
  from the forward kernel (within 2e-2 of each output's max, the same bits
  on a relaunch).

Then it drives the paths, each through the calls a user makes, with the
launch counts set to 0 just before and read just after:

* the seed arm, ``repro_torch.sim.compile(name, scale="full")
  .run(engine="seed")`` on all nine circuits, equal to ``engine="machine"``
  and to the numpy ISA simulator;
* Fig 8 (global memory: FIFO vs RAM at 1/64/512 KiB) through ``machine``,
  ``seed`` and ``batched`` (B=64 seeds), equal to the ISA simulator;
* the main path ``repro_torch.sim.compile("mc", scale="full",
  seeds=range(512)).run()``;
* the multi-device engines on one and on four shards of the card:
  ``run(engine="sharded", devices=["cuda:0"] * 4)`` on the main path's
  512 seeds, and ``ShardedBatchedMachine`` (mc/full at B=512 and 510,
  bc/full at B=64) and ``GridMachine`` (mc/full and bc/full, one stimulus
  and 64) each bit-equal to ``BatchedMachine`` or ``Machine``;
* LM serving, ``repro_torch.launch.steps.make_serve_steps`` on qwen3-0.6b
  at full width (random weights from a seed): B=4 prompts of 2048 tokens,
  one prefill (28 ``flash_attention_sm90`` launches) and 32 greedy decode
  steps in bf16; in float32 the prefill (28 ``flash_attention_simt``
  launches) equals the same model on ``flash_ref`` and the first decode
  step equals a full forward over the 2049 tokens;
* LM training, ``repro_torch.launch.steps.make_train_step`` on qwen3-0.6b
  at full width in bf16 over ``TokenPipeline`` batches of 4 x 2048
  tokens: a warm-up step and three timed ones, each 56
  ``flash_attention_sm90`` launches (the forward, saving lse, and its
  recompute) and 28 ``flash_attention_bwd_sm90``, every leaf with a
  gradient; in float32 at two layers (on ``flash_attention_simt`` and
  ``flash_attention_bwd``) the step's gradients equal the same step on
  ``flash_ref`` under autograd, and 2 steps, a checkpoint, a restore and
  1 step equal 3 steps bit for bit;

and times each kernel against its bound (both flash kernels, the wgmma
one also saving lse, the plain version and SDPA in turns at the
prefill's shape in bf16, the 3xTF32 kernel with and without lse, the
plain version and SDPA in turns in float32, and in bf16 both backward
kernels, the plain version and SDPA's backward in turns, in float32 the
3xTF32 one with and without lse; the float32 rows give the fp32
CUDA-core bound and the 3xTF32 tensor-core bound). Each
Vcycle case of the timing also reports what bounds the kernel: the
busiest core's rows a Vcycle (``busy_rows``), the kernel's ns per such row
(``ns_per_busy_row``), the bytes of code rows it reads a launch
(``code_bytes``) and, for the chunk kernel, its shared memory a block,
blocks an SM and waves. Each phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
such line, when any phase fails, when no CUDA device is present, or when
run outside a checkout.
"""
import asyncio
import concurrent.futures as cf
import contextlib
import dataclasses
import io
import json
import multiprocessing as mp
import os
import re
import subprocess
import sys
import tempfile
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
FIG8_N = 2048              # benchmarks/fig8_global_stall.py
FIG8_SEEDS = 64
FIG8_KIB = (1, 64, 512)
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_CTX = LM_PROMPT + 64
LM_GREEDY_CHECK = 8        # greedy tokens compared in float32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
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


def timed_build(kbuild):
    t0 = time.perf_counter()
    path, log = kbuild.build()
    return path, log, time.perf_counter() - t0


# each kernel's name in the compiler's report: the first key that its
# mangled entry function holds
PTXAS_KERNELS = {"flash_attention_bwd_sm90_delta_kernel":
                 "flash_attention_bwd_sm90",
                 "flash_attention_bwd_sm90_dkdv_kernel":
                 "flash_attention_bwd_sm90",
                 "flash_attention_bwd_sm90_dq_kernel":
                 "flash_attention_bwd_sm90",
                 "vcycle_chunk_kernel": "vcycle_chunk",
                 "vcycle_seed_kernel": "vcycle_seed",
                 "flash_attention_sm90_kernel": "flash_attention_sm90",
                 "flash_attention_kernel": "flash_attention_simt",
                 "tf32x3_rounding_kernel": "tf32x3_rounding",
                 "flash_attention_bwd_delta_kernel": "flash_attention_bwd",
                 "flash_attention_bwd_dkdv_kernel": "flash_attention_bwd",
                 "flash_attention_bwd_dq_kernel": "flash_attention_bwd"}


def phase_build(kbuild, build_future):
    """The library every kernel is built into, with each kernel's
    registers a thread, static shared memory and spills from the
    compiler's -Xptxas -v report (the most over a kernel's template
    instances), and the flash kernels' dynamic shared memory (and, for the
    3xTF32 ones in float32, blocks an SM). Those kernels (each backward
    kernel's three entry functions counted as one) and the two Vcycle
    kernels must not spill."""
    t0 = time.perf_counter()
    path, log, build_s = build_future.result()
    ptxas, kernel = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            kernel = next((name for key, name in PTXAS_KERNELS.items()
                           if key in m.group(1)), m.group(1))
            ptxas.setdefault(kernel, {"registers": 0, "smem_bytes": 0,
                                      "spill_bytes": 0})
        if kernel is None:
            continue
        info = ptxas[kernel]
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("spill_bytes", r"(\d+) bytes spill stores")):
            m = re.search(pat, ln)
            if m:
                info[key] = max(info[key], int(m.group(1)))
        m = re.search(r"(\d+) bytes spill loads", ln)
        if m:
            info["spill_bytes"] = max(info["spill_bytes"], int(m.group(1)))
    lib = kbuild.load()
    if "flash_attention_sm90" in ptxas:
        ptxas["flash_attention_sm90"]["dynamic_smem_bytes"] = {
            dh: lib.flash_attention_sm90_smem_bytes(dh) for dh in (64, 128)}
    if "flash_attention_bwd_sm90" in ptxas:
        ptxas["flash_attention_bwd_sm90"]["dynamic_smem_bytes"] = {
            dh: {"dkdv": lib.flash_attention_bwd_sm90_smem_bytes(dh, 0),
                 "dq": lib.flash_attention_bwd_sm90_smem_bytes(dh, 1)}
            for dh in (64, 128)}
    for name, smem, blocks in (
            ("flash_attention_simt",
             lambda dh, bf: lib.flash_attention_smem_bytes(dh, bf),
             lambda dh: {"fwd": lib.flash_attention_blocks_per_sm(dh)}),
            ("flash_attention_bwd",
             lambda dh, bf: {"dkdv": lib.flash_attention_bwd_smem_bytes(
                 0, dh, bf), "dq": lib.flash_attention_bwd_smem_bytes(
                     1, dh, bf)},
             lambda dh: {"dkdv": lib.flash_attention_bwd_blocks_per_sm(0, dh),
                         "dq": lib.flash_attention_bwd_blocks_per_sm(1, dh)})):
        if name in ptxas:
            ptxas[name]["dynamic_smem_bytes"] = {
                f"{dt}_dh{dh}": smem(dh, int(dt == "bf16"))
                for dt in ("fp32", "bf16") for dh in (32, 64, 128)}
            ptxas[name]["fp32_blocks_per_sm"] = {
                dh: blocks(dh) for dh in (32, 64, 128)}
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "registers_per_thread": {k: v["registers"]
                                   for k, v in ptxas.items()},
          "ptxas": ptxas, "ptxas_warnings": [
              ln.strip() for ln in log.splitlines() if "arning" in ln],
          "build_s": build_s, "waited_s": time.perf_counter() - t0})
    for name in ("flash_attention_sm90", "flash_attention_simt",
                 "flash_attention_bwd", "flash_attention_bwd_sm90",
                 "vcycle_chunk", "vcycle_seed"):
        info = ptxas.get(name)
        if info is None or info["spill_bytes"]:
            raise AssertionError(f"{name}: not built or spills ({info})")


def _same(a, b) -> int:
    """Max |a - b| over int32 tensors (0 iff bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


OUTPUTS = ("regs", "spads", "flags", "nexec", "gmem", "tags", "counters")
SEED_OUTPUTS = ("regs", "spads", "flags", "trace", "gmem", "tags",
                "counters")


def check_chunk(kv, args, budget, kw, tag, layout=None, rows=None):
    """One chunk through the kernel and the plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_chunk(*args, budget, layout=layout, rows=rows, **kw)
    out_p = kv.vcycle_chunk_ref(*args, budget, **kw)
    if len(out_k) != len(out_p):
        raise AssertionError(f"{tag}: {len(out_k)} outputs != "
                             f"{len(out_p)}")
    for name, a, b in zip(OUTPUTS, out_k, out_p):
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
            kv, args, budget, kw, f"{name} chunk {chunks}", kb.layout,
            kb.rows)
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


def phase_random(torch, kv, random_chunk, CacheModel):
    dev = torch.device("cuda")
    rng = np.random.default_rng(2023)
    cases = []
    K = 16
    C, T, R, S, L, n_sends = 90, 48, 40, 24, 32, 40
    for B, num_pro, budget, G in ((1, 0, 1000, 0), (8, 0, 20, 0),
                                  (8, 4, 1000, 0), (3, 6, 9, 0),
                                  (8, 2, 1000, 5000)):
        arrays = random_chunk(rng, rng.choice([3, 7, 11, 100], B), C, T, R,
                              S, L, n_sends, num_pro,
                              Cp=((C + 31) // 32) * 32, G=G)
        arrays = [torch.from_numpy(a).to(dev) for a in arrays]
        args = tuple(arrays[:7]) + (
            torch.zeros((B, C), dtype=torch.int32, device=dev),
            torch.from_numpy(rng.integers(0, 8, B).astype(np.int32)).to(dev))
        kw = dict(K=K, n_sends=n_sends, num_pro=num_pro)
        if G:
            kw.update(gmem=arrays[7], tags=arrays[8], counters=arrays[9],
                      cache=CacheModel(32, 14, 120))
        out = check_chunk(kv, args, budget, kw,
                          f"random B={B} pro={num_pro} G={G}")
        flags, nexec = out[2], out[3]
        cases.append({"B": B, "num_pro": num_pro, "budget": budget,
                      "G": G, "nexec": nexec.tolist(),
                      "raised": flags.ne(0).any(1).tolist()})
    mid = [n for c in cases for n, r in zip(c["nexec"], c["raised"])
           if r and 0 < n < K]
    if not mid:
        raise AssertionError("no random program froze mid-chunk")
    emit({"phase": "random_programs", "cases": cases, "max_abs_err": 0})


def check_seed(kv, args, glob, tag, **kw):
    """One Vcycle through the seed kernel and its plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_seed(*args, *glob, **kw)
    kw.pop("gcore", None)
    kw.pop("tables", None)
    out_p = kv.vcycle_seed_ref(*args, *glob, **kw)
    if len(out_k) != len(out_p):
        raise AssertionError(f"{tag}: {len(out_k)} outputs != "
                             f"{len(out_p)}")
    for name, a, b in zip(SEED_OUTPUTS, out_k, out_p):
        err = _same(a, b)
        if err:
            raise AssertionError(f"{tag}: seed kernel != plain in {name} "
                                 f"(max abs err {err})")
    return out_k


def phase_seed_random(torch, kv, random_vcycle, CacheModel):
    """The seed kernel on random programs: the five (C, T, R, S) shapes of
    tests/test_kernels.py, a full-width one, and three with GLD/GST on one
    core; 32-bit words throughout, so the masked register write shows."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    cache = CacheModel(32, 14, 120)
    cases = []
    for C, T, R, S, G in ((1, 4, 8, 16, 0), (4, 16, 32, 64, 0),
                          (8, 32, 64, 32, 0), (16, 8, 16, 16, 0),
                          (6, 12, 24, 48, 0), (225, 137, 143, 4, 0),
                          (1, 29, 22, 5, 4096), (4, 64, 24, 8, 100),
                          (130, 64, 40, 4, 262144)):
        arrays = [torch.from_numpy(a).to(dev) for a in random_vcycle(
            rng, C, T, R, S, 32, G, 2048 if G > 4096 else 8, gcore=C - 1,
            Cp=((C + 31) // 32) * 32)]
        out = check_seed(kv, arrays[:5], arrays[5:], f"random C={C} T={T}",
                         cache=cache)
        cases.append({"C": C, "T": T, "R": R, "S": S, "G": G,
                      "raised": int(out[2].ne(0).sum())})
    emit({"phase": "seed_vs_plain", "programs": "random", "cases": cases,
          "max_abs_err": 0})


def check_seed_circuit(torch, kv, bsp, item):
    """The first two seed Vcycles of one full circuit (element 0 of its
    seeded build), kernel against plain, the exchange applied between."""
    name, _, prog, images, _ = item
    m = bsp.Machine(prog, device=torch.device("cuda"), specialize=False)
    carry = tuple(m.init_state(tuple(a[0] for a in images)))
    b = m._seed
    for v in range(2):
        regs, spads, gmem, flags, tags, counters = carry
        glob = (gmem, tags, counters) if b.gcore >= 0 else ()
        check_seed(kv, (b.code, b.luts, regs, spads, flags), glob,
                   f"{name} Vcycle {v}", cache=b.cache, gcore=b.gcore,
                   tables=b.tables)
        carry = m._vcycle_seed(carry)
    emit({"phase": "seed_vs_plain", "circuit": name, "C": m.C,
          "T": int(prog.code.shape[1]), "R": m.R,
          "prologue_rows": int(prog.pipe_prologue), "vcycles": 2,
          "max_abs_err": 0})


def _result_key(r, perf=True):
    key = (r.cycles, r.exceptions, r.registers, r.outputs)
    return key + (r.perf,) if perf else key


def _vcycles_per_s(torch, eng, n):
    """Simulated Vcycles/s of one engine run: host clock around work that
    ends in a synchronize."""
    eng.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eng.run(n)
    torch.cuda.synchronize()
    return r.cycles / (time.perf_counter() - t0)


def phase_seed_arm(torch, kv, sim, name):
    """This slice's path at full width: one circuit through
    ``run(engine="seed")``, counted, against ``run(engine="machine")`` and
    the numpy ISA simulator."""
    t0 = time.perf_counter()
    s = sim.compile(name, scale="full")
    compile_s = time.perf_counter() - t0
    kv.reset_counts()
    seed = s.run(engine="seed")
    torch.cuda.synchronize()
    counts = dict(kv.COUNTS)
    if counts["vcycle_seed"] <= 0 or counts["vcycle_chunk"]:
        raise AssertionError(f"{name}: the seed path launched {counts}")
    kv.reset_counts()
    machine = s.run(engine="machine")
    torch.cuda.synchronize()
    machine_counts = dict(kv.COUNTS)
    if machine_counts["vcycle_chunk"] <= 0 or machine_counts["vcycle_seed"]:
        raise AssertionError(f"{name}: the machine path launched "
                             f"{machine_counts}")
    isa = s.run(engine="isa")
    if not seed.finished or _result_key(seed) != _result_key(machine):
        raise AssertionError(f"{name}: seed arm != machine")
    if _result_key(seed, False) != _result_key(isa, False):
        raise AssertionError(f"{name}: seed arm != IsaSim")
    n = s.default_cycles()
    rates = {k: _vcycles_per_s(torch, s.engine(k), n)
             for k in ("seed", "machine")}
    emit({"phase": "seed_arm", "circuit": name,
          "call": f"repro_torch.sim.compile('{name}', scale='full')"
                  ".run(engine='seed')",
          "C": s.program.used_cores, "T": int(s.program.code.shape[1]),
          "R": s.program.used_reg_count(), "finish_cycle": seed.cycles,
          "equal_to": ["machine", "isa"], "launches": counts,
          "machine_launches": machine_counts,
          "seed_vcycles_per_s": rates["seed"],
          "machine_vcycles_per_s": rates["machine"],
          "compile_s": compile_s})
    return s, counts["vcycle_seed"], machine_counts["vcycle_chunk"]


def _isa_check(IsaEngine, s, images, n, runs, tag):
    """Registers and global memory of one stimulus against IsaSim;
    ``runs`` maps an engine's name to its (registers, gmem)."""
    isa = IsaEngine(s.program, images=images)
    r = isa.run(n)
    for name, (regs, gmem) in runs.items():
        if r.registers != regs:
            raise AssertionError(f"{tag} {name}: registers != IsaSim")
        if not np.array_equal(isa.sim.gmem, gmem):
            raise AssertionError(f"{tag} {name}: gmem != IsaSim")


def phase_fig8(torch, kv, sim, bsp, IsaEngine, build_membench, hw, cache_cls):
    """Fig 8 on the card: FIFO vs RAM at 1/64/512 KiB through ``machine``,
    ``seed`` and ``batched`` (B=64 seeds), counted; registers and gmem
    equal IsaSim, ``perf()`` identical across the engines, and the chunk
    kernel equal to its plain version on the first two chunks of each
    global config. Prints machine cycles normalised to 1 KiB and the hit
    rate (benchmarks/fig8_global_stall.py's numbers)."""
    rows, batched = [], {}
    for kind in ("fifo", "ram"):
        base = None
        for kib in FIG8_KIB:
            tag = f"{kind}/{kib}KiB"
            s = sim.compile(build_membench(kind, kib, n_cycles=FIG8_N), hw)
            sb = sim.compile(build_membench(kind, kib, n_cycles=FIG8_N,
                                            seeds=range(FIG8_SEEDS)), hw)
            n = s.default_cycles()
            kv.reset_counts()
            engines = {k: s.engine(k) for k in ("machine", "seed")}
            res = {k: e.run(n) for k, e in engines.items()}
            bat = sb.engine("batched")
            res_b = bat.run_batch(n)
            e0 = {k: sb.engine(k) for k in ("machine", "seed")}
            res0 = {k: e.run(n) for k, e in e0.items()}
            torch.cuda.synchronize()
            counts = dict(kv.COUNTS)
            if min(counts.values()) <= 0:
                raise AssertionError(f"{tag}: launches {counts}")
            if (res["machine"].cycles != FIG8_N + 1
                    or not all(r.finished for r in res_b)):
                raise AssertionError(f"{tag}: not FINISHed at {FIG8_N + 1}")
            if _result_key(res["machine"]) != _result_key(res["seed"]):
                raise AssertionError(f"{tag}: seed != machine")
            if not (_result_key(res0["machine"]) == _result_key(res0["seed"])
                    == _result_key(res_b[0])):
                raise AssertionError(f"{tag}: seed 0 differs across engines")
            _isa_check(IsaEngine, s, None, n, {
                k: (res[k].registers, bsp.from_words(e.state.gmem))
                for k, e in engines.items()}, tag)
            _isa_check(IsaEngine, sb, tuple(a[0] for a in
                                            sb.images_stacked()), n,
                       {"batched": (res_b[0].registers,
                                    bsp.from_words(bat.state.gmem[0]))},
                       tag)
            chunks = 0
            if s.program.has_global:
                chunks = check_fig8_chunks(torch, kv, bat, n, tag)
            batched[(kind, kib)] = bat
            perf = res["machine"].perf
            cyc = perf["machine_cycles"]
            base = cyc if base is None else base
            acc = perf["ghits"] + perf["gmisses"]
            rows.append({
                "kind": kind, "kib": kib, "global": s.program.has_global,
                "machine_cycles": cyc, "normalized": cyc / base,
                "hit_rate": perf["ghits"] / acc if acc else 1.0,
                "ghits": perf["ghits"], "gmisses": perf["gmisses"],
                "stall_cycles": perf["stall_cycles"],
                "batched_machine_cycles": bat.perf()["machine_cycles"],
                "launches": counts, "chunks_vs_plain": chunks})
    emit({"phase": "fig8", "n_cycles": FIG8_N, "B": FIG8_SEEDS,
          "engines": ["machine", "seed", "batched"],
          "equal_to": "IsaSim (registers, gmem); perf across engines",
          "rows": rows})
    return batched[("ram", 512)]


def check_fig8_chunks(torch, kv, bat, n, tag):
    """The batched binding's first two chunks, kernel against plain,
    global memory and counters included."""
    k = bat.m._kernel
    st = bat.m.init_state()
    regs, spads, gmem, flags, tags, counters = st
    cyc = torch.zeros((bat.m.B,), dtype=torch.int32, device=regs.device)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro, cache=k.cache)
    for c in range(2):
        args = (*k.tables(), regs, spads, flags, cyc)
        out = check_chunk(kv, args, n, dict(kw, gmem=gmem, tags=tags,
                                            counters=counters),
                          f"{tag} chunk {c}", k.layout, k.rows)
        regs, spads, flags, nexec, gmem, tags, counters = out
        cyc = cyc + nexec
    return 2


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
    return eng, launches, s, results

# the serving path (benchmarks/bench_serve.py's three modes, at full scale
# on the default 15x15 grid): mixed mc+bc traffic, 64 requests a circuit
SERVE_NAMES = ("mc", "bc")
SERVE_SCALE = "full"
SERVE_PER_CIRCUIT = 64
SERVE_WAIT_S = 0.03
SERVE_MODES = ("coalesced", "b1", "hardened")
SERVE_ISA_SEEDS = 4
CHAOS_N = 100
# elastic migrations (examples/simulate_accelerator.py): (circuit, the
# small grid's side), each moved half way to the default 15x15 grid; bc is
# modulo-pipelined on both grids, so its prologue runs on the carried state
ELASTIC_CASES = (("rv32r", 5), ("mc", 3), ("bc", 5))


def _serve_reqs(serve, seed0: int):
    """Interleaved mc, bc, mc, ... requests on seeds seed0, seed0 + 1, ..."""
    return [serve.SimRequest(nm, scale=SERVE_SCALE, seed=seed0 + i)
            for i in range(SERVE_PER_CIRCUIT) for nm in SERVE_NAMES]


async def _serve_wave(server, reqs):
    """Every request at once; per-request latency and the wave's wall."""
    lat = {}

    async def one(r):
        t0 = time.perf_counter()
        resp = await server.submit(r)
        lat[r.rid] = time.perf_counter() - t0
        return resp

    t0 = time.perf_counter()
    resps = await asyncio.gather(*(one(r) for r in reqs))
    return resps, time.perf_counter() - t0, [lat[r.rid] for r in reqs]


def _served_ok(resps, tag):
    bad = [r for r in resps if not (r.ok and r.result.finished)]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} requests not OK/finished "
                             f"(first: {bad[0].status} {bad[0].error})")


def _stages(before, after) -> dict:
    """Where a wave's launches spent their time, as the daemon timed them
    (``SimServer.stats()["stages"]``): seconds per launch, and the engines
    built for a new batch size instead of rebinding a hot one."""
    n = after["launches"] - before["launches"]
    out = {k: (after[k] - before[k]) / n for k in
           ("images_s", "engine_s", "chunks_s", "snapshots_s")}
    out["launches"] = n
    out["engines_built"] = after["engines_built"] - before["engines_built"]
    return out


async def _serve_mode(torch, kv, serve, mode, cache_dir, device):
    """One of bench_serve.py's modes: a warm-up wave, then the measured
    wave of 128 requests on seeds 1..64, its chunk launches counted."""
    faults = serve.FaultPlan(seed=0) if mode == "hardened" else None
    policy = (serve.BatchPolicy(max_batch=1, max_wait_s=0.0, max_queue=4096)
              if mode == "b1" else
              serve.BatchPolicy(max_batch=64, max_wait_s=SERVE_WAIT_S,
                                max_queue=4096))
    server = serve.SimServer(
        sessions=serve.SessionManager(cache=cache_dir, faults=faults,
                                      device=device),
        policy=policy, faults=faults,
        retry=serve.RetryPolicy() if mode == "hardened" else None)
    try:
        warm, _, _ = await _serve_wave(server, _serve_reqs(serve, 10_000))
        _served_ok(warm, f"serve {mode} warm-up")
        stats0 = server.stats()
        torch.cuda.synchronize()
        kv.reset_counts()
        resps, wall, lats = await _serve_wave(server, _serve_reqs(serve, 1))
        torch.cuda.synchronize()
        counts = dict(kv.COUNTS)
        _served_ok(resps, f"serve {mode}")
        if counts["vcycle_chunk"] <= 0 or counts["vcycle_seed"]:
            raise AssertionError(f"serve {mode}: launched {counts}")
        stats = server.stats()
        launches = stats["batcher"]["launches"] - \
            stats0["batcher"]["launches"]
        launched = stats["batcher"]["launched_requests"] - \
            stats0["batcher"]["launched_requests"]
        row = {"mode": mode, "n_requests": len(resps), "wall_s": wall,
               "rps": len(resps) / wall,
               "p50_ms": float(np.percentile(lats, 50) * 1e3),
               "p95_ms": float(np.percentile(lats, 95) * 1e3),
               "launches": launches, "mean_batch": launched / launches,
               "mean_run_s": float(np.mean([r.run_s for r in resps])),
               "chunk_launches": counts["vcycle_chunk"],
               "engine_kinds": sorted({r.engine_kind for r in resps}),
               "stages_per_launch": _stages(stats0["stages"],
                                            stats["stages"]),
               "warm_up_stages_per_launch": _stages(
                   dict.fromkeys(stats0["stages"], 0), stats0["stages"])}
        return row, resps
    finally:
        await server.close()


async def _serve_chaos(serve, chaos_drill, poison_seeds, cache_dir, device):
    """``python -m repro_torch.serve --chaos-drill``'s server and plan
    (p=0.2 at the four sites, poison seeds 666/667) on CHAOS_N requests
    at full scale; the drill's own report is returned, not printed."""
    plan = serve.FaultPlan.chaos(seed=0, p=0.2, poison_seeds=poison_seeds)
    server = serve.SimServer(
        sessions=serve.SessionManager(cache=cache_dir, faults=plan,
                                      breaker_cooldown_s=0.2,
                                      device=device),
        policy=serve.BatchPolicy(max_batch=64, max_wait_s=0.02,
                                 max_queue=256),
        faults=plan, retry=serve.RetryPolicy(
            max_attempts=8, backoff_base_s=0.01, max_extra_launches=32))
    server.sessions.compile_retries = 6
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = await chaos_drill(server, list(SERVE_NAMES), SERVE_SCALE,
                               CHAOS_N, plan)
    await server.close(drain=True)
    return rc, log.getvalue().splitlines(), server.stats()["launch"]


def phase_serve(torch, kv, sim, serve, IsaEngine, device=None):
    """The main path's last stage: ``repro_torch.serve.SimServer`` in this
    process, in bench_serve.py's three modes; every served result equal
    to a direct ``sim.compile(name, seeds=...).run()`` and, on four seeds
    a circuit, to IsaSim; then the chaos drill and the CLI's self-test."""
    from repro_torch.serve.__main__ import POISON_SEEDS, chaos_drill
    t_phase = time.perf_counter()
    seeds = list(range(1, 1 + SERVE_PER_CIRCUIT))
    with tempfile.TemporaryDirectory(prefix="serve-cache-") as cache_dir:
        modes, served = {}, {}
        for mode in SERVE_MODES:
            modes[mode], served[mode] = asyncio.run(
                _serve_mode(torch, kv, serve, mode, cache_dir, device))
        direct = {}
        for name in SERVE_NAMES:
            s = sim.compile(name, scale=SERVE_SCALE, seeds=seeds,
                            cache=cache_dir, device=device)
            results = s.run()
            if not all(r.finished for r in results):
                raise AssertionError(f"serve: direct {name} run unfinished")
            stacked = s.images_stacked()
            for i in range(SERVE_ISA_SEEDS):
                ref = IsaEngine(s.program, images=tuple(a[i] for a in
                                                        stacked)) \
                    .run(s.default_cycles())
                if _result_key(ref, False) != _result_key(results[i],
                                                           False):
                    raise AssertionError(f"serve: {name} seed {seeds[i]} "
                                         "direct run != IsaSim")
            direct[name] = dict(zip(seeds, results))
        for mode, resps in served.items():
            for req, resp in zip(_serve_reqs(serve, 1), resps):
                if _result_key(resp.result) != \
                        _result_key(direct[req.circuit][req.seed]):
                    raise AssertionError(
                        f"serve {mode}: {req.circuit} seed {req.seed} "
                        "!= the direct run")
        t0 = time.perf_counter()
        rc, drill_log, drill_launch = asyncio.run(_serve_chaos(
            serve, chaos_drill, POISON_SEEDS, cache_dir, device))
        chaos_s = time.perf_counter() - t0
        if rc:
            raise AssertionError("serve: chaos drill failed: "
                                 + " | ".join(drill_log))
        cli = [sys.executable, "-m", "repro_torch.serve", "--self-test",
               "--scale", SERVE_SCALE, "--cache-dir", cache_dir]
        if device is not None:
            cli += ["--device", str(device)]
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(cli, capture_output=True, text=True,
                             timeout=600, cwd=ROOT, env=env)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0 or "self-test ok" not in out.stdout:
            raise AssertionError(f"serve: CLI self-test failed "
                                 f"({out.returncode}): {out.stdout[-2000:]}"
                                 f"{out.stderr[-2000:]}")
    chunk_launches = sum(m["chunk_launches"] for m in modes.values())
    emit({"phase": "serve", "circuits": list(SERVE_NAMES),
          "scale": SERVE_SCALE, "grid": "15x15",
          "modes": modes, "all_ok": True, "equal_to": [
              f"sim.compile(name, seeds=1..{SERVE_PER_CIRCUIT}).run()",
              f"IsaSim ({SERVE_ISA_SEEDS} seeds a circuit)"],
          "chaos_drill": {"n": CHAOS_N, "seconds": chaos_s,
                          "launch": drill_launch,
                          "report": drill_log[:1]},
          "cli_self_test": {"cmd": " ".join(cli[1:]), "seconds": cli_s,
                            "last_line": out.stdout.strip()
                            .splitlines()[-1]},
          "chunk_launches": chunk_launches,
          "seconds": time.perf_counter() - t_phase})
    return chunk_launches


def phase_elastic(torch, kv, sim, elastic, HardwareConfig, FINISH,
                  device=None):
    """examples/simulate_accelerator.py on the port: each case compiled
    for a small grid and for 15x15, run half way on the small one through
    ``machine``, migrated by RTL name, run to its end on 15x15; it must
    FINISH at exactly ``n_cycles`` with the registers of an uninterrupted
    15x15 run."""
    cases, launches = [], 0
    with tempfile.TemporaryDirectory(prefix="elastic-cache-") as cache_dir:
        for name, side in ELASTIC_CASES:
            sa = sim.compile(name, HardwareConfig(grid_width=side,
                                                  grid_height=side),
                             scale="full", cache=cache_dir, device=device)
            sb = sim.compile(name, HardwareConfig(), scale="full",
                             cache=cache_dir, device=device)
            n = sb.n_cycles
            half = n // 2
            ea, eb = sa.engine(), sb.engine()
            torch.cuda.synchronize()
            kv.reset_counts()
            t0 = time.perf_counter()
            ra = ea.run(half)
            eb.state = elastic.migrate(sa.program, ea.state, sb.program,
                                       eb.m)
            rb = eb.run(n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kv.COUNTS)
            if counts["vcycle_chunk"] <= 0 or counts["vcycle_seed"]:
                raise AssertionError(f"elastic {name}: launched {counts}")
            launches += counts["vcycle_chunk"]
            ref = sb.run()
            if ra.cycles != half or ra.exceptions:
                raise AssertionError(f"elastic {name}: first half ran "
                                     f"{ra.cycles} ({ra.exceptions})")
            if set(rb.exceptions.values()) != {FINISH} \
                    or ra.cycles + rb.cycles != n:
                raise AssertionError(
                    f"elastic {name}: ended at {ra.cycles + rb.cycles} "
                    f"with {rb.exceptions}, not FINISH at {n}")
            if ref.cycles != n or rb.registers != ref.registers \
                    or rb.exceptions != ref.exceptions:
                raise AssertionError(f"elastic {name}: migrated run != "
                                     "an uninterrupted 15x15 run")
            cases.append({"circuit": name, "from": f"{side}x{side}",
                          "to": "15x15", "n_cycles": n, "half": half,
                          "finished_at": ra.cycles + rb.cycles,
                          "registers_checked": len(rb.registers),
                          "vcpl": [sa.program.vcpl, sb.program.vcpl],
                          "prologue_slots": [sa.program.pipe_prologue,
                                             sb.program.pipe_prologue],
                          "cores": [sa.program.used_cores,
                                    sb.program.used_cores],
                          "chunk_launches": counts["vcycle_chunk"],
                          "wall_s": wall})
    emit({"phase": "elastic", "cases": cases,
          "equal_to": "an uninterrupted 15x15 run",
          "chunk_launches": launches})
    return launches


# the multi-device engines (ROADMAP A6, A7) on a one-card machine: D
# shards of cuda:0 test the logic of the sharding and of the exchange, not
# the speed of copies between cards
MULTI_DEV = "cuda:0"
MULTI_D = (1, 4)
SHARDED_B = 510            # padded to 512 over 4 shards: 2 padding elements
MULTI_SEEDS = 64           # bc's sharded batch, and each batched grid's
MULTI_ISA = (0, 300, 509)  # elements on shards 0, 2 and 3, held to IsaSim
STATE_LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")


def one_card(D: int) -> list:
    """D shards of one card, the devices of every multi-device case here
    (``scripts/multi_card.py`` gives each shard its own card)."""
    return [MULTI_DEV] * D


def _shards_on(devices) -> str:
    names = [str(d) for d in devices]
    return (f"{len(names)} x {names[0]}" if len(set(names)) == 1
            else ", ".join(names))


def _label(devices) -> str:
    if len({str(d) for d in devices}) == 1:
        return ("D shards on one card: the logic of sharding and of the "
                "exchange, not copies between cards")
    return "one shard a card: the exchange crosses cards"


def _synced(torch, fn):
    """(fn(), seconds): host clock around work that ends in a sync of
    every card."""
    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _equal_leaves(torch, got, want, tag):
    """Two states leaf by leaf, bit for bit (int32 tensors or uint32/int32
    arrays, on any device)."""
    for name, a, b in zip(STATE_LEAVES, got, want):
        a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        b = b.cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
        if a.shape != b.shape or not np.array_equal(
                a.view(np.uint32), b.view(np.uint32)):
            raise AssertionError(f"{tag}: {name} differs")


def phase_sharded(torch, kv, sim, bsp, IsaEngine, FINISH, s_mc, results,
                  place=one_card):
    """``ShardedBatchedMachine`` on D shards of the card, each element
    bit-equal to ``BatchedMachine`` on the same images: mc/full at B=512
    (D=1) and B=510 (D=4, two padding elements), bc/full (pipelined) at
    B=64 over 4 shards; then the user's call
    ``compile("mc", seeds=range(512)).run(engine="sharded", devices=...)``,
    counted, equal to the main path's results and to IsaSim. ``place(D)``
    gives the devices of D shards."""
    t_phase = time.perf_counter()
    dev0 = place(1)[0]
    s_bc = sim.compile("bc", scale="full", seeds=range(MULTI_SEEDS))
    cases = []
    for s, name, B, D in ((s_mc, "mc", MAIN_SEEDS, 1),
                          (s_mc, "mc", SHARDED_B, 4),
                          (s_bc, "bc", MULTI_SEEDS, 4)):
        tag = f"sharded {name} B={B} D={D}"
        images = tuple(a[:B] for a in s.images_stacked())
        n = s.default_cycles()
        bm = bsp.BatchedMachine(s.program, images=images, device=dev0)
        sm = bsp.ShardedBatchedMachine(s.program, images=images,
                                       devices=place(D))
        sb, t_b = _synced(torch, lambda: bm.run(bm.init_state(), n))
        kv.reset_counts()
        st, t_s = _synced(torch, lambda: sm.run(sm.init_state(), n))
        launches = kv.COUNTS["vcycle_chunk"]
        g = sm.gather(st)
        _equal_leaves(torch, [x[:B] for x in g], sb, tag)
        if g.flags[B:].any() or g.counters[B:].any():
            raise AssertionError(f"{tag}: a padding element ran")
        p = sm.perf(st)
        vc = g.counters[:B, 0]
        if (p["batch"] != B or len(sm.exceptions(st)) != B
                or not bool((vc == s.n_cycles).all())
                or not bool((g.flags[:B] == FINISH).any(1).all())):
            raise AssertionError(f"{tag}: not every element FINISHed at "
                                 f"{s.n_cycles} ({p})")
        _, t_b2 = _synced(torch, lambda: bm.run(bm.init_state(), n))
        _, t_s2 = _synced(torch, lambda: sm.run(sm.init_state(), n))
        cases.append({"circuit": name, "B": B, "D": D, "Bp": sm.Bp,
                      "shards_on": _shards_on(place(D)),
                      "chunk_launches": launches,
                      "vcycles": p["vcycles"], "pipe_prologue":
                      s.program.pipe_prologue,
                      "vcycles_per_s": [p["vcycles"] / t_s,
                                        p["vcycles"] / t_s2],
                      "batched_vcycles_per_s": [p["vcycles"] / t_b,
                                                p["vcycles"] / t_b2],
                      "equal_to": "BatchedMachine"})
    # the user's call, counted
    devices = place(4)
    torch.cuda.synchronize()
    kv.reset_counts()
    out, run_s = _synced(torch, lambda: s_mc.run(engine="sharded",
                                                 devices=devices))
    launches = kv.COUNTS["vcycle_chunk"]
    if launches <= 0 or kv.COUNTS["vcycle_seed"]:
        raise AssertionError(f"sharded path launched {dict(kv.COUNTS)}")
    if out != results:
        raise AssertionError("run(engine='sharded') != the main path's "
                             "results")
    stacked = s_mc.images_stacked()
    for i in MULTI_ISA:
        ref = IsaEngine(s_mc.program, images=tuple(a[i] for a in stacked)) \
            .run(s_mc.default_cycles())
        if (ref.cycles, ref.exceptions, ref.registers) != \
                (out[i].cycles, out[i].exceptions, out[i].registers):
            raise AssertionError(f"sharded element {i} != IsaSim")
    emit({"phase": "sharded", "cases": cases,
          "call": "repro_torch.sim.compile('mc', scale='full', "
                  f"seeds=range({MAIN_SEEDS})).run(engine='sharded', "
                  f"devices=[{_shards_on(devices)}])",
          "label": _label(devices),
          "launches": launches, "run_s": run_s,
          "equal_to": ["main path results", "BatchedMachine", "IsaSim"],
          "isasim_checked": list(MULTI_ISA),
          "seconds": time.perf_counter() - t_phase})
    return launches, s_bc


def _device_busy_ms(torch, fn) -> tuple:
    """(device ms, launches of ``vcycle_chunk_kernel``) in a
    ``torch.profiler`` trace of one call of ``fn``: every kernel and copy
    it ran on the card."""
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us, seen = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == cuda:
            us += float(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0.0)))
            if "vcycle_chunk_kernel" in e.key:
                seen += e.count
    return us / 1e3, seen


def phase_grid(torch, kv, bsp, GridMachine, FINISH, sims, place=one_card):
    """``GridMachine`` on D shards of the card (the cores sharded, SENDs
    crossing shards every Vcycle), unbatched against ``Machine`` and on
    64 seeds against ``BatchedMachine``, bit for bit, on mc/full and
    bc/full (modulo-pipelined; the grid runs it unrotated) at D=1 and
    D=4; each FINISHes at its bench's cycle. Each mc case reports its
    device time in a trace of one run over the host time of an untraced
    one (``device_busy_share``). ``place(D)`` gives the devices of D
    shards."""
    t_phase = time.perf_counter()
    cases, total = [], 0
    dev0 = place(1)[0]
    for name, s in sims:
        prog, n = s.program, s.default_cycles()
        C = prog.used_cores
        images = tuple(a[:MULTI_SEEDS] for a in s.images_stacked())
        m = bsp.Machine(prog, device=dev0)
        s1 = m.run(m.init_state(), n)
        bm = bsp.BatchedMachine(prog, images=images, device=dev0)
        sB = bm.run(bm.init_state(), n)
        for D in MULTI_D:
            for batched in (False, True):
                tag = f"grid {name} D={D} {'B=64' if batched else 'B=1'}"
                gm = GridMachine(prog, place(D),
                                 images=images if batched else None)
                if D > 1 and not gm.cross_words:
                    raise AssertionError(f"{tag}: no SEND crosses shards")
                kv.reset_counts()
                st, t1 = _synced(torch, lambda: gm.run(gm.init_state(), n))
                launches = kv.COUNTS["vcycle_chunk"]
                total += launches
                h = gm.gather(st)
                ref, B = (sB, MULTI_SEEDS) if batched else (s1, 1)
                lead = (slice(None),) if batched else ()
                gs = (*lead, gm.gshard)
                _equal_leaves(torch, [h.regs[(*lead, slice(0, C))],
                                      h.spads[(*lead, slice(0, C))],
                                      h.gmem[gs],
                                      h.flags[(*lead, slice(0, C))],
                                      h.cache_tags[gs], h.counters[gs]],
                              ref, tag)
                vc = h.counters[(*lead, slice(None), 0)]
                exc = gm.exceptions(st)
                exc = exc if batched else [exc]
                if not (vc == s.n_cycles).all() or \
                        any(set(e.values()) != {FINISH} for e in exc):
                    raise AssertionError(f"{tag}: not FINISHed at "
                                         f"{s.n_cycles} on every shard")
                if launches % D or launches // D % gm.chunk:
                    raise AssertionError(f"{tag}: {launches} launches, "
                                         f"not D per Vcycle of a chunk")
                _, t2 = _synced(torch, lambda: gm.run(gm.init_state(), n))
                busy_ms = traced = None
                if name == "mc":        # a trace costs seconds: one circuit
                    busy_ms, traced = _device_busy_ms(
                        torch, lambda: gm.run(gm.init_state(), n))
                vcycles = B * s.n_cycles
                cases.append({
                    "circuit": name, "D": D, "B": B, "C": C, "cl": gm.cl,
                    "outbox_cores": gm.n_box, "n_sends": prog.n_sends,
                    "crossing_sends": gm.cross_words,
                    "exchange_bytes_per_vcycle": 4 * B * gm.cross_words,
                    "pipe_prologue": prog.pipe_prologue,
                    "shards_on": _shards_on(place(D)),
                    "finished_at": s.n_cycles, "chunk_launches": launches,
                    "vcycles_dispatched": launches // D,
                    "vcycles_per_s": [vcycles / t1, vcycles / t2],
                    "device_ms": busy_ms, "traced_launches": traced,
                    "device_busy_share": busy_ms and busy_ms / (1e3 * t2),
                    "equal_to": "BatchedMachine" if batched else "Machine"})
    emit({"phase": "grid", "cases": cases, "label": _label(place(4)),
          "chunk_launches": total,
          "seconds": time.perf_counter() - t_phase})
    return total


# the flash kernel's shapes: (BH, BHkv, S, dh, dtype, causal)
FLASH_CASES = (
    # tests/test_kernels.py:122-127
    (2, 2, 256, 64, "float32", True),
    (2, 2, 256, 64, "float32", False),
    (4, 4, 512, 128, "bfloat16", True),
    (1, 1, 128, 32, "float32", True),
    (3, 3, 384, 64, "bfloat16", True),
    # the qwen3-0.6b prefill: B=4 x H=16 query heads over Hkv=8 (G=2)
    (LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128, "bfloat16", True),
    (16, 8, LM_PROMPT + 1, 128, "float32", True),
    (8, 4, 512, 128, "bfloat16", False),
    (6, 3, 1000, 64, "bfloat16", True),
)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def flash_inputs(torch, BH, BHkv, S, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((n, S, dh), generator=g, device="cuda")
                 .to(getattr(torch, dtype)) for n in (BH, BHkv, BHkv))


def tf32_rounding(torch, kbuild) -> dict:
    """tf32x3.cuh's integer rounding to TF32 against ``cvt.rna.tf32.f32``
    on the card: normal floats over 60 binades and the same with their
    last 13 bits set to a tie; it raises on a mismatch."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1 << 22, generator=g, device="cuda") * torch.exp2(
        torch.randint(-30, 30, (1 << 22,), generator=g, device="cuda")
        .float())
    x = torch.cat([x, ((x.view(torch.int32) & ~0x1fff) | 0x1000)
                   .view(torch.float32)])
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    kbuild.check("tf32x3_rounding_mismatches",
                 kbuild.load().tf32x3_rounding_mismatches(
                     x.data_ptr(), x.numel(), count.data_ptr(),
                     torch.cuda.current_stream().cuda_stream))
    if int(count):
        raise AssertionError(f"tf32 rounding: {int(count)} of {x.numel()} "
                             "differ from cvt.rna.tf32.f32")
    return {"values": x.numel(), "mismatches": int(count)}


def _f64(*ts):
    return tuple(t.double() for t in ts)


def phase_flash(torch, fa, flash_ref, kbuild):
    """Each case through ``flash_attention`` against the plain version on
    the same CUDA tensors, with the kernel that ran (one launch, the one
    ``route`` names); fp32 within 1e-4 (sums in another order), bf16
    within 2e-2 (P and the output rounded to bf16); the error against
    ``flash_ref`` in float64 beside it. The cases on
    ``flash_attention_simt`` also through its lse route: the same output
    with ``return_lse``, one launch, lse within 1e-5 (fp32) or 1e-4 (bf16)
    of ``flash_ref``'s, and its error in float64."""
    rounding = tf32_rounding(torch, kbuild)
    cases = []
    for i, (BH, BHkv, S, dh, dtype, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, i)
        fa.reset_counts()
        out = fa.flash_attention(q, k, v, causal)
        ran = [name for name, n in fa.COUNTS.items() for _ in range(n)]
        ref = flash_ref(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = FLASH_TOL[dtype]
        tag = (f"flash BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} "
               f"causal={causal}")
        if ran != [fa.route(q.dtype, dh)]:
            raise AssertionError(f"{tag}: launched {ran}")
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol):
            raise AssertionError(f"{tag}: {ran[0]} != plain (max abs err "
                                 f"{err})")
        o64, lse64 = flash_ref(*_f64(q, k, v), causal, return_lse=True)
        case = {"BH": BH, "BHkv": BHkv, "S": S, "dh": dh, "dtype": dtype,
                "causal": causal, "kernel": ran[0], "max_abs_err": err,
                "tol": tol, "max_abs_err_float64": float(
                    (out.double() - o64).abs().max())}
        if ran[0] == "flash_attention_simt":
            fa.reset_counts()
            o, lse = fa.flash_attention_simt(q, k, v, causal,
                                             return_lse=True)
            launches = dict(fa.COUNTS)
            lse_ref = flash_ref(q, k, v, causal, return_lse=True)[1]
            torch.cuda.synchronize()
            lse_tol = 1e-5 if dtype == "float32" else 1e-4
            if launches["flash_attention_simt"] != 1 or sum(
                    launches.values()) != 1:
                raise AssertionError(f"{tag} lse: launched {launches}")
            if not torch.equal(o, out):
                raise AssertionError(f"{tag}: the output with lse differs")
            if not torch.allclose(lse, lse_ref, rtol=lse_tol, atol=lse_tol):
                raise AssertionError(f"{tag}: lse != flash_ref's (max abs "
                                     f"err {(lse - lse_ref).abs().max()})")
            case["lse"] = {
                "max_abs_err": float((lse - lse_ref).abs().max()),
                "tol": lse_tol, "max_abs_err_float64": float(
                    (lse.double() - lse64).abs().max())}
        cases.append(case)
        del q, k, v, out, ref, o64, lse64
    torch.cuda.empty_cache()
    emit({"phase": "flash_vs_plain", "tf32_rounding": rounding,
          "cases": cases})
    return max(c["max_abs_err"] for c in cases)


def _grad_errs(torch, got, want, again, tol, tag):
    """Each of (dq, dk, dv) against the plain version within ``tol`` of its
    max, and bit-equal to a second launch: ({name: max abs err},
    {name: err over max})."""
    err, rel = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err[name] = float((a.float() - b.float()).abs().max())
        rel[name] = err[name] / float(b.float().abs().max())
        if a.dtype != b.dtype or not rel[name] <= tol:
            raise AssertionError(f"{tag}: {name} != plain ({err[name]}, "
                                 f"{rel[name]} of its max)")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: a second launch gave other bits")
    return err, rel


def phase_flash_bwd(torch, fa, flash_bwd_ref, flash_ref):
    """``flash_attention_bwd`` at each of ``flash_vs_plain``'s cases, on
    the gradient ``dO`` of that case's forward output (the forward kernel
    ``route`` picks), against ``flash_bwd_ref`` on the same CUDA tensors:
    each of dq, dk, dv within 1e-4 (fp32) or 2e-2 (bf16) of its max; one
    launch each, and the same bits when launched again (no atomics). At
    the bf16 cases with dh 64 or 128 also ``flash_attention_bwd_sm90``
    with the lse that ``flash_attention_sm90`` saves, against
    ``flash_bwd_ref(..., lse=)``: within 2e-2 of each output's max, one
    launch, the same bits again; and that lse within 1e-3 of
    ``flash_ref``'s. At the cases ``route`` sends to
    ``flash_attention_simt`` also ``flash_attention_bwd`` given that
    kernel's lse, against ``flash_bwd_ref(..., lse=)`` within 1e-4 or 2e-2
    of each output's max, one launch, the same bits again, with each
    output's error against ``flash_bwd_ref`` in float64."""
    cases = []
    zero = {name: 0 for name in fa.COUNTS}
    for i, (BH, BHkv, S, dh, dtype, causal) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, 50 + i)
        do = flash_inputs(torch, BH, BHkv, S, dh, dtype, 80 + i)[0]
        o = fa.flash_attention(q, k, v, causal)
        fa.reset_counts()
        got = fa.flash_attention_bwd(q, k, v, o, do, causal)
        launches = dict(fa.COUNTS)
        again = fa.flash_attention_bwd(q, k, v, o, do, causal)
        want = flash_bwd_ref(q, k, v, o, do, causal)
        torch.cuda.synchronize()
        tag = (f"flash bwd BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} "
               f"causal={causal}")
        if launches != {**zero, "flash_attention_bwd": 1}:
            raise AssertionError(f"{tag}: launched {launches}")
        tol = FLASH_TOL[dtype]
        err, rel = _grad_errs(torch, got, want, again, tol, tag)
        case = {"BH": BH, "BHkv": BHkv, "S": S, "dh": dh, "dtype": dtype,
                "causal": causal, "max_abs_err": err, "err_over_max": rel,
                "tol": tol}
        del got, again, want
        if fa.route(q.dtype, dh) == "flash_attention_simt":
            o, lse = fa.flash_attention_simt(q, k, v, causal,
                                             return_lse=True)
            fa.reset_counts()
            got = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
            launches = dict(fa.COUNTS)
            again = fa.flash_attention_bwd(q, k, v, o, do, causal, lse=lse)
            want = flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
            torch.cuda.synchronize()
            if launches != {**zero, "flash_attention_bwd": 1}:
                raise AssertionError(f"{tag} lse: launched {launches}")
            err, rel = _grad_errs(torch, got, want, again, tol, f"{tag} lse")
            q64, k64, v64, do64 = _f64(q, k, v, do)
            want64 = flash_bwd_ref(q64, k64, v64,
                                   flash_ref(q64, k64, v64, causal), do64,
                                   causal)
            case["lse_route"] = {
                "max_abs_err": err, "err_over_max": rel, "tol": tol,
                "max_abs_err_float64": {
                    name: float((a.double() - b).abs().max())
                    for name, a, b in zip(("dq", "dk", "dv"), got, want64)},
                "err_over_max_float64": {
                    name: float((a.double() - b).abs().max()
                                / b.abs().max())
                    for name, a, b in zip(("dq", "dk", "dv"), got, want64)}}
            del got, again, want, want64, q64, k64, v64, do64, lse
        if dtype == "bfloat16" and dh in fa.SM90_HEAD_DIMS:
            o, lse = fa.flash_attention_sm90(q, k, v, causal,
                                             return_lse=True)
            lse_err = float((lse - flash_ref(q, k, v, causal,
                                             return_lse=True)[1])
                            .abs().max())
            if not lse_err <= 1e-3:
                raise AssertionError(f"{tag}: the forward's lse is "
                                     f"{lse_err} off flash_ref's")
            fa.reset_counts()
            got = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
            launches = dict(fa.COUNTS)
            again = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
            want = flash_bwd_ref(q, k, v, o, do, causal, lse=lse)
            torch.cuda.synchronize()
            if launches != {**zero, "flash_attention_bwd_sm90": 1}:
                raise AssertionError(f"{tag} sm90: launched {launches}")
            err, rel = _grad_errs(torch, got, want, again, tol,
                                  f"{tag} sm90")
            case["flash_attention_bwd_sm90"] = {
                "max_abs_err": err, "err_over_max": rel, "tol": tol,
                "lse_max_abs_err": lse_err}
            del got, again, want, lse
        cases.append(case)
        del q, k, v, o, do
    torch.cuda.empty_cache()
    emit({"phase": "flash_bwd_vs_plain", "cases": cases})


def _full_forward_last(torch, model, L, params, tokens):
    """Last-position logits of a full forward over ``tokens``."""
    x, pos = model._embed_inputs(params, {"tokens": tokens})
    h = model._trunk(params, x, pos)
    return L.unembed(params["embed"], model.cfg, h[:, -1:]).float()


def _greedy(torch, model, params, logits, cache, n):
    """The ``n`` greedy tokens after prefill ``logits`` (decoding in place)
    and the first decode step's logits."""
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    toks, first = [tok], None
    for i in range(n - 1):
        logits, cache = model.decode_step(params, tok, cache, LM_PROMPT + i)
        first = logits if first is None else first
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        toks.append(tok)
    return torch.cat(toks, 1), first


def phase_lm_serve(torch, fa, kv, flash_ref, steps, L, ARCHS):
    """qwen3-0.6b at full width through ``make_serve_steps``: one prefill
    and LM_DECODE greedy steps in the config's bf16, counted (one
    ``flash_attention_sm90`` launch a layer); prefill and decode
    tokens/s; then the float32 checks (a) kernel prefill (one
    ``flash_attention_simt`` launch a layer, counted) == the same model on
    ``flash_ref`` (logits within 1e-3, LM_GREEDY_CHECK greedy tokens
    equal) and (b) first decode step == a full forward over the S+1 tokens
    (within 1e-3). Returns the two kernels' launches on their paths."""
    from unittest import mock
    cfg = ARCHS[LM_ARCH]
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).cuda()
    model, prefill_step, decode_step = steps.make_serve_steps(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    cache = model.make_cache(LM_BATCH, LM_CTX)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path, counted: one prefill and LM_DECODE greedy steps
    fa.reset_counts()
    kv.reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": tokens}, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(LM_DECODE):
        tok, cache = decode_step(params, tok, cache, LM_PROMPT + i)
        out.append(tok)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.COUNTS["flash_attention_sm90"]
    if (launches != cfg.n_layers or fa.COUNTS["flash_attention_simt"]
            or any(kv.COUNTS.values())):
        raise AssertionError(f"bf16 serving launched {fa.COUNTS} (not "
                             f"{cfg.n_layers} flash_attention_sm90), "
                             f"Vcycle kernels {kv.COUNTS}")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, 1)
    if (not bool(torch.isfinite(logits).all())
            or logits.shape != (LM_BATCH, 1, cfg.vocab)
            or gen.shape != (LM_BATCH, LM_DECODE + 1)
            or int(gen.min()) < 0 or int(gen.max()) >= cfg.vocab):
        raise AssertionError("serving gave non-finite logits or bad tokens")
    # prefill tokens/s: 3 synced prefills after the one above
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    # decode tokens/s: the LM_DECODE-step loop again, on the fresh cache
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        tok, cache = decode_step(params, tok, cache, LM_PROMPT + i)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del params, cache, logits
    torch.cuda.empty_cache()

    # float32 checks at full width
    cfg32 = cfg.scaled(dtype="float32")
    m32 = steps.make_serve_steps(cfg32)[0]
    p32 = m32.init(torch.Generator(device="cuda").manual_seed(1))
    with torch.inference_mode():
        c_k = m32.make_cache(LM_BATCH, LM_CTX)
        fa.reset_counts()
        lk, c_k = m32.prefill(p32, {"tokens": tokens}, c_k)
        launches32 = fa.COUNTS["flash_attention_simt"]
        if launches32 != cfg.n_layers or fa.COUNTS["flash_attention_sm90"]:
            raise AssertionError(f"float32 prefill launched {fa.COUNTS} "
                                 f"(not {cfg.n_layers} "
                                 "flash_attention_simt)")
        greedy_k, first = _greedy(torch, m32, p32, lk, c_k, LM_GREEDY_CHECK)
        full = _full_forward_last(torch, m32, L, p32, torch.cat(
            [tokens, greedy_k[:, :1]], 1))
        with mock.patch.object(L, "flash_attention", flash_ref):
            c_p = m32.make_cache(LM_BATCH, LM_CTX)
            lp, c_p = m32.prefill(p32, {"tokens": tokens}, c_p)
            greedy_p, _ = _greedy(torch, m32, p32, lp, c_p,
                                  LM_GREEDY_CHECK)
    torch.cuda.synchronize()
    err_a = float((lk - lp).abs().max())
    err_b = float((first - full).abs().max())
    if err_a > 1e-3 or not torch.equal(greedy_k, greedy_p):
        raise AssertionError(f"float32 prefill: kernel != flash_ref model "
                             f"(logits {err_a}, greedy "
                             f"{greedy_k.tolist()} vs {greedy_p.tolist()})")
    if err_b > 1e-3:
        raise AssertionError(f"float32 first decode step != full forward "
                             f"over S+1 tokens ({err_b})")
    del p32, c_k, c_p
    torch.cuda.empty_cache()
    ntok = LM_BATCH * LM_PROMPT
    emit({"phase": "lm_serve", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_serve_steps(ARCHS"
                  f"['{LM_ARCH}'])",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
          "B": LM_BATCH, "S": LM_PROMPT, "ctx": LM_CTX,
          "decode_steps": LM_DECODE,
          "flash_attention_sm90_launches_per_prefill": launches,
          "fp32_flash_attention_simt_launches_per_prefill": launches32,
          "first_run_s": first_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": [ntok / t for t in prefill_s],
          "decode_s": decode_s,
          "decode_tokens_per_s": LM_BATCH * LM_DECODE / decode_s,
          "peak_memory_bytes": peak,
          "fp32_prefill_vs_plain_max_abs_err": err_a,
          "fp32_greedy_tokens_equal": LM_GREEDY_CHECK,
          "fp32_first_decode_vs_full_forward_max_abs_err": err_b})
    return launches, launches32


TRAIN_B, TRAIN_S, TRAIN_TIMED = 4, 2048, 3
CHECK_LAYERS, CHECK_B, CHECK_S = 2, 2, 512   # the float32 checks


def _batch(torch, pipe, i):
    return {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(i).items()}


def _spied_step(torch, steps, adamw, step, params, opt, batch):
    """One ``train_step``, with the gradients it hands ``adamw.apply``."""
    from unittest import mock
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    with mock.patch.object(steps.adamw, "apply", spy):
        out = step(params, opt, batch)
    return out, seen[0]


def _check_grads(torch, adamw, grads, tag):
    """Every leaf has a finite gradient that is not all zero."""
    for i, g in enumerate(adamw.leaves(grads)):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0):
            raise AssertionError(f"{tag}: leaf {i} {tuple(g.shape)} has a "
                                 "zero or non-finite gradient")


def _named(tree, prefix=""):
    """(path, leaf) over nested dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _unmoved(torch, before, after):
    """The paths of the leaves in which no element changed."""
    return [p for (p, a), (_, b) in zip(_named(before), _named(after))
            if torch.equal(a, b)]


def _counted(fa, kv, fn, want, tag):
    """``fn()``, which must launch the flash kernels ``want`` times each
    and no Vcycle kernel."""
    fa.reset_counts()
    kv.reset_counts()
    out = fn()
    if dict(fa.COUNTS) != want or any(kv.COUNTS.values()):
        raise AssertionError(f"{tag}: launched {dict(fa.COUNTS)} (not "
                             f"{want}), Vcycle kernels {kv.COUNTS}")
    return out


def phase_lm_train(torch, fa, kv, flash_ref, steps, L, ARCHS, adamw,
                   TokenPipeline, PipelineConfig, CheckpointManager):
    """qwen3-0.6b at full width trained through ``make_train_step`` in the
    config's bf16 on ``TokenPipeline(PipelineConfig(vocab, TRAIN_S,
    TRAIN_B)).batch_at(i)``: one warm-up step, then TRAIN_TIMED steps
    timed to a synchronize. Every step must launch 2 x 28
    ``flash_attention_sm90`` (the forward and its recompute under
    ``torch.utils.checkpoint``, which saves lse) and 28
    ``flash_attention_bwd_sm90``, no ``flash_attention_bwd`` and no
    Vcycle kernel. Checks: loss and gnorm finite, gnorm > 0, every leaf's
    gradient finite and nonzero at step 1 (a leaf the loss cannot reach
    raises in the step), and each weight matrix moved. Then at full width
    with CHECK_LAYERS layers in float32 (CHECK_B x CHECK_S tokens): one
    step's gradients on the kernels (``flash_attention_simt`` and
    ``flash_attention_bwd``) against the same step on ``flash_ref`` under
    autograd, within 1e-4 of each leaf's max, every leaf moved; and 2
    steps, a ``CheckpointManager`` save and restore into fresh tensors,
    then 1 step, bit-equal to 3 uninterrupted steps. Returns the bf16
    run's launches of each flash kernel, and the counted float32 step's."""
    from unittest import mock
    cfg = ARCHS[LM_ARCH]
    model, step, p_shapes, opt_shapes = steps.make_train_step(cfg)
    n_params = sum(t.numel() for t in adamw.leaves(p_shapes))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw.init(params)
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, TRAIN_S, TRAIN_B))
    want = {"flash_attention_sm90": 2 * cfg.n_layers,
            "flash_attention_simt": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": cfg.n_layers}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # step 1: the warm-up, with its gradients
    batch = _batch(torch, pipe, 0)
    t0 = time.perf_counter()
    (new, opt, metrics), grads = _counted(fa, kv, lambda: _spied_step(
        torch, steps, adamw, step, params, opt, batch), want, "train step 1")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _check_grads(torch, adamw, grads, "bf16 step 1")
    # step 1's lr is 3e-6 (cosine_lr's warm-up): a norm scale of 1.0 cannot
    # move in bf16 (its spacing there is 2^-8), a weight matrix must
    unmoved = _unmoved(torch, params, new)
    if any(not p.endswith("/scale") for p in unmoved):
        raise AssertionError(f"bf16 step 1: leaves did not move: {unmoved}")
    n_leaves = len(list(adamw.leaves(params)))
    del grads, params
    params = new
    losses, gnorms = [float(metrics["loss"])], [float(metrics["gnorm"])]
    step_s = []
    for i in range(1, 1 + TRAIN_TIMED):
        batch = _batch(torch, pipe, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = _counted(
            fa, kv, lambda: step(params, opt, batch), want,
            f"train step {i + 1}")
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + gnorms)) or min(gnorms) <= 0:
        raise AssertionError(f"train: loss {losses}, gnorm {gnorms}")
    launches = {k: v * (1 + TRAIN_TIMED) for k, v in want.items()}
    del params, opt, metrics, batch
    torch.cuda.empty_cache()

    # float32 at full width, CHECK_LAYERS layers
    cfg32 = cfg.scaled(n_layers=CHECK_LAYERS, dtype="float32")
    m32, step32, _, _ = steps.make_train_step(cfg32)
    p0 = m32.init(torch.Generator(device="cuda").manual_seed(1))
    o0 = adamw.init(p0)
    pipe32 = TokenPipeline(PipelineConfig(cfg.vocab, CHECK_S, CHECK_B))
    b0 = _batch(torch, pipe32, 0)
    want32 = {"flash_attention_sm90": 0,
              "flash_attention_simt": 2 * CHECK_LAYERS,
              "flash_attention_bwd": CHECK_LAYERS,
              "flash_attention_bwd_sm90": 0}
    (pk, _, mk), gk = _counted(fa, kv, lambda: _spied_step(
        torch, steps, adamw, step32, p0, o0, b0), want32, "float32 step")
    with mock.patch.object(L, "flash_attention", flash_ref):
        (pp, _, mp), gp = _spied_step(torch, steps, adamw, step32, p0, o0,
                                      b0)
    grad_err = 0.0
    for a, b in zip(adamw.leaves(gk), adamw.leaves(gp)):
        grad_err = max(grad_err, float((a - b).abs().max())
                       / float(b.abs().max()))
    if not grad_err <= 1e-4:
        raise AssertionError(f"float32 step: kernel gradients != flash_ref "
                             f"under autograd ({grad_err} of a leaf's max)")
    _check_grads(torch, adamw, gk, "float32 step")
    if _unmoved(torch, p0, pk):
        raise AssertionError(f"float32 step: leaves did not move: "
                             f"{_unmoved(torch, p0, pk)}")
    loss_err = abs(float(mk["loss"]) - float(mp["loss"]))
    del pk, pp, gk, gp
    # resume: 3 steps against 2, a checkpoint, a restore and 1
    p, o = p0, o0
    for i in range(3):
        p, o, _ = step32(p, o, _batch(torch, pipe32, i))
    straight = {"params": p, "opt": o}
    p, o = p0, o0
    for i in range(2):
        p, o, _ = step32(p, o, _batch(torch, pipe32, i))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(2, {"params": p, "opt": o}, blocking=True)
        fresh = {"params": adamw.tree_map(torch.zeros_like, p),
                 "opt": adamw.init(p)}
        at, restored = mgr.restore_tree(fresh)
    p, o, _ = step32(restored["params"], restored["opt"],
                     _batch(torch, pipe32, 2))
    pairs = [(a, b) for x, y in ((p, straight["params"]),
                                 (o.m, straight["opt"].m),
                                 (o.v, straight["opt"].v))
             for a, b in zip(adamw.leaves(x), adamw.leaves(y))]
    pairs.append((o.step, straight["opt"].step))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    n_pairs = len(pairs)
    if at != 2 or differ:
        raise AssertionError(f"resume: {differ} of {len(pairs)} leaves "
                             "differ from 3 uninterrupted steps (restored "
                             f"step {at})")
    del p, o, p0, o0, straight, restored, pairs
    torch.cuda.empty_cache()
    ntok = TRAIN_B * TRAIN_S
    param_bytes = sum(t.numel() * t.element_size()
                      for t in adamw.leaves(p_shapes))
    # what the step holds at once, from the shapes, against the peak
    reckoning = {"params": param_bytes, "grads": param_bytes,
                 "adam_m_and_v": 8 * n_params,
                 "fp32_logits": 4 * ntok * cfg.vocab,
                 "fp32_logits_grad": 4 * ntok * cfg.vocab}
    emit({"phase": "lm_train", "arch": LM_ARCH,
          "call": f"repro_torch.launch.steps.make_train_step(ARCHS"
                  f"['{LM_ARCH}'])",
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "dtype": cfg.dtype,
          "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": ntok,
          "launches_per_step": want, "first_step_s": first_s,
          "step_s": step_s, "tokens_per_s": [ntok / t for t in step_s],
          "loss": losses, "gnorm": gnorms, "peak_memory_bytes": peak,
          "memory_reckoning_bytes": reckoning,
          "leaves": n_leaves, "leaves_not_moved_at_step_1": unmoved,
          "fp32_check": {"n_layers": CHECK_LAYERS, "B": CHECK_B,
                         "S": CHECK_S, "launches": want32,
                         "grad_err_over_leaf_max": grad_err,
                         "loss_abs_err": loss_err,
                         "resume_bit_equal_leaves": n_pairs}})
    return launches, want32


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def time_flash(torch, fa, flash_ref):
    """Both flash kernels at the qwen3-0.6b prefill's shape (bf16, causal,
    GQA G=2), timed in one call in turns (tensor-core kernel, the same
    saving lse as training runs it, CUDA-core kernel, plain version, SDPA,
    then the same in reverse): CUDA-event ms, the bound they share, and
    one PyTorch call computing the same function (SDPA, the yardstick; the
    port never calls it)."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "bfloat16", 99)
    B = LM_BATCH
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh) for t in (q, k, v))
    library = "scaled_dot_product_attention(is_causal, enable_gqa)"
    out = {}

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    def run(name, fn):
        def launch():
            out[name] = fn(q, k, v)
        return launch

    def sm90_lse(q, k, v):
        return fa.flash_attention_sm90(q, k, v, return_lse=True)[0]

    fns = {"flash_attention_sm90": (run("flash_attention_sm90",
                                        fa.flash_attention_sm90), 20, 3),
           "sm90_lse": (run("sm90_lse", sm90_lse), 20, 3),
           "flash_attention_simt": (run("flash_attention_simt",
                                        fa.flash_attention_simt), 5, 1),
           "plain": (run("plain", flash_ref), 3, 1),
           "library": (sdpa, 20, 3)}
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    # each input read once, the output written once; causal score and
    # P V products: 2 x (BH S^2 dh / 2) multiply-adds
    nbytes = 2 * (2 * BH * S * dh + 2 * BHkv * S * dh)
    flops = 2 * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    common = {"case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} bf16 causal",
              "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
              "library_ms": ms["library"],
              "library_ms_turns": turns["library"], "library": library,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bytes": nbytes, "flops": flops}
    res = {}
    for name in ("flash_attention_sm90", "flash_attention_simt"):
        err = float((out[name].float() - out["plain"].float()).abs().max())
        if err > FLASH_TOL["bfloat16"] * 4:
            raise AssertionError(f"timed {name} != plain ({err})")
        res[name] = {**common, "ms": ms[name], "ms_turns": turns[name],
                     "max_abs_err": err,
                     "tflops_per_s": flops / ms[name] * 1e-9}
    if not torch.equal(out["sm90_lse"], out["flash_attention_sm90"]):
        raise AssertionError("flash_attention_sm90 saving lse gave another "
                             "output")
    res["flash_attention_sm90"].update(ms_with_lse=ms["sm90_lse"],
                                       ms_with_lse_turns=turns["sm90_lse"])
    return res


def time_flash_fp32(torch, fa, flash_ref):
    """``flash_attention_simt`` on its own path's type: float32 at the
    serving shape (causal, GQA G=2), without lse (as the prefill runs it)
    and saving it (as training runs it), timed in one call in turns with
    the plain version and float32 SDPA (kernel, kernel with lse, plain,
    SDPA, then the same in reverse), against two bounds: the causal
    products at the card's float32 rate outside the tensor cores
    (``bound_ms``), and the three TF32 products of each in 3xTF32 at the
    tensor cores' TF32 rate (``bound_3xtf32_ms``)."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = LM_BATCH * 16, LM_BATCH * 8, LM_PROMPT, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, "float32", 98)
    B = LM_BATCH
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh) for t in (q, k, v))
    out = {}

    def run(name, fn):
        def launch():
            out[name] = fn(q, k, v)
        return launch

    def with_lse(q, k, v):
        return fa.flash_attention_simt(q, k, v, return_lse=True)[0]

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)

    fns = {"flash_attention_simt": (run("flash_attention_simt",
                                        fa.flash_attention_simt), 10, 2),
           "simt_lse": (run("simt_lse", with_lse), 10, 2),
           "plain": (run("plain", flash_ref), 3, 1),
           "library": (sdpa, 5, 1)}
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    nbytes = 4 * (2 * BH * S * dh + 2 * BHkv * S * dh)
    flops = 2 * BH * S * S * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    err = float((out["flash_attention_simt"] - out["plain"]).abs().max())
    if err > FLASH_TOL["float32"]:
        raise AssertionError(f"timed float32 flash_attention_simt != plain "
                             f"({err})")
    if not torch.equal(out["simt_lse"], out["flash_attention_simt"]):
        raise AssertionError("flash_attention_simt saving lse gave another "
                             "output")
    return {"case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} float32 causal",
            "ms": ms["flash_attention_simt"],
            "ms_turns": turns["flash_attention_simt"],
            "ms_with_lse": ms["simt_lse"],
            "ms_with_lse_turns": turns["simt_lse"],
            "plain_ms": ms["plain"], "plain_ms_turns": turns["plain"],
            "library_ms": ms["library"],
            "library_ms_turns": turns["library"],
            "library": "scaled_dot_product_attention(is_causal, enable_gqa) "
                       "in float32",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_3xtf32_ms": max(t_bytes,
                                   3 * flops / TF32_FLOPS_PER_S * 1e3),
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "tflops_per_s": flops / ms["flash_attention_simt"] * 1e-9}


def time_flash_bwd(torch, fa, flash_bwd_ref, dtype: str):
    """The backward flash kernels at the qwen3-0.6b training shape (causal,
    GQA G=2) in ``dtype``, timed in one call in turns with the plain
    version and the backward of SDPA on the same inputs (kernels, plain,
    SDPA, then the same in reverse). In bf16: ``flash_attention_bwd_sm90``
    with the lse the forward saves (its plain version
    ``flash_bwd_ref(lse=)``) and ``flash_attention_bwd`` computing lse
    itself (``flash_bwd_ref``). In float32: ``flash_attention_bwd`` given
    the lse ``flash_attention_simt`` saves, as training runs it, and
    computing it itself (``ms_without_lse``), against
    ``flash_bwd_ref(lse=)``. Bound: the gradient's five products, 2.5x the
    forward's causal products, at the card's rate for ``dtype`` (tensor
    cores for bf16, the CUDA cores for float32; for float32 also three
    TF32 products each at the TF32 rate, ``bound_3xtf32_ms``), against
    each input read and each output written once (lse's bytes too, for
    the kernel that reads it). Returns {kernel name: its row}."""
    import torch.nn.functional as F
    BH, BHkv, S, dh = TRAIN_B * 16, TRAIN_B * 8, TRAIN_S, 128
    q, k, v = flash_inputs(torch, BH, BHkv, S, dh, dtype, 97)
    do = flash_inputs(torch, BH, BHkv, S, dh, dtype, 96)[0]
    sm90 = dtype == "bfloat16"
    forward = fa.flash_attention_sm90 if sm90 else fa.flash_attention_simt
    o, lse = forward(q, k, v, return_lse=True)
    B = TRAIN_B
    q4, k4, v4 = (t.view(B, t.shape[0] // B, S, dh).detach()
                  .requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    do4 = do.view(B, BH // B, S, dh)
    out = {}

    def bwd():
        out["bwd"] = fa.flash_attention_bwd(q, k, v, o, do)

    def bwd_lse():
        out["bwd_lse"] = fa.flash_attention_bwd(q, k, v, o, do, lse=lse)

    def bwd_sm90():
        out["bwd_sm90"] = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse)

    def plain():
        out["plain"] = flash_bwd_ref(q, k, v, o, do)

    def plain_lse():
        out["plain_lse"] = flash_bwd_ref(q, k, v, o, do, lse=lse)

    def sdpa_bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)

    # (row, its timed call, the plain call it is held to, the lse bytes it
    # reads, the same kernel without lse)
    if sm90:
        fns = {"bwd_sm90": (bwd_sm90, 20, 3), "bwd": (bwd, 10, 2),
               "plain": (plain, 3, 1), "library": (sdpa_bwd, 10, 2),
               "plain_lse": (plain_lse, 3, 1)}
        rows = (("flash_attention_bwd_sm90", "bwd_sm90", "plain_lse",
                 4 * BH * S, None),
                ("flash_attention_bwd", "bwd", "plain", 0, None))
    else:
        fns = {"bwd_lse": (bwd_lse, 10, 2), "bwd": (bwd, 10, 2),
               "plain_lse": (plain_lse, 3, 1), "library": (sdpa_bwd, 10, 2)}
        rows = (("flash_attention_bwd", "bwd_lse", "plain_lse", 4 * BH * S,
                 "bwd"),)
    turns = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            fn, n, warm = fns[name]
            turns[name].append(cuda_ms(torch, fn, n, warm))
    ms = {name: sum(t) / len(t) for name, t in turns.items()}
    elt = 2 if dtype == "bfloat16" else 4
    # reads of q, o, dO and k, v; writes of dq and dk, dv
    nbytes = elt * (4 * BH + 4 * BHkv) * S * dh
    flops = 5 * BH * S * S * dh      # 2.5 x the forward's 2 BH S^2 dh
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    res = {}
    for name, key, plain_key, extra, alone in rows:
        checked = [key] if alone is None else [key, alone]
        errs = [(float((a.float() - b.float()).abs().max()),
                 float(b.float().abs().max()))
                for c in checked for a, b in zip(out[c], out[plain_key])]
        err = max(e for e, _ in errs)
        rel = max(e / m for e, m in errs)
        if rel > FLASH_TOL[dtype]:
            raise AssertionError(f"timed {name} ({dtype}) != plain ({rel} "
                                 "of an output's max)")
        t_bytes = (nbytes + extra) / HBM_BYTES_PER_S * 1e3
        res[name] = {
            "case": f"BH={BH} BHkv={BHkv} S={S} dh={dh} {dtype} causal",
            "ms": ms[key], "ms_turns": turns[key],
            "plain_ms": ms[plain_key], "plain_ms_turns": turns[plain_key],
            "library_ms": ms["library"],
            "library_ms_turns": turns["library"],
            "library": "backward of scaled_dot_product_attention(is_causal, "
                       f"enable_gqa) in {dtype}",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes + extra, "flops": flops, "max_abs_err": err,
            "err_over_max": rel,
            "tflops_per_s": flops / ms[key] * 1e-9}
        if alone is not None:
            res[name].update(ms_without_lse=ms[alone],
                             ms_without_lse_turns=turns[alone])
        if dtype == "float32":
            res[name]["bound_3xtf32_ms"] = max(
                t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3)
    return res


def cuda_ms(torch, fn, n: int, warm: int = 3) -> float:
    """Milliseconds per call of ``fn`` by CUDA events over ``n`` calls
    after ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def device_ms(torch, kv, fn, n: int, name: str, tries: int = 3) -> float:
    """Milliseconds of device time per launch of the CUDA kernel ``name``
    (a key of ``kv.COUNTS``; its entry function is ``<name>_kernel``) over
    ``n`` calls of ``fn`` under ``torch.profiler``, after one warm-up
    call. Unlike CUDA events around the calls, this leaves out the host's
    time between launches, which exceeds a short kernel's. The calls must
    launch the kernel ``n`` times by the wrapper's count. On the card the
    profiler now and then drops launches from its trace (one of 50, or
    all of 20): the time is the mean over the launches the trace holds,
    and a trace that holds fewer than half is taken again, up to
    ``tries`` times; then it raises."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    kernel = f"{name}_kernel"
    for _ in range(tries):
        before = kv.COUNTS[name]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        if kv.COUNTS[name] - before != n:
            raise AssertionError(f"{n} calls launched {name} "
                                 f"{kv.COUNTS[name] - before} times")
        us, calls, seen = 0.0, 0, []
        for e in prof.key_averages():
            if e.device_type == cuda:
                seen.append(e.key[:60])
            if e.device_type == cuda and kernel in e.key:
                us += float(getattr(e, "self_device_time_total",
                                    getattr(e, "self_cuda_time_total", 0.0)))
                calls += e.count
        if 2 * calls >= n and us > 0:
            return us / 1e3 / calls
    raise AssertionError(f"profiler saw {calls} of {n} launches of {kernel} "
                         f"with {us} us; device events: {seen[:8]}")


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work: bytes over the memory rate against
    instructions over the INT32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def table_words(rows, row_words: int, ctab: bool) -> int:
    """Words of the code tables a Vcycle kernel must read (``RowTables``):
    the ``row_words`` of each row that it reads (of a row's eight: the
    first four, and the capture index where it captures SEND values), the
    per-core table where it is handed one (``ctab``), and the distinct LUT
    truth tables. The chunk kernel's rows are each core's live rows only,
    so NOP slots it never reads are not charged."""
    return (row_words * rows.n_rows + (rows.ctab.numel() if ctab else 0)
            + 16 * rows.n_tts)


def row_fields(ms: float, vcycles: int, rows, code_bytes: int) -> dict:
    """What bounds a Vcycle kernel: the busiest core's rows a Vcycle, the
    kernel's ns per such row (ms over Vcycles x busy rows), and the bytes
    of code rows it reads from device memory a launch."""
    return {"busy_rows": rows.busy, "live_rows": rows.n_rows,
            "ns_per_busy_row": ms * 1e6 / max(vcycles * rows.busy, 1),
            "code_bytes": code_bytes}


def time_chunk(torch, kv, k, st, cyc, tag):
    """One chunk of binding ``k`` on state ``st`` ([B, ...] leaves): the
    kernel's device time (``device_ms``, 20 launches) and the time of a
    wrapper call (CUDA events, 20 calls after 3 warm-ups), the plain
    version once on the same inputs, the bound, what bounds the kernel
    (``row_fields``) and its occupancy (blocks an SM holds, waves)."""
    glob = {}
    if k.gcore >= 0:
        glob = dict(gmem=st.gmem, tags=st.cache_tags, counters=st.counters,
                    cache=k.cache)
    args = (*k.tables(), st.regs, st.spads, st.flags, cyc)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro, **glob)
    budget = 10**6
    out = [None]

    def launch():
        out[-1] = kv.vcycle_chunk(*args, budget, layout=k.layout,
                                  gcore=k.gcore, rows=k.rows, **kw)

    event_ms = cuda_ms(torch, launch, 20)
    ms = device_ms(torch, kv, launch, 20, "vcycle_chunk")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = kv.vcycle_chunk_ref(*args, budget, **kw)
    t1.record()
    torch.cuda.synchronize()
    err = max(_same(a, b) for a, b in zip(out[-1], ref))
    if err:
        raise AssertionError(f"timed chunk {tag}: kernel != plain ({err})")
    nexec = out[-1][3].long()
    T = k.code.shape[0]
    B, C, R = st.regs.shape
    S = st.spads.shape[2]
    M = k.dcore.shape[0]
    state = B * C * R + B * C * S + B * C
    extra = {}
    if glob:
        state += st.gmem.numel() + st.cache_tags.numel() + B * 4
        # the wrapper copies the global state for the kernel to update in
        # place; that copy is part of ``ms``
        extra["copy_ms"] = cuda_ms(torch, lambda: tuple(
            t.clone() for t in (st.gmem, st.cache_tags, st.counters)), 20)
    # the code tables it reads (a row's first 16 bytes and its capture
    # index, the per-core table), the exchange, the register offsets, the
    # state in and out, cyc and nexec; one instruction per live row run
    nbytes = 4 * (table_words(k.rows, 5, True) + 2 * M + C + 1 + 2 * state
                  + 2 * B)
    n_run = int(nexec.sum())
    smem, per_sm, staged = kv.chunk_occupancy(C, k.rows, k.layout.words, S,
                                              k.n_sends, bool(glob))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # staged: each block copies every row's first 16 bytes and capture
    # index once; else each row run is a 32-byte read
    code_bytes = (20 * B * k.rows.n_rows if staged
                  else 32 * n_run * k.rows.n_rows)
    return {"case": tag, "ms": ms, "event_ms": event_ms,
            "plain_ms": t0.elapsed_time(t1), **extra,
            **bound(nbytes, n_run * k.rows.n_rows), "max_abs_err": err,
            **row_fields(ms, int(nexec.max()), k.rows, code_bytes),
            "rows_staged": staged, "smem_bytes_per_block": smem,
            "blocks_per_sm": per_sm,
            "waves": -(-B // (sms * per_sm)) if per_sm else None,
            "shape": {"B": B, "C": C, "T": T, "R": R, "S": S, "K": k.K,
                      "G": int(st.gmem.shape[-1]) if glob else 0},
            "vcycles_per_chunk": nexec.tolist()[:1]}


def phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8):
    """Each kernel at the shapes its paths give it: the chunk kernel at the
    main path's (mc/full, B=512), at B=1 (mc/full) and at Fig 8's
    ram/512 KiB with B=64; the seed kernel at mc/full."""
    m = eng.m
    chunk = {"main": time_chunk(
        torch, kv, m._kernel, m.init_state(),
        torch.zeros((m.B,), dtype=torch.int32, device=m.device),
        f"mc/full B={m.B}")}
    m1 = bsp.Machine(s_mc.program)
    st1 = bsp.MachineState(*(x[None] for x in m1.init_state()))
    chunk["b1"] = time_chunk(torch, kv, m1._kernel, st1,
                             torch.zeros((1,), dtype=torch.int32,
                                         device=m1.device), "mc/full B=1")
    mb = bat_fig8.m
    chunk["fig8"] = time_chunk(torch, kv, mb._kernel, mb.init_state(),
                               torch.zeros((mb.B,), dtype=torch.int32,
                                           device=mb.device),
                               f"fig8 ram/512KiB B={mb.B}")
    # the seed kernel: one Vcycle of mc/full from its initial state
    ms_ = bsp.Machine(s_mc.program, specialize=False)
    b = ms_._seed
    regs, spads, gmem, flags, tags, counters = ms_.init_state()
    args = (b.code, b.luts, regs, spads, flags)
    out = [None]

    def launch():
        out[-1] = kv.vcycle_seed(*args, gcore=b.gcore, tables=b.tables)

    event_ms = cuda_ms(torch, launch, 50)
    ms = device_ms(torch, kv, launch, 50, "vcycle_seed")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = kv.vcycle_seed_ref(*args)
    t1.record()
    torch.cuda.synchronize()
    err = max(_same(a, c) for a, c in zip(out[-1], ref))
    if err:
        raise AssertionError(f"timed seed Vcycle: kernel != plain ({err})")
    T = b.code.shape[0]
    C, R = regs.shape
    S = spads.shape[1]
    # the code tables it reads (a row's first 16 bytes: seed rows capture
    # nothing, and it is handed no per-core table), the register offsets,
    # the state in and out, the trace
    rows = b.tables.rows
    nbytes = 4 * (table_words(rows, 4, False) + C + 1
                  + 2 * (C * R + C * S + C) + T * C)
    seed = {"case": "mc/full", "ms": ms, "event_ms": event_ms,
            "plain_ms": t0.elapsed_time(t1),
            **bound(nbytes, T * C), "max_abs_err": err,
            # each warp copies its core's T rows' first 16 bytes once
            # (mc's T=137 rows fit: the kernel stages them)
            **row_fields(ms, 1, rows, 16 * C * T),
            "shape": {"C": C, "T": T, "R": R, "S": S}}
    return chunk, seed


def kernel_line(name, source, replaces, launches, t, by_path=None):
    """One kernel's entry of the ``kernels`` line; ``launches`` counts the
    main path, ``by_path`` (where given) every path that launches it."""
    line = {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}
    for key in ("bound_3xtf32_ms", "ms_with_lse", "ms_without_lse"):
        if key in t:
            line[key] = t[key]
    if by_path is not None:
        line["launches_by_path"] = by_path
    return line


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        import repro_torch.serve as serve
        import repro_torch.sim as sim
        from repro_torch.circuits import FINISH
        from repro_torch.circuits.fig8 import build_membench
        from repro_torch.configs import ARCHS
        from repro_torch.kernels import build as kbuild
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
        from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
        from repro_torch.launch import steps
        from repro_torch.optim import adamw
        from repro_torch.runtime.checkpoint import CheckpointManager
        from repro_torch.models import layers as L
        from repro_torch.runtime import elastic
        from repro_torch.core import bsp
        from repro_torch.core.grid import GridMachine
        from repro_torch.core.isa import HardwareConfig
        from repro_torch.core.isasim import IsaSim
        from repro_torch.kernels import vcycle as kv
        from repro_torch.kernels.randprog import random_chunk, random_vcycle
        from repro_torch.kernels.ref import CacheModel
        from repro_torch.sim.engine import IsaEngine
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    workers = max(1, min(len(NAMES), (os.cpu_count() or 2) - 1))
    with cf.ThreadPoolExecutor(1) as nvcc, cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn")) as pool:
        build_future = nvcc.submit(timed_build, kbuild)
        compiles = [pool.submit(compile_full, n, CHECK_SEEDS) for n in NAMES]
        smi = phase_device(torch)
        phase_build(kbuild, build_future)
        phase_flash(torch, fa, flash_ref, kbuild)
        phase_flash_bwd(torch, fa, flash_bwd_ref, flash_ref)
        phase_random(torch, kv, random_chunk, CacheModel)
        phase_seed_random(torch, kv, random_vcycle, CacheModel)
        for fut in cf.as_completed(compiles):
            item = fut.result()
            phase_circuit(torch, kv, bsp, IsaSim, item)
            check_seed_circuit(torch, kv, bsp, item)
    # this slice's path: the seed arm on all nine full circuits
    seed_launches = b1_launches = 0
    for name in NAMES:
        s, n_seed, n_b1 = phase_seed_arm(torch, kv, sim, name)
        seed_launches += n_seed
        b1_launches += n_b1
        if name == "mc":
            s_mc = s
    fig8_hw = HardwareConfig(grid_width=1, grid_height=1,
                             spad_words=1 << 14, num_regs=4096,
                             imem_slots=1 << 16)
    bat_fig8 = phase_fig8(torch, kv, sim, bsp, IsaEngine, build_membench,
                          fig8_hw, CacheModel)
    eng, launches, s_main, results = phase_main(torch, kv, sim, IsaEngine)
    serve_launches = phase_serve(torch, kv, sim, serve, IsaEngine)
    elastic_launches = phase_elastic(torch, kv, sim, elastic,
                                     HardwareConfig, FINISH)
    sharded_launches, s_bc = phase_sharded(torch, kv, sim, bsp, IsaEngine,
                                           FINISH, s_main, results)
    grid_launches = phase_grid(torch, kv, bsp, GridMachine, FINISH,
                               (("mc", s_main), ("bc", s_bc)))
    sm90_launches, simt_launches = phase_lm_serve(torch, fa, kv, flash_ref,
                                                  steps, L, ARCHS)
    train_launches, fp32_train_launches = phase_lm_train(
        torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
        PipelineConfig, CheckpointManager)
    chunk, seed = phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8)
    flash = time_flash(torch, fa, flash_ref)
    flash32 = time_flash_fp32(torch, fa, flash_ref)
    bwd = {dt: time_flash_bwd(torch, fa, flash_bwd_ref, dt)
           for dt in ("bfloat16", "float32")}
    emit({"phase": "timing", "vcycle_chunk": chunk, "vcycle_seed": seed,
          **flash, "flash_attention_simt_fp32": flash32,
          "flash_attention_bwd_sm90": bwd["bfloat16"][
              "flash_attention_bwd_sm90"],
          "flash_attention_bwd": bwd["bfloat16"]["flash_attention_bwd"],
          "flash_attention_bwd_fp32": bwd["float32"]["flash_attention_bwd"],
          "launches_on_fp32_train_check": fp32_train_launches,
          "launches_on_bf16_train_path": train_launches,
          "seed_launches_on_seed_path": seed_launches,
          "b1_chunk_launches_on_machine_path": b1_launches,
          "sm90_launches_on_bf16_serving_path": sm90_launches,
          "simt_launches_on_fp32_serving_path": simt_launches,
          "chunk_launches_on_serve_path": serve_launches,
          "chunk_launches_on_elastic_path": elastic_launches,
          "chunk_launches_on_sharded_path": sharded_launches,
          "chunk_launches_on_grid_path": grid_launches})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    kernels = [
        kernel_line("vcycle_chunk",
                    "src/repro_torch/kernels/csrc/vcycle_chunk.cu",
                    "src/repro/kernels/vcycle.py:199 _chunk_kernel; "
                    "src/repro/kernels/vcycle.py:262 _chunk_kernel_batched",
                    launches, chunk["main"],
                    {"main": launches, "machine": b1_launches,
                     "serve": serve_launches, "elastic": elastic_launches,
                     "sharded": sharded_launches, "grid": grid_launches}),
        kernel_line("vcycle_seed",
                    "src/repro_torch/kernels/csrc/vcycle_seed.cu",
                    "src/repro/kernels/vcycle.py:45 _vcycle_kernel",
                    seed_launches, seed),
        kernel_line("flash_attention_sm90",
                    "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                    "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                    "(bf16, dh 64 or 128)",
                    sm90_launches, flash["flash_attention_sm90"],
                    {"lm_serve": sm90_launches,
                     "lm_train": train_launches["flash_attention_sm90"]}),
        kernel_line("flash_attention_simt",
                    "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                    "(float32, other head dims)",
                    simt_launches, flash32,
                    {"lm_serve_fp32_check": simt_launches,
                     "lm_train_fp32_check":
                     fp32_train_launches["flash_attention_simt"]}),
        kernel_line("flash_attention_bwd_sm90",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
                    "none: no TPU kernel is replaced; the gradient of "
                    "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                    "(bf16, dh 64 or 128), which the reference takes by "
                    "XLA's autodiff of src/repro/models/layers.py:116 _sdpa",
                    train_launches["flash_attention_bwd_sm90"],
                    bwd["bfloat16"]["flash_attention_bwd_sm90"],
                    {"lm_train": train_launches["flash_attention_bwd_sm90"]}),
        kernel_line("flash_attention_bwd",
                    "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    "none: no TPU kernel is replaced; the gradient of "
                    "src/repro/kernels/flash_attention.py:33 _flash_kernel "
                    "(float32, other head dims), which the reference takes "
                    "by XLA's autodiff of src/repro/models/layers.py:116 "
                    "_sdpa",
                    fp32_train_launches["flash_attention_bwd"],
                    bwd["float32"]["flash_attention_bwd"],
                    {"lm_train_fp32_check":
                     fp32_train_launches["flash_attention_bwd"],
                     "lm_train_bf16": train_launches["flash_attention_bwd"]})]
    print(json.dumps({"kernels": kernels}))
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
