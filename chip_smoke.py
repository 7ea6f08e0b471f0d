#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds both Vcycle kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc -c`` each, in parallel, linked into one library) and holds each bit
for bit against its plain PyTorch version on the card:

* the chunk kernel on all nine full circuits on the paper's 15x15 grid at
  B=8 seeds, both the single and the batched binding, run to the end, and
  on random programs with mid-chunk exceptions, budgets, prologues and
  global memory;
* the seed kernel on random programs (32-bit words, global memory) and on
  the first two Vcycles of each of the nine full circuits.

Then it drives the paths, each through the calls a user makes, with the
launch counts set to 0 just before and read just after:

* the seed arm, ``repro_torch.sim.compile(name, scale="full")
  .run(engine="seed")`` on all nine circuits, equal to ``engine="machine"``
  and to the numpy ISA simulator;
* Fig 8 (global memory: FIFO vs RAM at 1/64/512 KiB) through ``machine``,
  ``seed`` and ``batched`` (B=64 seeds), equal to the ISA simulator;
* the main path ``repro_torch.sim.compile("mc", scale="full",
  seeds=range(512)).run()``;

and times each kernel against its bound. Each phase prints one JSON line;
the last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
such line, when any phase fails, when no CUDA device is present, or when
run outside a checkout.
"""
import concurrent.futures as cf
import dataclasses
import json
import multiprocessing as mp
import os
import re
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
FIG8_N = 2048              # benchmarks/fig8_global_stall.py
FIG8_SEEDS = 64
FIG8_KIB = (1, 64, 512)
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


def timed_build(kv):
    t0 = time.perf_counter()
    path, log = kv.build()
    return path, log, time.perf_counter() - t0


def phase_build(build_future):
    """The library both kernels are built into, with each kernel's
    registers a thread from the compiler's -Xptxas -v report."""
    t0 = time.perf_counter()
    path, log, build_s = build_future.result()
    regs, kernel = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\w+)'", ln)
        if m:
            kernel = next((k for k in ("vcycle_chunk", "vcycle_seed")
                           if k + "_kernel" in m.group(1)), m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel:
            regs[kernel] = int(m.group(1))
    info = [ln.strip() for ln in log.splitlines()
            if "entry function" in ln or "Used" in ln or "spill" in ln]
    emit({"phase": "build", "library": str(path.relative_to(ROOT)),
          "registers_per_thread": regs, "ptxas": info, "build_s": build_s,
          "waited_s": time.perf_counter() - t0})


def _same(a, b) -> int:
    """Max |a - b| over int32 tensors (0 iff bit-identical)."""
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


OUTPUTS = ("regs", "spads", "flags", "nexec", "gmem", "tags", "counters")
SEED_OUTPUTS = ("regs", "spads", "flags", "trace", "gmem", "tags",
                "counters")


def check_chunk(kv, args, budget, kw, tag, layout=None):
    """One chunk through the kernel and the plain version on the same
    inputs; returns the kernel's outputs after asserting bit equality."""
    out_k = kv.vcycle_chunk(*args, budget, layout=layout, **kw)
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
                   f"{name} Vcycle {v}", cache=b.cache)
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
                          f"{tag} chunk {c}", k.layout)
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
    return eng, launches


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


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work: bytes over the memory rate against
    instructions over the INT32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "int_ops": ops}


def table_words(torch, code, luts, C: int, lut_op: int) -> int:
    """Words of the program tables a kernel reads for its C live cores
    (padded lanes return or run NOPs): every code row of those cores, and
    each LUT row their LUT instructions index (the index is the immediate,
    clamped to the last row as the kernels clamp it)."""
    T, L = code.shape[0], luts.shape[1]
    ins = code[:, :C]
    lut = ins[..., 0] == lut_op
    core = torch.arange(C, device=code.device).expand(T, C)[lut]
    row = (ins[..., 6][lut].long() & 0xFFFFFFFF).clamp(max=L - 1)
    return T * C * 7 + 16 * int(torch.unique(core * L + row).numel())


def time_chunk(torch, kv, k, st, cyc, tag, lut_op):
    """One chunk of binding ``k`` on state ``st`` ([B, ...] leaves): the
    kernel (CUDA events, 20 launches after 3 warm-ups), the plain version
    once on the same inputs, and the bound."""
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
                                  gcore=k.gcore, **kw)

    ms = cuda_ms(torch, launch, 20)
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
    # code and capture rows and indexed LUT rows of the live cores, the
    # exchange, the register offsets, the state in and out, cyc and nexec
    nbytes = 4 * (table_words(torch, k.code, k.luts, C, lut_op) + T * C
                  + 2 * M + C + 1 + 2 * state + 2 * B)
    return {"case": tag, "ms": ms, "plain_ms": t0.elapsed_time(t1), **extra,
            **bound(nbytes, int(nexec.sum()) * T * C), "max_abs_err": err,
            "shape": {"B": B, "C": C, "T": T, "R": R, "S": S, "K": k.K,
                      "G": int(st.gmem.shape[-1]) if glob else 0},
            "vcycles_per_chunk": nexec.tolist()[:1]}


def phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8, lut_op):
    """Each kernel at the shapes its paths give it: the chunk kernel at the
    main path's (mc/full, B=512), at B=1 (mc/full) and at Fig 8's
    ram/512 KiB with B=64; the seed kernel at mc/full."""
    m = eng.m
    chunk = {"main": time_chunk(
        torch, kv, m._kernel, m.init_state(),
        torch.zeros((m.B,), dtype=torch.int32, device=m.device),
        f"mc/full B={m.B}", lut_op)}
    m1 = bsp.Machine(s_mc.program)
    st1 = bsp.MachineState(*(x[None] for x in m1.init_state()))
    chunk["b1"] = time_chunk(torch, kv, m1._kernel, st1,
                             torch.zeros((1,), dtype=torch.int32,
                                         device=m1.device), "mc/full B=1",
                             lut_op)
    mb = bat_fig8.m
    chunk["fig8"] = time_chunk(torch, kv, mb._kernel, mb.init_state(),
                               torch.zeros((mb.B,), dtype=torch.int32,
                                           device=mb.device),
                               f"fig8 ram/512KiB B={mb.B}", lut_op)
    # the seed kernel: one Vcycle of mc/full from its initial state
    ms_ = bsp.Machine(s_mc.program, specialize=False)
    b = ms_._seed
    regs, spads, gmem, flags, tags, counters = ms_.init_state()
    args = (b.code, b.luts, regs, spads, flags)
    out = [None]

    def launch():
        out[-1] = kv.vcycle_seed(*args, gcore=b.gcore)

    ms = cuda_ms(torch, launch, 50)
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
    # code rows and indexed LUT rows of the live cores, the state in and
    # out, the trace
    nbytes = 4 * (table_words(torch, b.code, b.luts, C, lut_op)
                  + 2 * (C * R + C * S + C) + T * C)
    seed = {"case": "mc/full", "ms": ms, "plain_ms": t0.elapsed_time(t1),
            **bound(nbytes, T * C), "max_abs_err": err,
            "shape": {"C": C, "T": T, "R": R, "S": S}}
    return chunk, seed


def kernel_line(name, source, replaces, launches, t):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch.sim as sim
        from repro_torch.circuits.fig8 import build_membench
        from repro_torch.core import bsp
        from repro_torch.core.isa import HardwareConfig, Op
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
        build_future = nvcc.submit(timed_build, kv)
        compiles = [pool.submit(compile_full, n, CHECK_SEEDS) for n in NAMES]
        smi = phase_device(torch)
        phase_build(build_future)
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
    eng, launches = phase_main(torch, kv, sim, IsaEngine)
    chunk, seed = phase_timing(torch, kv, bsp, eng, s_mc, bat_fig8,
                               int(Op.LUT))
    emit({"phase": "timing", "vcycle_chunk": chunk, "vcycle_seed": seed,
          "seed_launches_on_seed_path": seed_launches,
          "b1_chunk_launches_on_machine_path": b1_launches})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    kernels = [
        kernel_line("vcycle_chunk",
                    "src/repro_torch/kernels/csrc/vcycle_chunk.cu",
                    "src/repro/kernels/vcycle.py:199 _chunk_kernel; "
                    "src/repro/kernels/vcycle.py:262 _chunk_kernel_batched",
                    launches, chunk["main"]),
        kernel_line("vcycle_seed",
                    "src/repro_torch/kernels/csrc/vcycle_seed.cu",
                    "src/repro/kernels/vcycle.py:45 _vcycle_kernel",
                    seed_launches, seed)]
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
