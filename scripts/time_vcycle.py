#!/usr/bin/env python3
"""Time the Vcycle kernels of one checkout's ``repro_torch`` on one GPU.

    python3 scripts/time_vcycle.py [--src DIR] [--luts] [--tag NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that one script times two checkouts on one card: run it once per checkout,
in turns (A, B, B, A), within one machine. Cases, at the shapes of
``chip_smoke.py`` phase ``timing``: the seed kernel on one Vcycle of
mc/full from its initial state, and the chunk kernel on one chunk of
mc/full at B=1 and at B=512 seeds. Each case is timed two ways:

* ``device_ms``: device time per launch of the kernel under
  ``torch.profiler``;
* ``event_ms``: CUDA events around a loop of wrapper calls, the earlier
  measure of ``chip_smoke.py``, which also counts the host's work between
  launches once a kernel is shorter than that work;
* ``host_ms``: the host clock per wrapper call, over calls that only
  enqueue work.

With ``--luts`` (a checkout whose wrappers stage LUT tables, ``kernels/
vcycle.py`` ``STAGE_LUT_BYTES``) it also times both kernels with the
distinct LUT tables staged in shared memory and read from global memory,
in turns (staged, global, global, staged), on mc, bc and noc (the chunk
kernel at B=1 and B=512 seeds, the seed kernel on one Vcycle), and on a
random program past the staging limit, staged there by raising the
limit. Prints one JSON line per case, then the card's name and power
limit.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEEDS = 512                # the main path's stimuli


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def host_ms(torch, fn, n: int) -> float:
    """Host milliseconds per call of ``fn``: the host clock over ``n``
    calls that only enqueue work (no synchronize among them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def device_ms(torch, kv, fn, n: int, name: str, tries: int = 3) -> float:
    """Device milliseconds per launch of the CUDA kernel ``name`` (a key
    of ``kv.COUNTS``; its entry function is ``<name>_kernel``) over ``n``
    calls of ``fn`` under ``torch.profiler``. The calls must launch it
    ``n`` times by the wrapper's count; the time is the mean over the
    launches the trace holds (the card's profiler now and then drops
    some), and a trace that holds fewer than half is taken again, up to
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


def seed_call(kv, bsp, program):
    """A wrapper call of the seed kernel on one Vcycle of ``program`` from
    its initial state, with the tables its binding laid out, if any; and
    the count of distinct LUT tables in them (None without)."""
    m = bsp.Machine(program, specialize=False)
    b = m._seed
    regs, spads, _, flags, _, _ = m.init_state()
    kw = {"gcore": b.gcore}
    n_tts = None
    if hasattr(b, "tables"):
        kw["tables"] = b.tables
        n_tts = b.tables.rows.n_tts
    return (lambda: kv.vcycle_seed(b.code, b.luts, regs, spads, flags,
                                   **kw)), n_tts


def chunk_call(torch, kv, k, st):
    """A wrapper call of the chunk kernel on one chunk of binding ``k`` from
    state ``st`` ([B, ...] leaves), with its row tables, if any; and the
    count of distinct LUT tables in them (None without)."""
    B = st.regs.shape[0]
    cyc = torch.zeros((B,), dtype=torch.int32, device=st.regs.device)
    kw = dict(K=k.K, n_sends=k.n_sends, num_pro=k.num_pro, layout=k.layout,
              gcore=k.gcore)
    n_tts = None
    if hasattr(k, "rows"):
        kw["rows"] = k.rows
        n_tts = k.rows.n_tts
    return (lambda: kv.vcycle_chunk(*k.tables(), st.regs, st.spads,
                                    st.flags, cyc, 10**6, **kw)), n_tts


def cases(torch, kv, bsp, sim, names, seeds):
    """(case, kernel (its ``COUNTS`` key), wrapper call, distinct LUT
    tables) of each circuit in ``names``: the seed kernel, the chunk
    kernel at B=1 and at B=``seeds``."""
    out = []
    for name in names:
        s = sim.compile(name, scale="full")
        out.append((f"{name}/full seed", "vcycle_seed",
                    *seed_call(kv, bsp, s.program)))
        m1 = bsp.Machine(s.program)
        st1 = bsp.MachineState(*(x[None] for x in m1.init_state()))
        out.append((f"{name}/full B=1", "vcycle_chunk",
                    *chunk_call(torch, kv, m1._kernel, st1)))
        sb = sim.compile(name, scale="full", seeds=range(seeds))
        eng = sb.engine()
        out.append((f"{name}/full B={seeds}", "vcycle_chunk",
                    *chunk_call(torch, kv, eng.m._kernel,
                                eng.m.init_state())))
    return out


def past_the_limit(torch, kv, randprog):
    """(case, kernel (its ``COUNTS`` key), wrapper call, distinct LUT
    tables) past the staging limit: a random program of 300 cores whose
    LUT rows name one table each (about 300 distinct, 19 KB), the chunk
    kernel at B=64 and the seed kernel (``tests/test_torch_gpu.py``'s
    program)."""
    import numpy as np
    rng = np.random.default_rng(9)
    C, Cp, T = 300, 320, 64
    dev = torch.device("cuda")
    a = [torch.from_numpy(x).to(dev) for x in randprog.random_chunk(
        rng, [10**6] * 64, C, T, 24, 4, 32, 12, 0, Cp=Cp)]
    flags = torch.zeros((64, C), dtype=torch.int32, device=dev)
    cyc = torch.zeros((64,), dtype=torch.int32, device=dev)
    rows = kv.chunk_rows(*a[:3], C, 0, 12, dev)
    layout = kv.reg_layout(a[0], a[3], a[4], C, 12, dev)
    chunk = (lambda: kv.vcycle_chunk(*a[:7], flags, cyc, 10**6, K=8,
                                     n_sends=12, layout=layout, gcore=-1,
                                     rows=rows))
    s = [torch.from_numpy(x).to(dev) for x in randprog.random_vcycle(
        rng, C, T, 24, 4, 32, Cp=Cp)]
    tables = kv.seed_layout(s[0], s[1], C, dev)
    seed = (lambda: kv.vcycle_seed(*s[:5], gcore=-1, tables=tables))
    return [("random C=300 B=64", "vcycle_chunk", chunk, rows.n_tts),
            ("random C=300 seed", "vcycle_seed", seed,
             tables.rows.n_tts)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--luts", action="store_true",
                    help="also time LUT tables staged against global")
    ap.add_argument("--tag", default="", help="a name for this checkout")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_vcycle: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.src).resolve()))
    import repro_torch.sim as sim
    from repro_torch.core import bsp
    from repro_torch.kernels import vcycle as kv
    tag = a.tag or a.src
    for case, kernel, fn, _ in cases(torch, kv, bsp, sim, ("mc",), SEEDS):
        n = 50 if "seed" in case else 20
        emit({"checkout": tag, "case": case,
              "device_ms": device_ms(torch, kv, fn, n, kernel),
              "event_ms": cuda_ms(torch, fn, n),
              "host_ms": host_ms(torch, fn, n)})
    if a.luts:
        limit = kv.STAGE_LUT_BYTES

        from repro_torch.kernels import randprog

        def plan(staged: bool, n_tts: int) -> None:
            # past the limit, staging is forced by raising it
            kv.STAGE_LUT_BYTES = max(limit, 64 * n_tts) if staged else 0
            kv._chunk_plan.cache_clear()
            kv._seed_plan.cache_clear()

        for case, kernel, fn, n_tts in cases(
                torch, kv, bsp, sim, ("mc", "bc", "noc"), SEEDS) + \
                past_the_limit(torch, kv, randprog):
            n = 50 if "seed" in case else 20
            got = {"staged": [], "global": []}
            for staged in (True, False, False, True):
                plan(staged, n_tts)
                got["staged" if staged else "global"].append(
                    device_ms(torch, kv, fn, n, kernel))
            plan(True, 0)
            emit({"checkout": tag, "case": case, "n_tts": n_tts,
                  "lut_bytes": 64 * n_tts, "staged_by_default":
                  64 * n_tts <= limit, "luts_device_ms": got})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
