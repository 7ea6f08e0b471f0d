"""A suite of self-checking tests, run batch after batch to FINISH.

The mix's parameters: ``suite`` stimuli made from the run's seed, each a
test of ``test_cycles`` cycles; ``batch`` of them at a time on the
``engine`` (``batched``, ``sharded`` over the run's devices, or
``machine`` for one stimulus), at the engine's default chunk; ``chips``,
which has to be the cell's. Images are laid out as the program's callers
lay them out, on its default pool of threads.

The suite (the stimuli and the reference's goldens and expected registers)
is timed apart as ``run.suite_s``, which ``setup_s`` leaves out: it is the
reference's work, which the program cannot move.

The window runs the batches in turn, repeating the suite, until the first
batch that ends after ``seconds``. A batch is three spans: ``images``
(``Bench.images_batch``), ``rebind`` (``BatchedEngine.rebind``; for the
machine engine ``reset``, which loads its one stimulus again) and
``run_batch`` (``run_batch``, or ``run``, to FINISH, results read).
"""
from __future__ import annotations

import random
import sys
import time

from .. import stimuli

# a suite at least this many stimulus lanes wide steps its reference on
# the card; a narrower one in NumPy, where a step costs less than a launch
CARD_LANES = 4096


def stimulus_seeds(seed: int, n: int):
    r = random.Random(seed)
    return [r.getrandbits(62) for _ in range(n)]


def make_suite(run):
    """The design's netlist and the mix's stimuli, with the reference's
    goldens and expected registers."""
    cfg, mix = run.cell.config, run.cell.traffic
    gen = stimuli.module(cfg["design"])
    n = int(mix["suite"])
    lanes = n * gen.lanes(cfg["params"])
    dev = run.devices[0]
    ref_dev = dev if dev.startswith("cuda") and lanes >= CARD_LANES \
        else None
    return gen.build(cfg["params"], int(mix["test_cycles"]),
                     stimulus_seeds(run.seed, n), int(cfg["net_seed"]),
                     device=ref_dev)


def setup(run) -> None:
    import repro_torch.sim as sim
    from repro_torch.circuits.common import Bench
    from repro_torch.core.isa import HardwareConfig

    cfg, mix = run.cell.config, run.cell.traffic
    t = [time.perf_counter()]
    start = (time.perf_counter_ns() - run.t_process) / 1e9
    suite = run.suite = make_suite(run)
    t.append(time.perf_counter())
    run.suite_s = t[1] - t[0]
    B = run.batch = int(mix["batch"])
    if int(mix["chips"]) != run.cell.chips:
        raise ValueError(f"mix of {mix['chips']} chips in a cell of "
                         f"{run.cell.chips}")
    if suite.size % B:
        raise ValueError(f"suite of {suite.size} is not a whole number of "
                         f"batches of {B}")
    run.benches = [
        Bench(suite.circuit, suite.finish, seeds=list(range(lo, lo + B)),
              reg_planes=suite.planes(lo, lo + B), mem_planes=[{}] * B)
        for lo in range(0, suite.size, B)]
    s = sim.compile(run.benches[0], HardwareConfig(**cfg.get("hw", {})),
                    cache=run.root / "rtlbench" / "cache" / "programs",
                    device=run.devices[0])
    t.append(time.perf_counter())
    run.program = s.program
    run.budget = s.default_cycles()
    kind = mix["engine"]
    images = run.benches[0].images_batch(s.program)
    if kind == "sharded":
        eng = s.engine(kind, images=images, devices=run.devices)
    else:
        eng = s.engine(kind, images=images)
    run.engine = eng
    t.append(time.perf_counter())
    # warm-up: each span of a batch once, one chunk long
    if kind != "machine":
        eng.rebind(images)
    eng.run_batch(eng.m.chunk)
    eng.reset()
    _sync(run)
    t.append(time.perf_counter())
    print(f"setup start {start:.3f} s " + " ".join(
        f"{k} {b - a:.3f} s" for k, a, b in zip(
            ("suite", "compile", "engine", "warm-up"), t, t[1:])),
        file=sys.stderr)


def _sync(run) -> None:
    import torch
    for d in dict.fromkeys(run.devices):
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def window(run, seconds: float) -> int:
    """Batches in turn until one ends after ``seconds``; returns its end."""
    eng, prog = run.engine, run.program
    machine = run.cell.traffic["engine"] == "machine"
    now = time.perf_counter_ns
    deadline = now() + int(seconds * 1e9)
    k = 0
    while True:
        i = k % len(run.benches)
        t0 = now()
        if machine:
            t1 = now()
            eng.reset()
            t2 = now()
            res = [eng.run(run.budget)]
        else:
            images = run.benches[i].images_batch(prog)
            t1 = now()
            eng.rebind(images)
            t2 = now()
            res = eng.run_batch(run.budget)
        t3 = now()
        run.batches.append({"index": i, "t0": t0, "t1": t1, "t2": t2,
                            "t3": t3,
                            "chunks_s": getattr(eng, "chunks_s", None)})
        run.results.append(res)
        k += 1
        if t3 >= deadline:
            return t3
