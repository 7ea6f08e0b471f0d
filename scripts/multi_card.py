#!/usr/bin/env python3
"""``chip_smoke.py``'s ``sharded``, ``grid`` and ``lm_train_dp`` phases,
one shard a card; with ``--model-parallel``, its ``lm_train_tp`` phase,
one model shard a card; with ``--serve-big``, its ``lm_serve_big`` phase
at full depth for the three models no one card holds, one model shard a
card.

    python3 scripts/multi_card.py [--trace DIR]   # on 4 or more cards
    python3 scripts/multi_card.py --model-parallel
    python3 scripts/multi_card.py --serve-big

``chip_smoke.py`` runs the multi-device engines on one and on four shards
of one card, which tests their logic on a one-card machine. This script
runs the same cases with shard s on card s (D=1 on card 0, D=4 on cards
0-3): each card runs its own launches, and the grid's exchange copies
SEND values from card to card every Vcycle. Every case is held bit for bit
against ``BatchedMachine`` or ``Machine`` on card 0, as in
``chip_smoke.py``. ``lm_train_dp`` trains qwen3-0.6b at full width
data-parallel with shard s on card s (its float32 check on cards 0-1):
the bucketed gradient sum then copies between cards, and the phase holds
it to ``chip_smoke.py``'s checks (launches, replicas bit-equal, the loss
beside the one-device step's, float32 against the one-device step).
Prints the card's name and power limit, one JSON line
a phase, and ``{"ok": true, ...}`` last; exits non-zero, with no such
line, when a phase fails or fewer than four cards are present. With
``--trace DIR`` it also writes a ``torch.profiler`` trace (Chrome format)
of one ``sharded`` run (mc/full, B=510 over four cards, and over four
shards of card 0) and one ``grid`` run (mc/full, B=64 over four cards) to
``DIR``. ``--model-parallel`` runs only ``lm_train_tp``: qwen3-0.6b at
full width trained tensor-parallel on mesh (1, 4) with model shard m on
card m (its float32 check on mesh (2, 2) over cards 0-3), so every
model-axis sum and gather copies between cards; held to
``chip_smoke.py``'s checks (launches, replicas bit-equal, float32 against
the one-device step), with the sums' and gathers' CUDA-event ms a step.
``--serve-big`` runs only ``lm_serve_big`` (``BIG_MODELS``): qwen1.5-110b
(80 layers, 222 GB in bf16), qwen2-vl-72b (80 layers, 145 GB, with its
256 stub patches) and mixtral-8x7b (32 layers, 93 GB, expert-parallel, 2
experts a shard) served whole in bf16 on mesh (1, 4) with model shard m
on card m, each model's parameters drawn straight into their blocks on
the four cards (``init_sharded``), each card's peak beside its
reckoning, each model's float32 check at 2 layers against one device;
one JSON line a model.
"""
import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CARDS = 4
BIG_MODELS = ("qwen1.5-110b", "qwen2-vl-72b", "mixtral-8x7b")


def trace(torch, path: Path, fn) -> None:
    """A ``torch.profiler`` trace of one call of ``fn``, host and cards."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    prof.export_chrome_trace(str(path))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=None,
                    help="directory for the two runs' traces")
    ap.add_argument("--model-parallel", action="store_true",
                    help="run lm_train_tp only, one model shard a card")
    ap.add_argument("--serve-big", action="store_true",
                    help="run lm_serve_big only, at full depth for "
                         + ", ".join(BIG_MODELS) + ", one model shard a card")
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < CARDS:
        print(f"multi_card: needs {CARDS} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch.sim as sim
    from repro_torch.circuits import FINISH
    from repro_torch.core import bsp
    from repro_torch.configs import ARCHS
    from repro_torch.core.grid import GridMachine
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed import overlap as OV
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import profile_serve, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import vcycle as kv
    from repro_torch.sim.engine import IsaEngine

    def place(D: int) -> list:
        return [f"cuda:{i}" for i in range(D)]

    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    kbuild.load()
    if args.serve_big:
        big = {arch: cs.phase_lm_serve_big(
            torch, fa, kv, steps, ARCHS, SH, make_host_mesh, profile_serve,
            smi, arch, None, place) for arch in BIG_MODELS}
        cs.emit({"phase": "done", "sm90_launches_on_bf16_big_serving_path":
                 {a: n for a, (n, _) in big.items()},
                 "simt_launches_on_fp32_big_serving_check":
                 {a: n for a, (_, n) in big.items()},
                 "seconds": time.perf_counter() - t0})
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.model_parallel:
        tp, tp32 = cs.phase_lm_train_tp(
            torch, fa, kv, steps, ARCHS, adamw, TokenPipeline,
            PipelineConfig, SH, TP, make_host_mesh, place)
        cs.emit({"phase": "done", "launches_on_bf16_tp_train_path": tp,
                 "launches_on_fp32_tp_train_check": tp32,
                 "seconds": time.perf_counter() - t0})
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    s = sim.compile("mc", scale="full", seeds=range(cs.MAIN_SEEDS),
                    device="cuda:0")
    results = s.run()
    launches, s_bc = cs.phase_sharded(torch, kv, sim, bsp, IsaEngine, FINISH,
                                      s, results, place)
    grid = cs.phase_grid(torch, kv, bsp, GridMachine, FINISH,
                         (("mc", s), ("bc", s_bc)), place)
    if args.trace is not None:
        args.trace.mkdir(parents=True, exist_ok=True)
        n = s.default_cycles()
        images = tuple(a[:cs.SHARDED_B] for a in s.images_stacked())
        for tag, devices in (("d4", place(4)), ("1card", ["cuda:0"] * 4)):
            sm = bsp.ShardedBatchedMachine(s.program, images=images,
                                           devices=devices)
            sm.run(sm.init_state(), n)
            trace(torch, args.trace / f"sharded_mc_b510_{tag}.json",
                  lambda: sm.run(sm.init_state(), n))
        gm = GridMachine(s.program, place(4),
                         images=tuple(a[:cs.MULTI_SEEDS] for a in images))
        gm.run(gm.init_state(), n)
        trace(torch, args.trace / "grid_mc_b64_d4.json",
              lambda: gm.run(gm.init_state(), n))
    dp, dp32 = cs.phase_lm_train_dp(torch, fa, kv, steps, ARCHS, adamw,
                                    TokenPipeline, PipelineConfig, SH, OV,
                                    make_host_mesh, place)
    cs.emit({"phase": "done", "chunk_launches_on_sharded_path": launches,
             "chunk_launches_on_grid_path": grid,
             "launches_on_bf16_dp_train_path": dp,
             "launches_on_fp32_dp_train_check": dp32,
             "seconds": time.perf_counter() - t0})
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
