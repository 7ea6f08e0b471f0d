#!/usr/bin/env python3
"""Time the bf16 flash attention kernels of one checkout's ``repro_torch``
on one GPU.

    python3 scripts/time_flash.py [--src DIR] [--tag NAME] [--repeats N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that one script times two checkouts on one card: run it once per checkout,
in turns (A, B, B, A), within one machine. Cases, at the shapes of
``chip_smoke.py`` phase ``timing`` (qwen3-0.6b: BH=64 query heads over
BHkv=32, S=2048, dh=128, bf16, causal):

* ``flash_attention_sm90``, the forward, as serving runs it (no lse) and,
  where the checkout's wrapper takes ``return_lse``, saving lse as
  training runs it;
* ``flash_attention_bwd`` (the SIMT backward kernel) in bf16, and
  ``flash_attention_bwd_sm90`` where the checkout has it.

Each is CUDA-event ms per call over a loop of calls after a warm-up,
``--repeats`` times in turns. The forward without lse is timed first and
alone, while the two checkouts have allocated the same tensors (its
output's address then does not depend on what else a checkout times).
Prints one JSON line, then the card's name and power limit.
"""
import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BH, BHKV, S, DH = 64, 32, 2048, 128


def cuda_ms(torch, fn, n: int, warm: int) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to time")
    ap.add_argument("--tag", default="", help="label of this checkout")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((BH, S, DH), generator=g, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((BHKV, S, DH), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    ms = {"flash_attention_sm90": [
        cuda_ms(torch, lambda: fa.flash_attention_sm90(q, k, v), 50, 5)
        for _ in range(args.repeats)]}
    o = fa.flash_attention_sm90(q, k, v)
    cases = {}
    if "return_lse" in inspect.signature(fa.flash_attention_sm90).parameters:
        _, lse = fa.flash_attention_sm90(q, k, v, return_lse=True)
        cases["flash_attention_sm90_lse"] = (
            lambda: fa.flash_attention_sm90(q, k, v, return_lse=True), 50, 5)
        cases["flash_attention_bwd_sm90"] = (
            lambda: fa.flash_attention_bwd_sm90(q, k, v, o, do, lse), 20, 3)
    cases["flash_attention_bwd"] = (
        lambda: fa.flash_attention_bwd(q, k, v, o, do), 3, 1)
    ms.update({name: [] for name in cases})
    for _ in range(args.repeats):
        for name, (fn, n, warm) in cases.items():
            ms[name].append(cuda_ms(torch, fn, n, warm))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "case": f"BH={BH} BHkv={BHKV} S={S} dh={DH} bf16 "
                              "causal",
                      "ms": ms, "ms_mean": {n: sum(t) / len(t)
                                           for n, t in ms.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
