#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s MoE serving phase alone on one GPU.

    python3 scripts/serve_moe.py        # from the root of a checkout

Builds the kernels (``kernels/build.py``), holds ``flash_attention`` at
deepseek-moe-16b's prefill shape (BH=64 over BHkv=64, S=2048, dh=128,
bf16, causal; G = 1) against ``flash_ref``, then runs
``chip_smoke.phase_lm_serve_moe``: deepseek-moe-16b at full width and
depth and mixtral-8x7b at 16 layers through ``make_serve_steps``, with its
checks and its JSON line (prefill and decode tokens/s, peak bytes, each
layer's dropped share). About half a minute of command time, against
some four minutes for the whole smoke test. Prints the card's name and
power limit first. Needs a CUDA device.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_moe: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import vcycle as kv
    from repro_torch.kernels.ref import flash_ref
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_device(torch)
    _, _, build_s = cs.timed_build(kbuild)
    q, k, v = cs.flash_inputs(torch, 64, 64, 2048, 128, "bfloat16", 0)
    fa.reset_counts()
    out = fa.flash_attention(q, k, v, True)
    err = float((out.float() - flash_ref(q, k, v, True).float()).abs().max())
    if fa.COUNTS["flash_attention_sm90"] != 1 or err > cs.FLASH_TOL[
            "bfloat16"]:
        raise AssertionError(f"G=1 flash: {dict(fa.COUNTS)}, err {err}")
    del q, k, v, out
    cs.emit({"phase": "flash_g1", "build_s": build_s, "max_abs_err": err})
    cs.phase_lm_serve_moe(torch, fa, kv, flash_ref, steps, L, MOE, ARCHS)
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
