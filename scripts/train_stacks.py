#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phases of the last three stacks alone
on one GPU.

    python3 scripts/train_stacks.py     # from the root of a checkout

Builds the kernels (``kernels/build.py``), then runs
``chip_smoke.phase_lm_train_encdec`` (whisper-medium whole, B=4 x 224
tokens over 1500 frames, a warm-up and 3 timed steps, and its float32
check at 2 + 2 layers) and ``chip_smoke.phase_lm_train_ssm`` (xlstm-125m
whole and zamba2-7b at 9 of its 81 layers, B=4 x 2048 tokens, a warm-up
and 1 timed step each, and zamba2's float32 check at 9 layers), each with
its checks and JSON line, and times the backward flash kernels at the
shapes these paths give them (``chip_smoke.time_flash_bwd_stacks``).
Prints the card's name and power limit first. Needs a CUDA device.
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
        print("train_stacks: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import vcycle as kv
    from repro_torch.kernels.ref import flash_bwd_ref, flash_ref
    from repro_torch.launch import profile_serve, steps
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    _, _, build_s = cs.timed_build(kbuild)
    cs.emit({"phase": "build", "build_s": build_s})
    encdec = cs.phase_lm_train_encdec(
        torch, fa, kv, flash_ref, steps, L, ARCHS, adamw, TokenPipeline,
        PipelineConfig, smi, profile_serve)
    ssm = cs.phase_lm_train_ssm(torch, fa, kv, flash_ref, steps, L, ARCHS,
                                adamw, TokenPipeline, PipelineConfig, smi)
    cs.emit({"phase": "timing_train_stacks",
             "launches_on_bf16_encdec_train_path": encdec[0],
             "launches_on_bf16_ssm_train_path": ssm[0],
             **cs.time_flash_bwd_stacks(torch, fa, flash_bwd_ref)})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
