#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s SSM serving phase alone on one GPU.

    python3 scripts/serve_ssm.py        # from the root of a checkout

Builds the kernels (``kernels/build.py``), holds ``flash_attention`` at
zamba2-7b's prefill shape (BH = BHkv = 128, S = 2048, dh = 112, bf16,
causal: ``flash_attention_simt``) against ``flash_ref``, then runs
``chip_smoke.phase_lm_serve_ssm``: zamba2-7b at full width and all 81
layers and xlstm-125m through ``make_serve_steps``, with its checks and
its JSON line (prefill and decode tokens/s, peak bytes), and times the
kernel at that shape against the plain version and SDPA
(``chip_smoke.time_flash_zamba2``). Prints the card's name and power
limit first. Needs a CUDA device.
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
        print("serve_ssm: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import vcycle as kv
    from repro_torch.kernels.ref import flash_ref
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    _, _, build_s = cs.timed_build(kbuild)
    q, k, v = cs.flash_inputs(torch, 128, 128, 2048, 112, "bfloat16", 0)
    fa.reset_counts()
    out = fa.flash_attention(q, k, v, True)
    err = float((out.float() - flash_ref(q, k, v, True).float()).abs().max())
    if fa.COUNTS["flash_attention_simt"] != 1 or err > cs.FLASH_TOL[
            "bfloat16"]:
        raise AssertionError(f"dh 112 flash: {dict(fa.COUNTS)}, err {err}")
    del q, k, v, out
    cs.emit({"phase": "flash_dh112", "build_s": build_s, "max_abs_err": err})
    cs.phase_lm_serve_ssm(torch, fa, kv, flash_ref, steps, L, ARCHS, smi)
    cs.emit({"phase": "timing_dh112",
             **cs.time_flash_zamba2(torch, fa, flash_ref)})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
