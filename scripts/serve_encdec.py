#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s encoder-decoder and VLM serving phases alone
on one GPU.

    python3 scripts/serve_encdec.py     # from the root of a checkout

Builds the kernels (``kernels/build.py``), holds ``flash_attention`` at
the three shapes these paths give it (whisper-medium's encoder: BH = BHkv
= 64, S = 1500, dh = 64, not causal; its decoder's prefill: S = 224,
causal; qwen2-vl-72b's prefill: BH 256 over BHkv 32, S = 2304, dh = 128,
causal; all bf16, so ``flash_attention_sm90``) against ``flash_ref``,
then runs ``chip_smoke.phase_lm_serve_encdec`` (whisper-medium at full
width and all 48 layers) and ``chip_smoke.phase_lm_serve_vlm``
(qwen2-vl-72b at full width and 24 of its 80 layers) through
``make_serve_steps``, with their checks and JSON lines (prefill and
decode tokens/s, peak bytes), and times the kernel at the encoder's and
qwen2-vl's shapes against the plain version and SDPA
(``chip_smoke.time_flash_encdec``). Prints the card's name and power
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

SHAPES = cs.FLASH_CASES[-3:]    # whisper's encoder and decoder, qwen2-vl's


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_encdec: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import vcycle as kv
    from repro_torch.kernels.ref import flash_ref
    from repro_torch.launch import profile_serve, steps
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = cs.phase_device(torch)
    _, _, build_s = cs.timed_build(kbuild)
    cases = []
    for i, (BH, BHkv, S, dh, dtype, causal) in enumerate(SHAPES):
        q, k, v = cs.flash_inputs(torch, BH, BHkv, S, dh, dtype, i)
        fa.reset_counts()
        out = fa.flash_attention(q, k, v, causal)
        err = float((out.float() - flash_ref(q, k, v, causal).float())
                    .abs().max())
        if fa.COUNTS["flash_attention_sm90"] != 1 or sum(
                fa.COUNTS.values()) != 1 or err > cs.FLASH_TOL[dtype]:
            raise AssertionError(f"flash BH={BH} BHkv={BHkv} S={S} dh={dh} "
                                 f"causal={causal}: {dict(fa.COUNTS)}, "
                                 f"err {err}")
        cases.append({"BH": BH, "BHkv": BHkv, "S": S, "dh": dh,
                      "causal": causal, "max_abs_err": err})
        del q, k, v, out
    cs.emit({"phase": "flash_encdec", "build_s": build_s, "cases": cases})
    cs.phase_lm_serve_encdec(torch, fa, kv, flash_ref, steps, L, ARCHS, smi,
                             profile_serve)
    cs.phase_lm_serve_vlm(torch, fa, kv, flash_ref, steps, L, ARCHS, smi,
                          profile_serve)
    cs.emit({"phase": "timing_encdec",
             **cs.time_flash_encdec(torch, fa, flash_ref)})
    cs.emit({"phase": "done", "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
