#!/usr/bin/env python3
"""Time the flash attention kernels of one checkout's ``repro_torch`` on one
GPU, and measure the float32 kernels' error against a float64 reference.

    python3 scripts/time_flash.py [--src DIR] [--tag NAME] [--repeats N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that one script times two checkouts on one card: run it once per checkout,
in turns (A, B, B, A), within one machine. Cases, at the shapes of
``chip_smoke.py`` phase ``timing`` (qwen3-0.6b: BH=64 query heads over
BHkv=32, S=2048, dh=128, causal):

* bf16: ``flash_attention_sm90``, the forward, as serving runs it (no lse)
  and, where the checkout's wrapper takes ``return_lse``, saving lse as
  training runs it; ``flash_attention_bwd`` in bf16, and
  ``flash_attention_bwd_sm90`` where the checkout has it;
* float32: ``flash_attention_simt`` without lse and, where its wrapper
  takes ``return_lse``, with it; ``flash_attention_bwd`` without lse and,
  where its wrapper takes ``lse``, given the forward's; SDPA's forward and
  backward in float32 (the same in every checkout: a yardstick of the
  card).

Each is CUDA-event ms per call over a loop of calls after a warm-up,
``--repeats`` times in turns. The bf16 forward without lse is timed first
and alone, while the two checkouts have allocated the same tensors (its
output's address then does not depend on what else a checkout times).
The float32 kernels' outputs are held against attention and its gradient
computed in float64 on the same inputs (``exact``): the max abs error of
the output, of lse, and of each of dq, dk, dv with that over the output's
max. Prints one JSON line, then the card's
name and power limit.
"""
import argparse
import inspect
import json
import math
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


def inputs(torch, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((BH, S, DH), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((BHKV, S, DH), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, do


def exact(torch, q, k, v, do):
    """Causal attention of q over k, v and its gradient given do, in
    float64 throughout (the plain math of ``flash_ref`` and
    ``flash_bwd_ref``, written out here so that every checkout is held to
    the same yardstick): (o, lse, (dq, dk, dv))."""
    G = q.shape[0] // k.shape[0]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    kg, vg = (t.repeat_interleave(G, dim=0) for t in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q, kg) / math.sqrt(DH)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    del s
    o = torch.einsum("bqk,bkd->bqd", p, vg)
    dv = torch.einsum("bqk,bqd->bkd", p, do).view(-1, G, S, DH).sum(1)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, vg)
              - (do * o).sum(-1, keepdim=True)) / math.sqrt(DH)
    del p
    dq = torch.einsum("bqk,bkd->bqd", ds, kg)
    dk = torch.einsum("bqk,bqd->bkd", ds, q).view(-1, G, S, DH).sum(1)
    return o, lse, (dq, dk, dv)


def errors(torch, fa, q, k, v, do, has_lse: bool, bwd_lse: bool):
    """The float32 kernels' max abs error against ``exact`` on the same
    inputs: {"o", "lse", "bwd": {"dq", "dk", "dv"}, "bwd_over_max": {...}}
    (the backward given the forward's lse where the wrapper takes it)."""
    o64, lse64, grads64 = exact(torch, q, k, v, do)
    out = {}
    if has_lse:
        o, lse = fa.flash_attention_simt(q, k, v, return_lse=True)
        out["lse"] = float((lse.double() - lse64).abs().max())
        grads = (fa.flash_attention_bwd(q, k, v, o, do, lse=lse) if bwd_lse
                 else fa.flash_attention_bwd(q, k, v, o, do))
    else:
        o = fa.flash_attention_simt(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, o, do)
    out["o"] = float((o.double() - o64).abs().max())
    out["bwd"], out["bwd_over_max"] = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads64):
        err = float((a.double() - b).abs().max())
        out["bwd"][name] = err
        out["bwd_over_max"][name] = err / float(b.abs().max())
    del o64, lse64, grads64
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch to time")
    ap.add_argument("--tag", default="", help="label of this checkout")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("time_flash: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = inputs(torch, torch.bfloat16, 0)
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

    # float32
    q32, k32, v32, do32 = inputs(torch, torch.float32, 1)
    has_lse = "return_lse" in inspect.signature(
        fa.flash_attention_simt).parameters
    bwd_lse = "lse" in inspect.signature(fa.flash_attention_bwd).parameters
    o32 = fa.flash_attention_simt(q32, k32, v32)
    cases["fp32_flash_attention_simt"] = (
        lambda: fa.flash_attention_simt(q32, k32, v32), 10, 2)
    if has_lse:
        _, lse32 = fa.flash_attention_simt(q32, k32, v32, return_lse=True)
        cases["fp32_flash_attention_simt_lse"] = (
            lambda: fa.flash_attention_simt(q32, k32, v32, return_lse=True),
            10, 2)
    cases["fp32_flash_attention_bwd"] = (
        lambda: fa.flash_attention_bwd(q32, k32, v32, o32, do32), 5, 1)
    if bwd_lse:
        cases["fp32_flash_attention_bwd_lse"] = (
            lambda: fa.flash_attention_bwd(q32, k32, v32, o32, do32,
                                           lse=lse32), 5, 1)
    q4, k4, v4 = (t.view(4, t.shape[0] // 4, S, DH).detach().requires_grad_()
                  for t in (q32, k32, v32))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    do4 = do32.view(4, BH // 4, S, DH)
    cases["fp32_sdpa"] = (lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 10, 2)
    cases["fp32_sdpa_bwd"] = (lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 10, 2)

    ms.update({name: [] for name in cases})
    for _ in range(args.repeats):
        for name, (fn, n, warm) in cases.items():
            ms[name].append(cuda_ms(torch, fn, n, warm))
    del q4, k4, v4, o4, do4
    err = errors(torch, fa, q32, k32, v32, do32, has_lse, bwd_lse)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "case": f"BH={BH} BHkv={BHKV} S={S} dh={DH} causal",
                      "ms": ms, "ms_mean": {n: sum(t) / len(t)
                                           for n, t in ms.items()},
                      "fp32_err_vs_float64": err,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
