#!/usr/bin/env python3
"""Time the flash attention kernels of one checkout's ``repro_torch`` on one
GPU beside PyTorch's SDPA, and measure the float32 kernels' error against a
float64 reference.

    python3 scripts/time_flash.py [--src DIR] [--tag NAME] [--repeats N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that one script times two checkouts on one card: run it once per checkout,
in turns (A, B, B, A), within one machine. Cases:

* bf16, at every shape the wgmma pair runs on a measured path
  (``BF16_CASES``: qwen3-0.6b's prefill and training, a model shard of it,
  whisper-medium's encoder, qwen2-vl-72b's G 8, starcoder2-3b's G 12, a
  qwen1.5-110b model shard, zamba2-7b's dh 112, the dry run's 32768-token
  prefill, and qwen3-0.6b at batch 2): ``flash_attention_sm90`` as serving
  runs it (no lse) and saving lse as training runs it,
  ``flash_attention_bwd_sm90`` given that lse (the shapes in
  ``BWD_CASES``), and SDPA's forward and backward in bf16 on the same
  inputs (the same in every checkout: a yardstick of the card), each with
  the bound at 989 TFLOP/s bf16 and the kernel's largest error against
  SDPA's output;
* float32, at qwen3-0.6b's shape:
  ``flash_attention_simt`` with and without lse, ``flash_attention_bwd``
  with and without the forward's lse, SDPA's forward and backward in
  float32, and the float32 kernels' error against attention and its
  gradient computed in float64 (``exact``): the max abs error of the
  output, of lse, and of each of dq, dk, dv with that over the output's
  max.

Each time is CUDA-event ms per call over a loop of calls after a warm-up,
``--repeats`` times in turns over the cases; for the bf16 cases also the
device ms per call (``device_ms``: every kernel a call launches, by
``torch.profiler``, once), which a small shape's host time does not hide.
Prints one JSON line, then the card's name and power limit.
"""
import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# name: (BH, BHkv, S, dh, causal)
BF16_CASES = {
    "qwen3_0.6b": (64, 32, 2048, 128, True),
    "qwen3_0.6b_model_shard": (16, 8, 2048, 128, True),
    "whisper_encoder": (64, 64, 1500, 64, False),
    "qwen2_vl_72b_g8": (256, 32, 2304, 128, True),
    "starcoder2_3b_g12": (96, 8, 2048, 128, True),
    "qwen1.5_110b_model_shard": (64, 8, 2048, 128, True),
    "zamba2_7b_dh112": (128, 128, 2048, 112, True),
    "dryrun_prefill_s32768": (16, 8, 32768, 128, True),
    # qwen3-0.6b at batch 2: 256 dK/dV items of 128 keys, between the
    # backward's two item shapes (flash_attention_bwd_sm90.cu, launch)
    "qwen3_0.6b_b2": (32, 16, 2048, 128, True),
}
# the shapes the backward kernel runs on a measured path
BWD_CASES = ("qwen3_0.6b", "qwen3_0.6b_model_shard", "whisper_encoder",
             "starcoder2_3b_g12", "zamba2_7b_dh112", "qwen3_0.6b_b2")
BF16_FLOPS_PER_S = 989e12
BH, BHKV, S, DH = BF16_CASES["qwen3_0.6b"][:4]


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


def device_ms(torch, fn, n: int) -> float:
    """Milliseconds of device time per call of ``fn``: every CUDA kernel
    that ``n`` calls launch, by ``torch.profiler``, after a warm-up call.
    Unlike CUDA events around the calls, this leaves out the host's time
    between launches, which exceeds a small shape's kernels."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(float(getattr(e, "self_device_time_total", 0.0))
             for e in prof.key_averages() if e.device_type == cuda)
    return us / 1e3 / n


def inputs(torch, dtype, seed, bh=BH, bhkv=BHKV, s=S, dh=DH):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((bh, s, dh), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bhkv, s, dh), generator=g, device="cuda").to(dtype)
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


def errors(torch, fa, q, k, v, do):
    """The float32 kernels' max abs error against ``exact`` on the same
    inputs: {"o", "lse", "bwd": {"dq", "dk", "dv"}, "bwd_over_max": {...}}
    (the backward given the forward's lse)."""
    o64, lse64, grads64 = exact(torch, q, k, v, do)
    o, lse = fa.flash_attention_simt(q, k, v, return_lse=True)
    grads = fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    out = {"lse": float((lse.double() - lse64).abs().max()),
           "o": float((o.double() - o64).abs().max()), "bwd": {},
           "bwd_over_max": {}}
    for name, a, b in zip(("dq", "dk", "dv"), grads, grads64):
        err = float((a.double() - b).abs().max())
        out["bwd"][name] = err
        out["bwd_over_max"][name] = err / float(b.abs().max())
    del o64, lse64, grads64
    torch.cuda.empty_cache()
    return out


def bf16_case(torch, F, fa, name, seed):
    """The timed calls of one bf16 case, with its bound and the kernels'
    largest error against SDPA's output: ({label: (fn, n, warm)}, info)."""
    bh, bhkv, s, dh, causal = BF16_CASES[name]
    q, k, v, do = inputs(torch, torch.bfloat16, seed, bh, bhkv, s, dh)
    # SDPA on [1, heads, S, dh] views; enable_gqa reads KV head i // G as
    # the kernels do
    q1, k1, v1 = (t.view(1, *t.shape).detach().requires_grad_()
                  for t in (q, k, v))
    gqa = bh != bhkv
    o1 = F.scaled_dot_product_attention(q1, k1, v1, is_causal=causal,
                                        enable_gqa=gqa)
    o, lse = fa.flash_attention_sm90(q, k, v, causal, return_lse=True)
    flops = (2 if causal else 4) * bh * s * s * dh
    info = {"shape": f"BH={bh} BHkv={bhkv} S={s} dh={dh} bf16 "
                     f"{'causal' if causal else 'not causal'}",
            "bound_ms": flops / BF16_FLOPS_PER_S * 1e3, "flops": flops,
            "err_vs_sdpa": float((o.float() - o1.detach()[0].float())
                                 .abs().max())}
    n = 5 if s > 8192 else 20
    calls = {
        "fwd": (lambda: fa.flash_attention_sm90(q, k, v, causal), n, 3),
        "fwd_lse": (lambda: fa.flash_attention_sm90(q, k, v, causal,
                                                    return_lse=True), n, 3),
        "sdpa": (lambda: F.scaled_dot_product_attention(
            q1, k1, v1, is_causal=causal, enable_gqa=gqa), n, 3)}
    if name in BWD_CASES:
        grads = fa.flash_attention_bwd_sm90(q, k, v, o, do, lse, causal)
        want = torch.autograd.grad(o1, (q1, k1, v1), do.view(1, *do.shape),
                                   retain_graph=True)
        info["bwd_bound_ms"] = 2.5 * info["bound_ms"]
        info["bwd_err_over_max_vs_sdpa"] = {
            g: float((a.float() - b[0].float()).abs().max()
                     / b.float().abs().max())
            for g, a, b in zip(("dq", "dk", "dv"), grads, want)}
        calls["bwd"] = (lambda: fa.flash_attention_bwd_sm90(
            q, k, v, o, do, lse, causal), n, 3)
        calls["sdpa_bwd"] = (lambda: torch.autograd.grad(
            o1, (q1, k1, v1), do.view(1, *do.shape), retain_graph=True),
            n, 3)
    return calls, info


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

    ms, infos = {}, {}
    for i, name in enumerate(BF16_CASES):
        calls, infos[name] = bf16_case(torch, F, fa, name, i)
        ms[name] = {label: [] for label in calls}
        for _ in range(args.repeats):
            for label, (fn, n, warm) in calls.items():
                ms[name][label].append(cuda_ms(torch, fn, n, warm))
        infos[name]["device_ms"] = {label: device_ms(torch, fn, n)
                                    for label, (fn, n, _) in calls.items()}
        del calls
        torch.cuda.empty_cache()
    cases = {name: {**infos[name], "ms": ms[name], "ms_median": {
        label: statistics.median(t) for label, t in ms[name].items()}}
        for name in BF16_CASES}

    q32, k32, v32, do32 = inputs(torch, torch.float32, 1)
    o32, lse32 = fa.flash_attention_simt(q32, k32, v32, return_lse=True)
    q4, k4, v4 = (t.view(4, t.shape[0] // 4, S, DH).detach()
                  .requires_grad_() for t in (q32, k32, v32))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    do4 = do32.view(4, BH // 4, S, DH)
    calls = {
        "flash_attention_simt": (
            lambda: fa.flash_attention_simt(q32, k32, v32), 10, 2),
        "flash_attention_simt_lse": (
            lambda: fa.flash_attention_simt(q32, k32, v32,
                                            return_lse=True), 10, 2),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q32, k32, v32, o32, do32), 5,
            1),
        "flash_attention_bwd_lse": (
            lambda: fa.flash_attention_bwd(q32, k32, v32, o32, do32,
                                           lse=lse32), 5, 1),
        "sdpa": (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), 10, 2),
        "sdpa_bwd": (lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True), 10, 2)}
    t32 = {label: [] for label in calls}
    for _ in range(args.repeats):
        for label, (fn, n, warm) in calls.items():
            t32[label].append(cuda_ms(torch, fn, n, warm))
    del q4, k4, v4, o4, do4, calls
    fp32 = {"case": f"BH={BH} BHkv={BHKV} S={S} dh={DH} float32 causal",
            "ms": t32, "ms_median": {label: statistics.median(t)
                                     for label, t in t32.items()},
            "err_vs_float64": errors(torch, fa, q32, k32, v32, do32)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": args.src, "bf16": cases,
                      "fp32": fp32, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
