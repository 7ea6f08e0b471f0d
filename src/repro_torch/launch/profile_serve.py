"""Where LM serving spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch deepseek-moe-16b] [--layers 16]

``--arch`` takes any config the port serves: the dense and MoE decoders,
zamba2-7b and xlstm-125m.

Serves ``--arch`` (qwen3-0.6b unless given) at full width through
``make_serve_steps``, ``--layers`` of its layers where given (random bf16
weights from a seed; B=4 prompts of 2048 tokens, a cache for 2112) and
traces one prefill and 8 greedy decode steps with ``torch.profiler``,
after a warm-up of each. Prints one JSON line: for each phase the wall
time (host clock, ending in a synchronize), the device-busy time (the sum
of the kernels' times in the trace; the serving path runs on one stream,
so they do not overlap) and so the device's idle share, the kernels with
the most device time, and the aten ops one decode step dispatches. Needs
a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS
from .steps import make_serve_steps

B, S, CTX, DECODE = 4, 2048, 2048 + 64, 8


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernel_times(prof):
    """(total device us, [(kernel, calls, us)] by time) of the trace's
    kernels (the CPU ops that launched them also carry their time)."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type == cuda]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows


def profile_phase(device, fn, top: int = 12) -> dict:
    """Wall time and device-busy time of ``fn()`` under the profiler."""
    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    busy_us, rows = _kernel_times(prof)
    return {"wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "idle_share": 1 - busy_us / 1e3 / (wall * 1e3)
            if busy_us else None,
            "top_kernels": [{"name": k[:120], "calls": n, "ms": us / 1e3}
                            for k, n, us in rows[:top]]}


def profile(cfg, device, B: int, S: int, ctx: int, decode_steps: int
            ) -> dict:
    """The trace's numbers for one model on ``device``."""
    model, prefill_step, decode_step = make_serve_steps(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (B, S))).to(device)
    cache = model.make_cache(B, ctx)
    state = {}

    def prefill():
        state["logits"], _ = prefill_step(params, {"tokens": tokens}, cache)

    def decode():
        tok = torch.argmax(state["logits"][:, -1], -1)[:, None]
        for i in range(decode_steps):
            tok, _ = decode_step(params, tok, cache, S + i)

    prefill()
    decode()                       # warm-up of both phases
    out = {"arch": cfg.name, "B": B, "S": S, "ctx": ctx,
           "decode_steps": decode_steps,
           "prefill": profile_phase(device, prefill)}
    prefill()                      # a fresh cache for the traced decode
    out["decode"] = profile_phase(device, decode)
    prefill()
    tok = torch.argmax(state["logits"][:, -1], -1)[:, None]
    with _OpCount() as count:
        decode_step(params, tok, cache, S)
    out["aten_ops_per_decode_step"] = count.n
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve this many of the config's layers")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    out = profile(cfg, torch.device("cuda"), B, S, CTX, DECODE)
    out["n_layers"] = cfg.n_layers
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
