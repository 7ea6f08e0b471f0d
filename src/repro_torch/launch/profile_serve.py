"""Where LM serving spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch deepseek-moe-16b] [--layers 16]

``--arch`` takes any config: the dense and MoE decoders, zamba2-7b,
xlstm-125m, whisper-medium and qwen2-vl-72b.

Serves ``--arch`` (qwen3-0.6b unless given) at full width through
``make_serve_steps``, ``--layers`` of its layers where given (whisper's
encoder and decoder each cut to that many; random bf16 weights from a
seed; B=4 prompts of 2048 tokens, a cache for 2112; whisper's prompts are
224 tokens over 1500 frames, a cache for its 448-token text context;
qwen2-vl's prompts follow 256 patches, a cache for 2368), with the
stubbed frontend's input (``frontend_inputs``) from a numpy seed, and
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
# whisper's decoder prompt and its text context (n_text_ctx in
# openai/whisper's published model dimensions)
WHISPER_S, WHISPER_CTX = 224, 448
N_PATCHES = 256            # the reference's VLM patch prefix (input_specs)


def frontend_inputs(cfg, B: int, rng: np.random.Generator) -> dict:
    """The stubbed frontend's input, as numpy float32 from ``rng`` scaled
    by 0.02 (as the reference's tests make it): a VLM's ``patches`` ``[B,
    256, d]``, an encoder-decoder's ``frames`` ``[B, n_frames, d]``;
    nothing for other configs."""
    if cfg.family == "vlm":
        return {"patches": (rng.standard_normal(
            (B, N_PATCHES, cfg.d_model)) * 0.02).astype(np.float32)}
    if cfg.enc_dec:
        return {"frames": (rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)}
    return {}


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
    rng = np.random.default_rng(13)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S))).to(device)}
    for k, v in frontend_inputs(cfg, B, rng).items():
        batch[k] = torch.from_numpy(v).to(device, getattr(torch, cfg.dtype))
    start = S + (N_PATCHES if "patches" in batch else 0)
    cache = model.make_cache(B, ctx)
    state = {}

    def prefill():
        state["logits"], _ = prefill_step(params, batch, cache)

    def decode():
        tok = torch.argmax(state["logits"][:, -1], -1)[:, None]
        for i in range(decode_steps):
            tok, _ = decode_step(params, tok, cache, start + i)

    prefill()
    decode()                       # warm-up of both phases
    out = {"arch": cfg.name, "B": B, "S": S, "ctx": ctx,
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "decode_steps": decode_steps,
           "prefill": profile_phase(device, prefill)}
    prefill()                      # a fresh cache for the traced decode
    out["decode"] = profile_phase(device, decode)
    prefill()
    tok = torch.argmax(state["logits"][:, -1], -1)[:, None]
    with _OpCount() as count:
        decode_step(params, tok, cache, start)
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
        cfg = cfg.scaled(n_layers=args.layers, n_enc_layers=min(
            args.layers, cfg.n_enc_layers))
    if cfg.enc_dec:
        out = profile(cfg, torch.device("cuda"), B, WHISPER_S, WHISPER_CTX,
                      DECODE)
    else:
        ctx = CTX + (N_PATCHES if cfg.family == "vlm" else 0)
        out = profile(cfg, torch.device("cuda"), B, S, ctx, DECODE)
    out["n_layers"] = cfg.n_layers
    out["n_enc_layers"] = cfg.n_enc_layers
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
