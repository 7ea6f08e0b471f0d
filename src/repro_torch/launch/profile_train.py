"""Where LM training spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--shards 4]
        [--arch whisper-medium] [--layers 9]

Trains ``--arch`` (qwen3-0.6b unless given; any config) at full width
through ``make_train_step``, ``--layers`` of its layers where given
(whisper's encoder and decoder each cut to that many; zamba2-7b and
deepseek-moe-16b need a cut to train on one card: ``--layers 9`` is one
group of six Mamba2 layers with its shared attention and a three-layer
tail), with random bf16 weights from a seed and ``TokenPipeline``
batches of B=4 x S=2048 tokens (whisper: 224 tokens over 1500 frames
from ``profile_serve.frontend_inputs``), and traces one step with
``torch.profiler`` after a warm-up step. Prints one JSON line: the
step's wall time (host clock, ending in a synchronize), its device-busy
time (the sum of the kernels' times; the step runs on one stream, so
they do not overlap) and the device's idle share, the device time of
each kind of kernel (the backward flash kernels, wgmma and 3xTF32, the
forward flash kernels, matrix products, the rest) and of each flash
kernel's entry function (the backward's passes apart), the kernels with
the most device time, the aten ops the step dispatches, and the peak
device memory. For zamba2 and xLSTM also ``scan``: each recurrent
block's scan traced alone at the step's shapes under grad (the forward,
which keeps a state a chunk, and its backward, which recomputes each
chunk), and the step's scan device ms reckoned from them (each layer's
scan runs forward three times, the step's, the layer's recompute and the
chunk's, and backward once). ``--shards D`` traces the data-parallel
step over D shards of the card instead (``make_train_step(cfg, mesh)``,
each shard B/D rows, the bucketed reduction, AdamW on every replica).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import ARCHS
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed.sharding import replicate
from ..models import ssm as SSM
from ..optim import adamw
from .mesh import make_host_mesh
from .profile_serve import (WHISPER_S, _OpCount, _kernel_times,
                            frontend_inputs, profile_phase)
from .steps import make_train_step

B, S = 4, 2048
# kernel-name fragments of each kind, first match wins
KINDS = (("flash_attention_bwd_sm90", ("flash_attention_bwd_sm90",)),
         ("flash_attention_bwd", ("flash_attention_bwd",)),
         ("flash_attention_fwd", ("flash_attention",)),
         ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def profile(cfg, device, B: int, S: int, shards: int = 1) -> dict:
    """One step traced, on ``device`` or, with ``shards`` > 1, over that
    many data shards of it."""
    mesh = (make_host_mesh(devices=[device] * shards) if shards > 1
            else None)
    model, step, _, _ = make_train_step(cfg, mesh or device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": adamw.init(params)}
    if mesh is not None:
        state = {k: replicate(v, mesh) for k, v in state.items()}
    del params
    pipe = TokenPipeline(PipelineConfig(cfg.vocab, S, B))
    extra = {k: torch.from_numpy(v).to(device) for k, v in frontend_inputs(
        cfg, B, np.random.default_rng(13)).items()}

    def one(i):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(i).items()}
        batch.update(extra)
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], batch)

    one(0)                                   # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_enc_layers": cfg.n_enc_layers, "B": B, "S": S,
           "inputs": {k: list(v.shape) for k, v in extra.items()},
           "shards": shards,
           "step": profile_phase(device, lambda: one(1), top=12)}
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    with torch.profiler.profile(activities=acts) as prof:
        one(2)
        torch.cuda.synchronize(device)
    by_kind, flash = {}, {}
    for name, calls, us in _kernel_times(prof)[1]:
        k = kind_of(name)
        by_kind[k] = by_kind.get(k, 0.0) + us / 1e3
        if "flash_attention" in name:
            # "void (anonymous namespace)::<entry><DH>(...)" -> entry
            entry = name.split("::")[-1].split("<")[0]
            flash[entry] = {"calls": calls, "ms": us / 1e3}
    out["device_ms_by_kind"] = by_kind
    out["flash_kernels"] = flash
    with _OpCount() as count:
        one(3)
    out["aten_ops_per_step"] = count.n
    if cfg.block in ("mamba2", "xlstm"):
        out["scan"] = scan_trace(cfg, device, B, S)
    return out


def _scan_inputs(cfg, kind: str, B: int, S: int, device):
    """(steps function, start state, sequences) of one block's scan at
    the step's shapes, random, the sequences requiring grad."""
    g = torch.Generator(device=device).manual_seed(5)

    def rand(*shape, lo=0.0, hi=1.0):
        t = torch.rand(shape, generator=g, device=device) * (hi - lo) + lo
        return t.requires_grad_()

    d = cfg.d_model
    if kind == "mamba2":
        H, N, P = 2 * d // cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_headdim
        h = torch.zeros((B, N, H, P), device=device)
        return SSM._mamba2_steps, h, (rand(B, S, H, lo=0.5), rand(B, S, N),
                                      rand(B, S, H, P), rand(B, S, N))
    if kind == "mlstm":
        H = cfg.n_heads
        dh = d // H
        Cn = torch.zeros((B, H, dh, dh + 1), device=device)
        return SSM._mlstm_steps, Cn, (rand(B, S, H, lo=0.5),
                                      rand(B, S, H, dh), rand(B, S, H, dh + 1),
                                      rand(B, S, H, dh))
    cn = torch.zeros((B, 2, d), device=device)
    return SSM._slstm_steps, cn, (rand(B, S, d, lo=0.5), rand(B, S, 2, d))


def scan_trace(cfg, device, B: int, S: int) -> dict:
    """Each kind of recurrent block's scan (``ssm._scan`` under grad, in
    chunks of ``SCAN_CHUNK``) traced alone at (B, S): the forward's and
    the forward-and-backward's device-busy ms, and the step's scan
    device ms reckoned as layers x (forward + forward-and-backward)."""
    if cfg.block == "mamba2":
        layers = {"mamba2": cfg.n_layers}
    else:
        groups = cfg.n_layers // cfg.slstm_every
        layers = {"mlstm": groups * (cfg.slstm_every - 1), "slstm": groups}
    out, total = {}, 0.0
    for kind, n in layers.items():
        steps, state, seqs = _scan_inputs(cfg, kind, B, S, device)

        def fwd():
            SSM._scan(steps, state, seqs)

        def fwd_bwd():
            h, y = SSM._scan(steps, state, seqs)
            torch.autograd.backward((h, y), (torch.ones_like(h),
                                             torch.ones_like(y)))

        fwd_bwd()                           # warm-up
        f = profile_phase(device, fwd, top=4)
        fb = profile_phase(device, fwd_bwd, top=6)
        out[kind] = {"layers": n, "forward": f, "forward_backward": fb}
        total += n * (f["device_busy_ms"] + fb["device_busy_ms"])
    out["scan_chunk"] = SSM.SCAN_CHUNK
    out["step_scan_device_ms"] = total
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=1,
                    help="data shards of the card (default: one device)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="train this many of the config's layers")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[args.arch]
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers, n_enc_layers=min(
            args.layers, cfg.n_enc_layers))
    out = profile(cfg, torch.device("cuda", 0), B,
                  WHISPER_S if cfg.enc_dec else S, args.shards)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
