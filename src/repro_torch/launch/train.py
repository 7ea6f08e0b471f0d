"""End-to-end training entry point on one card (or the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 200 --seq 128 --batch 8 [--device cpu]

Port of ``repro.launch.train``: the same flags, plus ``--device`` (the
card unless given; the CPU only when asked for). Checkpointing and
deterministic resume are on: the run resumes from the latest committed
checkpoint in ``--ckpt-dir``, and the token pipeline is counter-based, so
the resumed run sees the batches an uninterrupted run would.
``--compress-grads`` sends the gradient through the int8 round trip with
error feedback. There is no mesh: ``--model-parallel`` other than 1
raises. Dense and MoE archs train (``--arch mixtral-8x7b --smoke
--device cpu``). zamba2, xLSTM and whisper serve
(``launch.steps.make_serve_steps``) but do not train yet (ROADMAP A8.7,
A8.8): these raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, SMOKE
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..device import resolve_device
from ..launch.steps import make_train_step
from ..optim import adamw
from ..runtime.checkpoint import CheckpointManager


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise ValueError("--model-parallel: the port runs on one device, "
                         f"so only 1 is taken, got {args.model_parallel}")
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    device = resolve_device(args.device)
    print(f"arch={cfg.name} device={device}")

    model, step, _, _ = make_train_step(cfg, device,
                                        compress_grads=args.compress_grads)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen)
    opt = adamw.init(params, compress=args.compress_grads)
    n_params = sum(x.numel() for x in adamw.leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")

    mgr = CheckpointManager(args.ckpt_dir)
    start = 0
    if mgr.latest_step() is not None:
        start, restored = mgr.restore_tree({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"resumed from step {start}")

    pipe = TokenPipeline(PipelineConfig(cfg.vocab, args.seq, args.batch))
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(i).items()}
        params, opt, metrics = step(params, opt, batch)
        if (i + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = (time.time() - t0) / args.log_every
            tok_s = args.seq * args.batch / dt
            print(f"step {i + 1:5d} loss {loss:.4f} "
                  f"{dt * 1e3:.0f} ms/step {tok_s:.0f} tok/s", flush=True)
            t0 = time.time()
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": params, "opt": opt})
    mgr.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print("done")


if __name__ == "__main__":
    main()
