"""End-to-end training entry point, data-parallel over the devices given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 200 --seq 128 --batch 8 [--devices cpu,cpu]

Port of ``repro.launch.train``: the same flags, plus ``--devices``, a
comma list that may repeat (every card unless given; the CPU only when
asked for: ``--devices cpu`` or ``--devices cpu,cpu``; ``--device X`` is
``--devices X``). The mesh is ``(n // model_parallel, model_parallel)``
over them, as the reference builds it from ``jax.devices()``, and the
step runs data-parallel over its data axis (``launch.steps``: each shard
its rows of the batch, the bucketed gradient sum, AdamW on every
replica). ``--model-parallel`` other than 1 raises ``NotImplementedError``:
tensor parallelism is ROADMAP A8.5b. Checkpointing and deterministic
resume are on: checkpoints hold full logical arrays, taken from replica
0; the run resumes from the latest committed checkpoint in
``--ckpt-dir`` onto this run's mesh, whatever the mesh that saved it,
and the token pipeline is counter-based, so the resumed run sees the
batches an uninterrupted run would. ``--compress-grads`` sends the
gradient through the int8 round trip with error feedback. Dense and MoE
archs train (``--arch mixtral-8x7b --smoke --devices cpu``; MoE routes
each shard's tokens alone). zamba2, xLSTM and whisper serve
(``launch.steps.make_serve_steps``) but do not train yet (ROADMAP A8.7,
A8.8): these raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, SMOKE
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed import sharding as SH
from ..launch.mesh import make_host_mesh
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
    ap.add_argument("--devices", default=None,
                    help="comma list of torch devices, which may repeat "
                         "(default: every card)")
    ap.add_argument("--device", default=None,
                    help="one torch device: --devices with one entry")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: tensor parallelism "
            "over the 'model' axis is ROADMAP A8.5b; the port trains "
            "data-parallel only (--model-parallel 1)")
    if args.device is not None and args.devices is not None:
        raise ValueError("give --devices or --device, not both")
    devices = args.devices.split(",") if args.devices else None
    if args.device is not None:
        devices = [args.device]
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    mesh = make_host_mesh(args.model_parallel, devices)
    print(f"arch={cfg.name} mesh={dict(mesh.shape)} "
          f"devices={[str(d) for d in mesh.devices.flat]}")

    model, step, p_shapes, _ = make_train_step(
        cfg, mesh, compress_grads=args.compress_grads)
    first = mesh.devices.flat[0]
    params = model.init(torch.Generator(device=first).manual_seed(0))
    opt = adamw.init(params, compress=args.compress_grads)
    n_params = sum(x.numel() for x in adamw.leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")

    mgr = CheckpointManager(args.ckpt_dir)
    start = 0
    if mgr.latest_step() is not None:
        # onto this run's mesh: the parameter specs, the moments like them
        p_specs = SH.param_specs(cfg, mesh, p_shapes)
        o_specs = adamw.AdamWState(
            step=SH.P(), m=p_specs, v=p_specs,
            ef=p_specs if args.compress_grads else None)
        start, restored = mgr.restore_tree(
            {"params": params, "opt": opt},
            shardings=SH.to_named(mesh, {"params": p_specs, "opt": o_specs}))
        shards = SH.data_shards(restored, mesh)
        print(f"resumed from step {start}")
        params_r = [s["params"] for s in shards]
        opt_r = [s["opt"] for s in shards]
    else:
        params_r, opt_r = (SH.replicate(params, mesh),
                           SH.replicate(opt, mesh))
    del params, opt

    pipe = TokenPipeline(PipelineConfig(cfg.vocab, args.seq, args.batch))
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        params_r, opt_r, metrics = step(params_r, opt_r, batch)
        if (i + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = (time.time() - t0) / args.log_every
            tok_s = args.seq * args.batch / dt
            print(f"step {i + 1:5d} loss {loss:.4f} "
                  f"{dt * 1e3:.0f} ms/step {tok_s:.0f} tok/s", flush=True)
            t0 = time.time()
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": params_r[0], "opt": opt_r[0]})
    mgr.save(args.steps, {"params": params_r[0], "opt": opt_r[0]},
             blocking=True)
    print("done")


if __name__ == "__main__":
    main()
