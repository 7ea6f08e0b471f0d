"""End-to-end training entry point over the devices given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --steps 200 --seq 128 --batch 8 [--devices cpu,cpu] \\
      [--model-parallel 2]

Port of ``repro.launch.train``: the same flags, plus ``--devices``, a
comma list that may repeat (every card unless given; the CPU only when
asked for: ``--devices cpu`` or ``--devices cpu,cpu``; ``--device X`` is
``--devices X``). The mesh is ``(n // model_parallel, model_parallel)``
over them, as the reference builds it from ``jax.devices()`` (a
``--model-parallel`` that does not divide n raises ``ValueError``), and
the step runs over it (``launch.steps``): data-parallel where the model
axis is 1 (each data shard its rows of the batch, the bucketed gradient
sum, AdamW on every replica), and tensor-parallel within each data shard
where it is larger (params and moments split by ``param_specs``), for
every stack. Checkpointing and deterministic resume are on:
checkpoints hold full logical arrays, gathered from the shards (taken
from replica 0 on a model axis of 1); the run resumes from the latest
committed checkpoint in ``--ckpt-dir`` onto this run's mesh, whatever the
mesh that saved it, and the token pipeline is counter-based, so the
resumed run sees the batches an uninterrupted run would.
``--compress-grads`` sends the gradient through the int8 round trip with
error feedback. Dense, MoE, zamba2 and xLSTM archs train on any mesh
(``--arch mixtral-8x7b --smoke --devices cpu``; MoE routes each data
shard's tokens alone; ``--arch zamba2-7b`` or ``--arch xlstm-125m`` run
their scans in checkpointed chunks; ``--arch zamba2-7b --smoke
--model-parallel 2 --devices cpu,cpu,cpu,cpu`` splits its Mamba2 heads
over two model shards). whisper trains
through ``launch.steps.make_train_step`` on batches that hold its
``frames``; the token pipeline gives none, so ``--arch whisper-medium``
raises ``ValueError`` naming them (the reference's CLI fails on the same
missing input).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, SMOKE
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed import sharding as SH
from ..launch.mesh import make_host_mesh
from ..launch.steps import make_train_step, train_specs
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

    if args.device is not None and args.devices is not None:
        raise ValueError("give --devices or --device, not both")
    devices = args.devices.split(",") if args.devices else None
    if args.device is not None:
        devices = [args.device]
    cfg = (SMOKE if args.smoke else ARCHS)[args.arch]
    if cfg.enc_dec:
        raise ValueError(
            f"{cfg.name} trains on 'frames' [B, {cfg.n_frames}, "
            f"{cfg.d_model}] beside its tokens; the token pipeline gives "
            "tokens and labels only (train it through "
            "launch.steps.make_train_step with a batch that holds frames)")
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
    # on this run's mesh: the parameter specs, the moments like them
    p_specs, o_specs = train_specs(cfg, mesh, p_shapes, args.compress_grads)
    named = SH.to_named(mesh, {"params": p_specs, "opt": o_specs})
    if mgr.latest_step() is not None:
        start, state = mgr.restore_tree({"params": params, "opt": opt},
                                        shardings=named)
        print(f"resumed from step {start}")
    else:
        state = SH.shard_tree({"params": params, "opt": opt}, named)
    del params, opt
    if args.model_parallel == 1:      # one replica a data shard
        shards = SH.data_shards(state, mesh)
        params_r = [s["params"] for s in shards]
        opt_r = [s["opt"] for s in shards]
    else:
        params_r, opt_r = state["params"], state["opt"]
    del state

    def saved():
        if args.model_parallel == 1:
            return {"params": params_r[0], "opt": opt_r[0]}
        return {"params": params_r, "opt": opt_r}

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
            mgr.save(i + 1, saved())
    mgr.save(args.steps, saved(), blocking=True)
    print("done")


if __name__ == "__main__":
    main()
