"""Step builders: train_step, prefill_step and decode_step on one device
or over a mesh.

Port of ``repro.launch.steps.make_train_step`` and ``make_serve_steps``.
The steps run eagerly, with no ``jit``, so the reference's
``lower_train``/``lower_serve`` (which drive XLA) have no counterpart.
Given ``None`` or a device they run on that one device, as they always
have. Given a ``distributed.ctx.Mesh`` they run over it, each shard on its
own device (a device may repeat):

* a ``model`` axis of 1: data-parallel over the data axes (``pod`` x
  ``data``). Training by ``distributed.overlap.make_manual_dp_step`` (each
  shard's loss, one backward, the bucketed gradient sum, AdamW on every
  replica), serving by giving each shard its rows of the batch and of the
  cache. Params and optimizer state are replicated, one tree a data shard
  (``sharding.replicate``).
* a ``model`` axis larger than 1: tensor parallelism over it
  (``distributed.tensor_parallel``) within each data shard, for every
  stack (dense, VLM, MoE, zamba2, xLSTM, whisper). Params and optimizer
  state are trees of ``ShardedTensor`` placed by ``param_specs``
  (``shard_tree``; ``train_specs`` gives the reference's ``p_specs`` and
  ``o_specs``), and the steps return them placed the same way. Under
  ``REPRO_KV_SHARD=seq`` (the reference's sequence-sharded cache) each
  model shard holds every KV head of a share of the cache's slots, and a
  decode step joins the shards' partial softmaxes (``Group.join``).

The cache is a tree of ``ShardedTensor`` placed by ``cache_specs``
(``shard_cache``). A MoE layer routes each data shard's tokens alone: the
reference's grouped dispatch (``_moe_groups``) with G = the data-shard
count. A mesh with no devices (the production meshes) raises
``ValueError``. The serve steps run under ``torch.inference_mode()`` and
update the cache in place, as the reference's donated cache lets XLA do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..distributed import sharding as SH
from ..distributed import tensor_parallel as TP
from ..distributed.ctx import Mesh, batch_axes, mesh_context
from ..distributed.overlap import (dp_devices, gather_rows,
                                   make_manual_dp_step, split_batch)
from ..models.config import ModelConfig
from ..models.model import build
from ..optim import adamw


def _data_axes(mesh: Mesh):
    with mesh_context(mesh):
        return batch_axes()


def train_specs(cfg: ModelConfig, mesh: Mesh, p_shapes,
                compress_grads: bool = False):
    """The reference's ``(p_specs, o_specs)``: the params' specs, and the
    optimizer state's (the moments and residuals like the params, the
    step whole)."""
    p_specs = SH.param_specs(cfg, mesh, p_shapes)
    return p_specs, adamw.AdamWState(
        step=SH.P(), m=p_specs, v=p_specs,
        ef=p_specs if compress_grads else None)


def _optimizer(compress_grads: bool):
    """``apply(params, grads, opt) -> (params, opt, gnorm)``: the int8
    round trip with error feedback (when ``compress_grads`` and
    ``opt.ef`` is set), then one ``adamw.apply``."""
    def apply(params, grads, opt: adamw.AdamWState):
        if compress_grads and opt.ef is not None:
            q, s, ef = adamw.compress_grads(grads, opt.ef)
            grads = adamw.tree_map(adamw.dequantize_int8, q, s)
            opt = opt._replace(ef=ef)
        return adamw.apply(params, grads, opt)
    return apply


def make_train_step(cfg: ModelConfig, device=None,
                    compress_grads: bool = False):
    """Returns (model, train_step, p_shapes, opt_shapes).

    ``train_step(params, opt, batch) -> (params, opt, metrics)`` takes the
    gradient of ``model.loss`` by ``backward()`` over detached leaves,
    optionally sends it through the int8 round trip with error feedback
    (when ``compress_grads`` and ``opt.ef`` is set), and applies one
    ``adamw.apply``; ``metrics`` holds the loss's parts, ``loss`` and
    ``gnorm``. It returns new tensors and leaves ``params`` and ``opt`` as
    they are. A leaf the loss does not reach raises (every leaf of every
    stack gets a gradient). ``p_shapes`` and ``opt_shapes`` are
    meta-device tensors. Every config trains, as the reference's
    ``make_train_step`` takes ``value_and_grad`` of any model's loss:
    the dense, MoE and VLM decoders, zamba2 and xLSTM (their scans in
    checkpointed chunks, ``models/ssm.py``) and whisper (its batch holds
    ``frames`` beside the tokens).

    ``device`` is where it runs: None or a device, that one device (None:
    the card, raising without one; the step follows its inputs, and the
    device is where ``model.init`` puts them by default); a ``Mesh`` (the
    reference's ``mesh`` argument) with a ``model`` axis of 1, its data
    shards (``make_manual_dp_step``): ``params`` and ``opt`` are then
    lists of one replica a shard (``sharding.replicate``), the batch is
    split along B (replicated where the shards do not divide B: every
    shard then takes the full-batch gradient, and the mean gives it back),
    each metric is its mean over the shards, and the step
    returns the replicas, bit-equal; a ``Mesh`` with a larger ``model``
    axis, tensor-parallel within each data shard
    (``tensor_parallel.make_train_step``): ``params`` and ``opt`` are then
    trees of ``ShardedTensor`` placed by ``train_specs``, and so are the
    ones it returns. A VLM's ``patches`` and
    whisper's ``frames``, inputs and not parameters, go through the step
    as the tokens do."""
    apply = _optimizer(compress_grads)
    if isinstance(device, Mesh) and TP.model_size(device) > 1:
        model = build(cfg, TP.groups(device)[0].devices[0])
        train_step = TP.make_train_step(model.loss_tp, device,
                                        compress_grads)
    elif isinstance(device, Mesh):
        axes = _data_axes(device)
        model = build(cfg, dp_devices(device, axes)[0])
        train_step = make_manual_dp_step(model.loss, apply, device, axes)
    else:
        model = build(cfg, resolve_device(device))

        def train_step(params, opt: adamw.AdamWState, batch: Dict):
            leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
            loss, metrics = model.loss(leaves, batch)
            loss.backward()
            grads = adamw.tree_map(_grad, leaves)
            params, opt, gnorm = apply(params, grads, opt)
            metrics = {k: v.detach() for k, v in metrics.items()}
            return params, opt, dict(metrics, loss=loss.detach(),
                                     gnorm=gnorm)

    p_shapes = model.abstract_params()
    opt_shapes = adamw.init(p_shapes, compress=compress_grads)
    return model, train_step, p_shapes, opt_shapes


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    if leaf.grad is None:
        raise RuntimeError(f"a parameter leaf of shape {tuple(leaf.shape)} "
                           "got no gradient from the loss")
    return leaf.grad


def shard_cache(cfg: ModelConfig, mesh: Mesh, cache: Any) -> Any:
    """``cache`` (from ``model.make_cache`` for the whole batch) as a tree
    of ``ShardedTensor`` on ``mesh``, placed by ``cache_specs``: each data
    shard holds its rows."""
    return SH.shard_tree(cache, SH.to_named(
        mesh, SH.cache_specs(cfg, mesh, cache)))


def make_serve_steps(cfg: ModelConfig, device=None):
    """Returns (model, prefill_step, decode_step).

    ``prefill_step(params, batch, cache) -> (logits [B, 1, V], cache)`` runs
    the prompt ``batch["tokens"]`` (after a VLM's ``batch["patches"]``;
    over a whisper batch's ``batch["frames"]``) and primes the cache;
    ``decode_step(params, tokens [B, 1], cache, pos) -> (next [B, 1] int32,
    cache)`` takes one greedy step at position ``pos``.

    ``device`` is where they run: None or a device, that one device
    (None: the card, raising without one; the steps follow their inputs,
    and the device is where ``model.init`` and ``model.make_cache`` put
    theirs by default); a ``Mesh`` (the reference's ``mesh`` argument),
    its data shards: ``params`` is then a list of one replica a shard
    (``sharding.replicate``), or where the ``model`` axis is larger than 1
    a tree of ``ShardedTensor`` placed by ``param_specs`` (each data
    shard's model shards then run it tensor-parallel), and ``cache`` a
    tree of ``ShardedTensor`` (``shard_cache``); each data shard runs its
    rows of the batch on its block of the cache, and the whole logits and
    the tokens come back on shard 0's device in row order. A batch that
    the data shards do not divide is replicated (``split_batch``), as is
    its cache (``cache_specs``' guard): every shard runs the whole batch
    on its copy of the cache, and shard 0's logits and tokens come
    back."""
    if isinstance(device, Mesh) and TP.model_size(device) > 1:
        return _tp_serve_steps(cfg, device)
    if not isinstance(device, Mesh):
        model = build(cfg, resolve_device(device))

        @torch.inference_mode()
        def prefill_step(params, batch: Dict, cache: Any
                         ) -> Tuple[torch.Tensor, Any]:
            return model.prefill(params, batch, cache)

        @torch.inference_mode()
        def decode_step(params, tokens: torch.Tensor, cache: Any, pos: int
                        ) -> Tuple[torch.Tensor, Any]:
            logits, cache = model.decode_step(params, tokens, cache, pos)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return nxt[:, None], cache

        return model, prefill_step, decode_step

    devices = dp_devices(device, _data_axes(device))
    positions = SH.data_positions(device)
    model = build(cfg, devices[0])

    @torch.inference_mode()
    def dp_prefill(params, batch: Dict, cache: Any
                   ) -> Tuple[torch.Tensor, Any]:
        logits = [model.prefill(p, part, SH.blocks_at(cache, pos))[0]
                  for p, part, pos in zip(
                      params, split_batch(batch, devices), positions)]
        return gather_rows(logits, batch["tokens"].shape[0],
                           devices[0]), cache

    @torch.inference_mode()
    def dp_decode(params, tokens: torch.Tensor, cache: Any, pos: int
                  ) -> Tuple[torch.Tensor, Any]:
        out = []
        for p, part, at in zip(params, split_batch({"tokens": tokens},
                                                   devices), positions):
            logits, _ = model.decode_step(p, part["tokens"],
                                          SH.blocks_at(cache, at), pos)
            out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
        return gather_rows(out, tokens.shape[0], devices[0])[:, None], cache

    return model, dp_prefill, dp_decode


def _tp_serve_steps(cfg: ModelConfig, mesh: Mesh):
    """The serve steps over ``mesh``'s data shards, each tensor-parallel
    over its model shards; where ``cache_specs`` split the K/V cache's
    slots over the model axis, each shard group is told the ring's whole
    length (``Group.kv_slots``)."""
    rows, gs = TP.grid(mesh), TP.groups(mesh)
    heads = [g.devices[0] for g in gs]
    model = build(cfg, heads[0])

    def blocks(tree, row):
        return [SH.blocks_at(tree, p) for p in row]

    def group(g, cache):
        k = cache.get("k")
        if k is None or tuple(k.sharding.spec)[2] != "model":
            return g
        return TP.Group(g.devices, kv_slots=k.shape[2])

    @torch.inference_mode()
    def tp_prefill(params, batch: Dict, cache: Any
                   ) -> Tuple[torch.Tensor, Any]:
        out = [model.prefill_tp(group(g, cache), blocks(params, row),
                                part, blocks(cache, row))[0]
               for g, row, part in zip(gs, rows, split_batch(batch, heads))]
        return gather_rows(out, batch["tokens"].shape[0], heads[0]), cache

    @torch.inference_mode()
    def tp_decode(params, tokens: torch.Tensor, cache: Any, pos: int
                  ) -> Tuple[torch.Tensor, Any]:
        out = []
        for g, row, part in zip(gs, rows,
                                split_batch({"tokens": tokens}, heads)):
            logits, _ = model.decode_step_tp(group(g, cache),
                                             blocks(params, row),
                                             part["tokens"],
                                             blocks(cache, row), pos)
            out.append(torch.argmax(logits[:, -1], dim=-1).to(torch.int32))
        return gather_rows(out, tokens.shape[0], heads[0])[:, None], cache

    return model, tp_prefill, tp_decode
