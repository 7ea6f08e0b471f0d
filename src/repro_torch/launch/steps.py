"""Step builders: train_step, prefill_step and decode_step on one card.

Port of ``repro.launch.steps.make_train_step`` and ``make_serve_steps``.
There is no mesh, no sharding and no ``jit``: the steps run eagerly, so
the reference's parameter and optimizer specs (``p_specs``, ``o_specs``)
and its ``lower_train``/``lower_serve`` have no counterpart. The serve
steps run under ``torch.inference_mode()`` and update the cache in place,
as the reference's donated cache lets XLA do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import build
from ..optim import adamw


def make_train_step(cfg: ModelConfig, device=None,
                    compress_grads: bool = False):
    """Returns (model, train_step, p_shapes, opt_shapes).

    ``train_step(params, opt, batch) -> (params, opt, metrics)`` takes the
    gradient of ``model.loss`` by ``backward()`` over detached leaves,
    optionally sends it through the int8 round trip with error feedback
    (when ``compress_grads`` and ``opt.ef`` is set), and applies one
    ``adamw.apply``; ``metrics`` holds the loss's parts, ``loss`` and
    ``gnorm``. It returns new tensors and leaves ``params`` and ``opt`` as
    they are. A leaf the loss does not reach raises (every leaf of a dense
    or MoE decoder gets a gradient). ``p_shapes`` and ``opt_shapes`` are
    meta-device tensors. Raises unless ``device`` is given or a CUDA
    device is present (the step follows its inputs; ``device`` is where
    ``model.init`` puts them by default). zamba2, xLSTM and the
    encoder-decoder raise ``NotImplementedError``: they serve, and their
    training waits for ROADMAP A8.7 (zamba2, xLSTM) and A8.8 (whisper).
    A VLM's ``patches``, inputs and not parameters, go through the step
    as the tokens do."""
    if cfg.block in ("mamba2", "xlstm"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves the {cfg.block} stack but does not "
            "train it yet (ROADMAP A8.7)")
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the encoder-decoder stack but does "
            "not train it yet (ROADMAP A8.8)")
    model = build(cfg, resolve_device(device))
    p_shapes = model.abstract_params()
    opt_shapes = adamw.init(p_shapes, compress=compress_grads)

    def train_step(params, opt: adamw.AdamWState, batch: Dict):
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss, metrics = model.loss(leaves, batch)
        loss.backward()
        grads = adamw.tree_map(_grad, leaves)
        if compress_grads and opt.ef is not None:
            q, s, ef = adamw.compress_grads(grads, opt.ef)
            grads = adamw.tree_map(adamw.dequantize_int8, q, s)
            opt = opt._replace(ef=ef)
        params, opt, gnorm = adamw.apply(params, grads, opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt, dict(metrics, loss=loss.detach(), gnorm=gnorm)

    return model, train_step, p_shapes, opt_shapes


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    if leaf.grad is None:
        raise RuntimeError(f"a parameter leaf of shape {tuple(leaf.shape)} "
                           "got no gradient from the loss")
    return leaf.grad


def make_serve_steps(cfg: ModelConfig, device=None):
    """Returns (model, prefill_step, decode_step).

    ``prefill_step(params, batch, cache) -> (logits [B, 1, V], cache)`` runs
    the prompt ``batch["tokens"]`` (after a VLM's ``batch["patches"]``;
    over a whisper batch's ``batch["frames"]``) and primes the cache;
    ``decode_step(params, tokens [B, 1], cache, pos) -> (next [B, 1] int32,
    cache)`` takes one greedy step at position ``pos``. Raises unless
    ``device`` is given or a CUDA device is present (the steps follow
    their inputs; ``device`` is where ``model.init`` and
    ``model.make_cache`` put theirs by default)."""
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
