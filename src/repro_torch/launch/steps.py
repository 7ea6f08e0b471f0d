"""Serving step builders: prefill_step / decode_step on one card.

Port of ``repro.launch.steps.make_serve_steps``. There is no mesh, no
sharding and no ``jit``: the steps run eagerly under
``torch.inference_mode()``. Both update the cache in place, as the
reference's donated cache lets XLA do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import build


def make_serve_steps(cfg: ModelConfig, device=None):
    """Returns (model, prefill_step, decode_step).

    ``prefill_step(params, batch, cache) -> (logits [B, 1, V], cache)`` runs
    the prompt ``batch["tokens"]`` and primes the cache;
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
