"""Unified serving API: build(cfg) -> Model with init / make_cache / prefill /
decode_step.

Port of ``repro.models.model`` for dense decoder-only configs. Parameters
are nested dicts of tensors, name for name the reference's pytree, with the
layers stacked ``[L, ...]`` (``convert.params_from_jax`` carries them
across). Entry points that create tensors (``init``, ``make_cache``) run on
the card unless given ``device="cpu"``; the rest follow their inputs.

``prefill`` and ``decode_step`` update the cache they are given in place
and return it: a cache that went through either holds the new state, so a
caller that wants the old one keeps a clone. ``prefill`` fills the whole
cache ``make_cache`` gave (see ``transformer.decoder_prefill`` for where
that departs from the reference). ``loss``, ``abstract_params`` and
``input_specs`` belong to the training slice (ROADMAP A7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig

Params = Dict[str, Any]


def _positions(B: int, S: int, offset=0, m_rope: bool = False,
               device=None) -> torch.Tensor:
    pos = torch.arange(S, device=device)[None, :] + offset
    pos = pos.expand(B, S)
    if m_rope:
        return torch.stack([pos, pos, pos], 0)  # text-only: 3 equal sections
    return pos


def _decode_pos(B: int, pos_scalar: int, m_rope: bool = False,
                device=None) -> torch.Tensor:
    pos = torch.full((B, 1), int(pos_scalar), dtype=torch.long,
                     device=device)
    if m_rope:
        return torch.stack([pos, pos, pos], 0)
    return pos


@dataclass
class Model:
    cfg: ModelConfig
    # where ``init`` and ``make_cache`` put their tensors when not told
    device: Optional[torch.device] = None

    def _device(self, device) -> torch.device:
        return resolve_device(self.device if device is None else device)

    # ------------------------------------------------------------- init ----
    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random parameters drawn from ``generator`` (on its own device),
        placed on ``device``: the model's, else the card."""
        return T.decoder_init(generator, self.cfg, self._device(device))

    # ---------------------------------------------------------- forward ----
    def _trunk(self, params: Params, x, pos, state=None) -> torch.Tensor:
        """The normed hidden states; ``state`` is a decode step's
        ``(k, v)`` caches, updated in place."""
        return T.decoder_fwd(self.cfg, params, x, pos, state)

    def _embed_inputs(self, params: Params, batch: Dict) -> Tuple:
        """Returns (x, pos)."""
        cfg = self.cfg
        if (cfg.family == "vlm" and "patches" in batch) or cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: patch and audio-frame inputs are not ported "
                "(ROADMAP A7)")
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed(params["embed"], tokens)
        pos = _positions(B, x.shape[1], m_rope=cfg.m_rope, device=x.device)
        return x, pos

    # ---------------------------------------------------------- serving ----
    def make_cache(self, B: int, ctx: int, device=None) -> Any:
        """Zeroed K/V caches sized for a context of ``ctx`` tokens:
        ``{"k", "v"}``, each ``[L, B, Tw, Hkv, dh]``."""
        cfg = self.cfg
        T._dense_only(cfg)
        Tw = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        k = torch.zeros((cfg.n_layers, B, Tw, cfg.n_kv_heads, cfg.d_head),
                        dtype=L._dtype(cfg), device=self._device(device))
        return {"k": k, "v": torch.zeros_like(k)}

    def prefill(self, params: Params, batch: Dict, cache: Any
                ) -> Tuple[torch.Tensor, Any]:
        """Run the full prompt, return (last-token logits [B, 1, V] in
        fp32, the cache primed in place)."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params, batch)
        h = T.decoder_prefill(cfg, params, x, pos, (cache["k"], cache["v"]))
        logits = L.unembed(params["embed"], cfg, h[:, -1:]).float()
        return logits, cache

    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Any,
                    pos_scalar: int) -> Tuple[torch.Tensor, Any]:
        """tokens: [B, 1] at position ``pos_scalar`` -> (logits [B,1,V] in
        fp32, the cache updated in place)."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = L.embed(params["embed"], tokens)
        pos = _decode_pos(B, pos_scalar, cfg.m_rope, device=x.device)
        h = self._trunk(params, x, pos, state=(cache["k"], cache["v"]))
        return L.unembed(params["embed"], cfg, h).float(), cache


def build(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
