"""Unified model API: build(cfg) -> Model with init / loss / prefill /
decode_step / make_cache / abstract_params / input_specs.

Port of ``repro.models.model`` for the decoder-only configs: dense, MoE
(deepseek-moe-16b, mixtral-8x7b), the zamba2 hybrid (``block="mamba2"``)
and xLSTM (``block="xlstm"``). Parameters are nested dicts of tensors,
name for name the reference's pytree, with the layers stacked ``[L, ...]``
(zamba2's and xLSTM's groups ``[n_super, inner, ...]``;
``convert.params_from_jax`` carries them across). Entry points that
create tensors (``init``, ``make_cache``) run on the card unless given
``device="cpu"``; the rest follow their inputs.

``prefill`` and ``decode_step`` update the cache they are given in place
and return it: a cache that went through either holds the new state, so a
caller that wants the old one keeps a clone. ``prefill`` fills the whole
cache ``make_cache`` gave (see ``transformer.decoder_prefill`` for where
that departs from the reference). A zamba2 or xLSTM cache holds the
recurrent states (fp32) beside zamba2's shared-attention K/V, as the
reference's ``make_cache`` lays them out; ``prefill`` writes every leaf.
``loss`` is the reference's, and differentiable: its attention runs
``FlashAttention`` under grad, and a MoE stack adds its auxiliary loss.
(zamba2 and xLSTM take the loss's value; ``launch.steps`` does not train
them yet.)
``abstract_params`` gives meta-device tensors (the reference's
``ShapeDtypeStruct``s) and ``input_specs`` ``(shape, dtype)`` pairs for
the text inputs; the VLM patch prefix and the audio frames are not ported
(ROADMAP A8).
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
        return _INIT[self.cfg.block](generator, self.cfg,
                                     self._device(device))

    def abstract_params(self) -> Params:
        """The parameters' shapes and dtypes as meta-device tensors (no
        storage, nothing drawn)."""
        return _INIT[self.cfg.block](None, self.cfg, torch.device("meta"))

    # ---------------------------------------------------------- forward ----
    def _trunk(self, params: Params, x, pos, state=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the normed hidden states, the MoE auxiliary loss summed over
        the layers, 0 for other stacks); ``state`` is a decode step's
        cache (the dense stack's ``(k, v)``, zamba2's and xLSTM's dict),
        updated in place."""
        cfg = self.cfg
        if cfg.block == "attn":
            return T.decoder_fwd(cfg, params, x, pos, state)
        h = _STACK[cfg.block](cfg, params, x, pos, state,
                              decode=state is not None)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    def _embed_inputs(self, params: Params, batch: Dict) -> Tuple:
        """Returns (x, pos)."""
        cfg = self.cfg
        if (cfg.family == "vlm" and "patches" in batch) or cfg.enc_dec:
            raise NotImplementedError(
                f"{cfg.name}: patch and audio-frame inputs are not ported "
                "(ROADMAP A8)")
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = L.embed(params["embed"], tokens)
        pos = _positions(B, x.shape[1], m_rope=cfg.m_rope, device=x.device)
        return x, pos

    # ------------------------------------------------------------- loss ----
    def loss(self, params: Params, batch: Dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy from fp32 logits, plus the
        z-loss ``1e-4 * mean(logsumexp^2)`` and ``1e-2 * aux``, the MoE
        auxiliary loss summed over the layers (0 for a dense stack).
        Returns (total, {"nll", "aux", "zloss"})."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params, batch)
        h, aux = self._trunk(params, x, pos)
        logits = L.unembed(params["embed"], cfg, h).float()
        labels = batch["labels"].to(logits.device, torch.long)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (logz - gold).mean()
        zloss = 1e-4 * logz.square().mean()
        total = nll + zloss + 1e-2 * aux
        return total, {"nll": nll, "aux": aux, "zloss": zloss}

    # ---------------------------------------------------------- serving ----
    def make_cache(self, B: int, ctx: int, device=None) -> Any:
        """The decode state sized for a context of ``ctx`` tokens: for
        attention stacks the zeroed K/V caches ``{"k", "v"}``, each ``[L,
        B, Tw, Hkv, dh]``; for zamba2 ``{"ssm", "ak", "av"[, "tail_ssm"]}``
        and for xLSTM ``{"mC", "mn", "sc", "sn"}``, the reference's
        leaves (the recurrent states in fp32, sLSTM's ``n`` at ones)."""
        cfg = self.cfg
        dev = self._device(device)
        dt = L._dtype(cfg)

        def f32(*shape, fill=0.0):
            return torch.full(shape, fill, dtype=torch.float32, device=dev)

        if cfg.block == "mamba2":
            inner = cfg.attn_every
            n_super, tail = T._groups(cfg, inner)
            H = 2 * cfg.d_model // cfg.ssm_headdim
            N, P = cfg.ssm_state, cfg.ssm_headdim
            Tw = min(ctx, T.ZAMBA_WINDOW)
            ak = torch.zeros((n_super, B, Tw, cfg.n_kv_heads, cfg.d_head),
                             dtype=dt, device=dev)
            st = {"ssm": f32(n_super, inner, B, H, N, P), "ak": ak,
                  "av": torch.zeros_like(ak)}
            if tail:
                st["tail_ssm"] = f32(tail, B, H, N, P)
            return st
        if cfg.block == "xlstm":
            inner = cfg.slstm_every - 1
            n_super, _ = T._groups(cfg, cfg.slstm_every)
            H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
            return {"mC": f32(n_super, inner, B, H, dh, dh),
                    "mn": f32(n_super, inner, B, H, dh),
                    "sc": f32(n_super, B, cfg.d_model),
                    "sn": f32(n_super, B, cfg.d_model, fill=1.0)}
        T._decoder_only(cfg)
        Tw = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        k = torch.zeros((cfg.n_layers, B, Tw, cfg.n_kv_heads, cfg.d_head),
                        dtype=dt, device=dev)
        return {"k": k, "v": torch.zeros_like(k)}

    def prefill(self, params: Params, batch: Dict, cache: Any
                ) -> Tuple[torch.Tensor, Any]:
        """Run the full prompt, return (last-token logits [B, 1, V] in
        fp32, the cache primed in place)."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params, batch)
        if cfg.block == "attn":
            h = T.decoder_prefill(cfg, params, x, pos,
                                  (cache["k"], cache["v"]))
        else:
            h = _STACK[cfg.block](cfg, params, x, pos, cache)
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
        state = (cache["k"], cache["v"]) if cfg.block == "attn" else cache
        h, _ = self._trunk(params, x, pos, state=state)
        return L.unembed(params["embed"], cfg, h).float(), cache

    # ------------------------------------------------------ input specs ----
    def input_specs(self, seq_len: int, global_batch: int,
                    mode: str = "train") -> Dict[str, Tuple]:
        """``(shape, dtype)`` stand-ins for the model's text inputs in
        ``mode`` ("train", "prefill" or "decode"). The reference's VLM
        ``patches`` and audio ``frames`` are not ported: an
        encoder-decoder config raises, and a VLM config gets its text
        inputs only."""
        T._decoder_only(self.cfg)
        B, S = global_batch, seq_len
        if mode == "train":
            return {"tokens": ((B, S), torch.int32),
                    "labels": ((B, S), torch.int32)}
        if mode == "prefill":
            return {"tokens": ((B, S), torch.int32)}
        if mode == "decode":
            return {"tokens": ((B, 1), torch.int32)}
        raise ValueError(f"input_specs: unknown mode {mode!r}")


_INIT = {"attn": T.decoder_init, "mamba2": T.zamba2_init,
         "xlstm": T.xlstm_init}
_STACK = {"mamba2": T.zamba2_fwd, "xlstm": T.xlstm_fwd}


def build(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
