"""Unified model API: build(cfg) -> Model with init / loss / prefill /
decode_step / make_cache / abstract_params / input_specs.

Port of ``repro.models.model`` for every config: dense, MoE
(deepseek-moe-16b, mixtral-8x7b), the zamba2 hybrid (``block="mamba2"``),
xLSTM (``block="xlstm"``), the whisper encoder-decoder (``enc_dec``) and
qwen2-vl's patch prefix. Parameters are nested dicts of tensors, name for
name the reference's pytree, with the layers stacked ``[L, ...]``
(zamba2's and xLSTM's groups ``[n_super, inner, ...]``; whisper's
``enc_layers`` and ``dec_layers``; ``convert.params_from_jax`` carries
them across). Entry points that create tensors (``init``, ``make_cache``)
run on the card unless given ``device="cpu"``; the rest follow their
inputs.

``prefill`` and ``decode_step`` update the cache they are given in place
and return it: a cache that went through either holds the new state, so a
caller that wants the old one keeps a clone. ``prefill`` fills the whole
cache ``make_cache`` gave (see ``transformer.decoder_prefill`` for where
that departs from the reference). A zamba2 or xLSTM cache holds the
recurrent states (fp32) beside zamba2's shared-attention K/V, as the
reference's ``make_cache`` lays them out; ``prefill`` writes every leaf.
An encoder-decoder cache also holds the encoder's output ``enc_out``,
which ``prefill`` writes and every decode step's cross-attention reads.
``loss`` is the reference's, and differentiable for every stack: its
attention runs ``FlashAttention`` under grad, its layers and scans run
checkpointed (``transformer.py``, ``ssm.py``), and a MoE stack adds its
auxiliary loss.

The stubbed frontends are the reference's: a VLM batch's ``patches``
``[B, P, d]`` (precomputed patch embeddings) go before the token
embeddings, the positions run over all ``P + S``, and the loss drops the
first P positions; a whisper batch's ``frames`` ``[B, n_frames, d]``
(precomputed frame embeddings) get a sinusoid (``_sinusoid``) and go
through the encoder.
``loss_tp``, ``prefill_tp`` and ``decode_step_tp`` are ``loss``,
``prefill`` and ``decode_step`` of every stack over one data shard's
model shards (``distributed/tensor_parallel.py``), dispatched on the
stack as those are.
``abstract_params`` gives meta-device tensors (the reference's
``ShapeDtypeStruct``s) and ``input_specs`` ``(shape, dtype)`` pairs for
every input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
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
    def init(self, generator: torch.Generator, device=None,
             into: L.Whole = L.WHOLE) -> Params:
        """Random parameters drawn from ``generator`` (on its own device),
        placed on ``device``: the model's, else the card; each stack and
        each leaf outside one put ``into`` its place as it is drawn
        (``distributed.sharding.init_sharded`` puts them into their
        blocks on a mesh)."""
        return _init(self.cfg)(generator, self.cfg, self._device(device),
                               into)

    def abstract_params(self) -> Params:
        """The parameters' shapes and dtypes as meta-device tensors (no
        storage, nothing drawn)."""
        return _init(self.cfg)(None, self.cfg, torch.device("meta"))

    # ---------------------------------------------------------- forward ----
    def _trunk(self, params: Params, x, pos, state=None, enc_out=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the normed hidden states, the MoE auxiliary loss summed over
        the layers, 0 for other stacks); ``state`` is a decode step's
        cache (the attention stacks' ``(k, v)``, zamba2's and xLSTM's
        dict), updated in place; ``enc_out`` the encoder's output, which
        the encoder-decoder's cross-attention reads."""
        cfg = self.cfg
        if cfg.enc_dec:
            h = T.encdec_fwd(cfg, params, x, pos, enc_out, state)
        elif cfg.block == "attn":
            return T.decoder_fwd(cfg, params, x, pos, state)
        else:
            h = _STACK[cfg.block](cfg, params, x, pos, state,
                                  decode=state is not None)
        return h, torch.zeros((), dtype=torch.float32, device=x.device)

    def _embed_inputs(self, params: Params, batch: Dict) -> Tuple:
        """Returns (x, pos, enc_out, label_offset): a VLM batch's
        ``patches`` go before the tokens (offset by their count), a
        whisper batch's ``frames`` through the encoder (``enc_out``;
        None otherwise)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = L.embed(params["embed"], tokens)
        enc_out = None
        offset = 0
        if cfg.family == "vlm" and "patches" in batch:
            # stubbed vision frontend: precomputed patch embeddings prefix
            patches = batch["patches"].to(x.device, x.dtype)
            x = torch.cat([patches, x], 1)
            offset = patches.shape[1]
        if cfg.enc_dec:
            frames = batch["frames"].to(x.device, x.dtype)
            pe = _sinusoid(frames.shape[1], cfg.d_model, x.dtype, x.device)
            enc_out = T.encoder_fwd(cfg, params, frames + pe)
        pos = _positions(B, x.shape[1], m_rope=cfg.m_rope, device=x.device)
        return x, pos, enc_out, offset

    # ------------------------------------------------------------- loss ----
    def loss(self, params: Params, batch: Dict
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross-entropy from fp32 logits, plus the
        z-loss ``1e-4 * mean(logsumexp^2)`` and ``1e-2 * aux``, the MoE
        auxiliary loss summed over the layers (0 for a dense stack), over
        the token positions (a VLM's patch positions have no label).
        Returns (total, {"nll", "aux", "zloss"})."""
        cfg = self.cfg
        x, pos, enc_out, offset = self._embed_inputs(params, batch)
        h, aux = self._trunk(params, x, pos, enc_out=enc_out)
        if offset:
            h = h[:, offset:]
        logits = L.unembed(params["embed"], cfg, h).float()
        labels = batch["labels"].to(logits.device, torch.long)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        return _total(logz, gold, aux)

    # ---------------------------------------------------------- serving ----
    def make_cache(self, B: int, ctx: int, device=None) -> Any:
        """The decode state sized for a context of ``ctx`` tokens: for
        attention stacks the zeroed K/V caches ``{"k", "v"}``, each ``[L,
        B, Tw, Hkv, dh]`` (an encoder-decoder's beside ``enc_out``,
        ``[B, n_frames, d]``); for zamba2 ``{"ssm", "ak", "av"[, "tail_ssm"]}``
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
        Tw = min(ctx, cfg.swa_window) if cfg.swa_window else ctx
        k = torch.zeros((cfg.n_layers, B, Tw, cfg.n_kv_heads, cfg.d_head),
                        dtype=dt, device=dev)
        if cfg.enc_dec:
            return {"k": k, "v": torch.zeros_like(k), "enc_out": torch.zeros(
                (B, cfg.n_frames, cfg.d_model), dtype=dt, device=dev)}
        return {"k": k, "v": torch.zeros_like(k)}

    def prefill(self, params: Params, batch: Dict, cache: Any
                ) -> Tuple[torch.Tensor, Any]:
        """Run the full prompt, return (last-token logits [B, 1, V] in
        fp32, the cache primed in place). An encoder-decoder's
        ``enc_out`` goes into the cache's, which must have the batch's
        frame count (``ValueError`` otherwise)."""
        cfg = self.cfg
        x, pos, enc_out, _ = self._embed_inputs(params, batch)
        if cfg.enc_dec:
            if enc_out.shape != cache["enc_out"].shape:
                raise ValueError(
                    f"{cfg.name}: the batch's encoder output "
                    f"{tuple(enc_out.shape)} does not fit the cache's "
                    f"enc_out {tuple(cache['enc_out'].shape)}")
            cache["enc_out"].copy_(enc_out)
            h = T.encdec_prefill(cfg, params, x, pos, cache["enc_out"],
                                 (cache["k"], cache["v"]))
        elif cfg.block == "attn":
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
        h, _ = self._trunk(params, x, pos, state=state,
                           enc_out=cache.get("enc_out"))
        return L.unembed(params["embed"], cfg, h).float(), cache

    # -------------------------------------------------- tensor parallel ----
    # Every stack over one data shard's model shards: ``tp`` a
    # ``distributed.tensor_parallel.Group``, ``ps`` each shard's blocks of
    # the parameters (placed by ``sharding.param_specs``), ``caches`` each
    # shard's blocks of the cache (placed by ``cache_specs``), ``slots``
    # the K/V cache's whole length (a block of a sequence-split cache holds
    # a share of it); inputs on shard 0's device. They compute what
    # ``loss``, ``prefill`` and ``decode_step`` compute, up to the order of
    # the cross-shard sums.
    def _embed_inputs_tp(self, tp, ps, batch: Dict):
        """Each shard's (x, pos), each shard's whole encoder output (a
        whisper batch's ``frames`` through ``tp_encoder_fwd``; else None)
        and the label offset (a VLM's patch count)."""
        cfg = self.cfg
        xs = tp.reduce(*L.tp_embed([p["embed"] for p in ps], cfg,
                                   tp.copy(batch["tokens"])))
        offset = 0
        if cfg.family == "vlm" and "patches" in batch:
            offset = batch["patches"].shape[1]
            xs = [torch.cat([batch["patches"].to(x.device, x.dtype), x], 1)
                  for x in xs]
        encs = None
        if cfg.enc_dec:
            frames = [f.to(x.dtype) + _sinusoid(f.shape[1], cfg.d_model,
                                                x.dtype, x.device)
                      for f, x in zip(tp.copy(batch["frames"]), xs)]
            encs = T.tp_encoder_fwd(cfg, tp, ps, frames)
        B, S = xs[0].shape[:2]
        pos = [_positions(B, S, m_rope=cfg.m_rope, device=x.device)
               for x in xs]
        return xs, pos, encs, offset

    def _trunk_tp(self, tp, ps, xs, pos, caches=None, encs=None):
        """``_trunk`` over the model shards: (each shard's normed hidden
        states, the MoE auxiliary loss on shard 0's device); ``caches``
        each shard's ``(k, v)`` blocks (zamba2's and xLSTM's dicts) of a
        decode step, updated in place."""
        cfg = self.cfg
        if cfg.enc_dec:
            hs = T.tp_encdec_fwd(cfg, tp, ps, xs, pos, encs, caches)
        elif cfg.block == "attn":
            return T.tp_decoder_fwd(cfg, tp, ps, xs, pos, caches)
        else:
            hs = _TP_STACK[cfg.block](cfg, tp, ps, xs, pos, caches,
                                      decode=caches is not None)
        return hs, torch.zeros((), dtype=torch.float32, device=xs[0].device)

    def _vocab_split(self, ps) -> bool:
        e = ps[0]["embed"]
        n = e["tok"].shape[0] if self.cfg.tie_embeddings else \
            e["out"].shape[-1]
        return n < self.cfg.vocab

    def _logits_tp(self, tp, ps, hs) -> torch.Tensor:
        """The whole fp32 logits on shard 0's device: the shards' vocab
        blocks joined, or shard 0's own where the vocab is whole."""
        cfg = self.cfg
        if not self._vocab_split(ps):
            return L.unembed(ps[0]["embed"], cfg, hs[0]).float()
        return torch.cat([L.unembed(p["embed"], cfg, h).float().to(
            tp.devices[0]) for p, h in zip(ps, hs)], -1)

    def loss_tp(self, tp, ps, batch: Dict
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``loss`` over the model shards, on shard 0's device. Over a
        split vocab the whole fp32 logits are never formed: the
        logsumexp joins each shard's max and sum of exponentials, and the
        gold logit comes from the shard that holds the label."""
        cfg = self.cfg
        xs, pos, encs, offset = self._embed_inputs_tp(tp, ps, batch)
        hs, aux = self._trunk_tp(tp, ps, xs, pos, encs=encs)
        if offset:
            hs = [h[:, offset:] for h in hs]
        labels = batch["labels"]
        if not self._vocab_split(ps):
            logits = L.unembed(ps[0]["embed"], cfg, hs[0]).float()
            labels = labels.to(logits.device, torch.long)
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None])[..., 0]
            return _total(logz, gold, aux)
        logits = [L.unembed(p["embed"], cfg, h).float()
                  for p, h in zip(ps, hs)]
        n = logits[0].shape[-1]
        mx = torch.stack([lg.detach().amax(-1).to(tp.devices[0])
                          for lg in logits]).amax(0)
        sums, gold = [], []
        for m, (lg, mxm) in enumerate(zip(logits, tp.copy(mx))):
            sums.append(torch.exp(lg - mxm[..., None]).sum(-1))
            t = labels.to(lg.device, torch.long) - m * n
            g = torch.gather(lg, -1, t.clamp(0, n - 1)[..., None])[..., 0]
            gold.append(torch.where((t >= 0) & (t < n), g, g.new_zeros(())))
        logz = mx + torch.log(tp.total(sums))
        return _total(logz, tp.total(gold), aux)

    def prefill_tp(self, tp, ps, batch: Dict, caches) -> Tuple:
        """``prefill`` over the model shards -> (the whole last-token
        logits ``[B, 1, V]`` on shard 0's device, caches). An
        encoder-decoder's shards each write their block of ``enc_out``
        (``ValueError`` where the batch's frames do not fit it)."""
        cfg = self.cfg
        xs, pos, encs, _ = self._embed_inputs_tp(tp, ps, batch)
        if cfg.enc_dec:
            for m, (e, c) in enumerate(zip(encs, caches)):
                blk = c["enc_out"]
                lo, hi = L.block_cols(blk.shape[-1], cfg.d_model, m)
                if e.shape[:-1] != blk.shape[:-1]:
                    raise ValueError(
                        f"{cfg.name}: the batch's encoder output "
                        f"{tuple(e.shape)} does not fit the cache's enc_out "
                        f"block {tuple(blk.shape)}")
                blk.copy_(L._cols(e, lo, hi))
            hs = T.tp_encdec_prefill(cfg, tp, ps, xs, pos, encs,
                                     [(c["k"], c["v"]) for c in caches])
        elif cfg.block == "attn":
            hs = T.tp_decoder_prefill(cfg, tp, ps, xs, pos,
                                      [(c["k"], c["v"]) for c in caches])
        else:
            hs = _TP_STACK[cfg.block](cfg, tp, ps, xs, pos, caches)
        return self._logits_tp(tp, ps, [h[:, -1:] for h in hs]), caches

    def decode_step_tp(self, tp, ps, tokens: torch.Tensor, caches,
                       pos_scalar: int) -> Tuple:
        """``decode_step`` over the model shards -> (the whole logits
        ``[B, 1, V]`` on shard 0's device, caches updated in place). An
        encoder-decoder's ``enc_out`` blocks are gathered once a step."""
        cfg = self.cfg
        xs = tp.reduce(*L.tp_embed([p["embed"] for p in ps], cfg,
                                   tp.copy(tokens)))
        pos = [_decode_pos(tokens.shape[0], pos_scalar, cfg.m_rope,
                           device=x.device) for x in xs]
        encs = None
        if cfg.enc_dec:
            blocks = [c["enc_out"] for c in caches]
            encs = blocks if blocks[0].shape[-1] == cfg.d_model else \
                tp.gather(blocks)
        state = [(c["k"], c["v"]) for c in caches] if cfg.block == "attn" \
            else caches
        hs, _ = self._trunk_tp(tp, ps, xs, pos, state, encs)
        return self._logits_tp(tp, ps, hs), caches

    # ------------------------------------------------------ input specs ----
    def input_specs(self, seq_len: int, global_batch: int,
                    mode: str = "train") -> Dict[str, Tuple]:
        """``(shape, dtype)`` stand-ins for the model's inputs in ``mode``
        ("train", "prefill" or "decode"): the tokens (and labels), and in
        train and prefill modes a VLM's ``patches`` ``(B, 256, d)`` and an
        encoder-decoder's ``frames`` ``(B, n_frames, d)``."""
        cfg = self.cfg
        B, S = global_batch, seq_len
        toks = ((B, S), torch.int32)
        if mode == "train":
            specs = {"tokens": toks, "labels": toks}
        elif mode == "prefill":
            specs = {"tokens": toks}
        elif mode == "decode":
            specs = {"tokens": ((B, 1), torch.int32)}
        else:
            raise ValueError(f"input_specs: unknown mode {mode!r}")
        dt = L._dtype(cfg)
        if cfg.family == "vlm" and mode in ("train", "prefill"):
            specs["patches"] = ((B, 256, cfg.d_model), dt)
        if cfg.enc_dec and mode in ("train", "prefill"):
            specs["frames"] = ((B, cfg.n_frames, cfg.d_model), dt)
        return specs


def _total(logz: torch.Tensor, gold: torch.Tensor, aux: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss from each position's logsumexp and gold logit: the mean
    nll, the z-loss ``1e-4 * mean(logz^2)`` and ``1e-2 * aux``."""
    nll = (logz - gold).mean()
    zloss = 1e-4 * logz.square().mean()
    total = nll + zloss + 1e-2 * aux
    return total, {"nll": nll, "aux": aux, "zloss": zloss}


def _sinusoid(S: int, d: int, dtype: torch.dtype, device=None
              ) -> torch.Tensor:
    """[1, S, d]: the sines and then the cosines of position over
    ``10000 ** (2 i / d)``, computed in float64 as the reference's numpy
    code does, rounded to float32 and from there to ``dtype`` (as
    ``jnp.asarray`` rounds a float64 array)."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    pe = np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)
    return torch.from_numpy(pe[None]).to(device, dtype)


_INIT = {"attn": T.decoder_init, "mamba2": T.zamba2_init,
         "xlstm": T.xlstm_init}


def _init(cfg: ModelConfig):
    return T.encdec_init if cfg.enc_dec else _INIT[cfg.block]
_STACK = {"mamba2": T.zamba2_fwd, "xlstm": T.xlstm_fwd}
_TP_STACK = {"mamba2": T.tp_zamba2_fwd, "xlstm": T.tp_xlstm_fwd}


def build(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
