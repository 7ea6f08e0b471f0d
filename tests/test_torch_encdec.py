"""The port's whisper encoder-decoder (``models/transformer.py``
``encdec_init``, ``encoder_fwd``, ``encdec_fwd``, ``encdec_prefill``) and
the stubbed frontends of ``models/model.py`` (whisper's ``frames`` with
``_sinusoid``, qwen2-vl's ``patches`` prefix) against the reference
package on the SMOKE configs.

Both packages get the same parameters (the reference's ``init``, carried
across by ``convert.params_from_jax``, with every norm scale and bias
perturbed so that their initial ones and zeros hide no missing term) and
the same tokens, frames and patches from a numpy seed (frames and patches
scaled by 0.02, as ``tests/test_models.py`` makes them). The reference
has no Pallas kernel on these paths (its attention is ``_sdpa``); it runs
on the CPU through ``jax.jit``. The port's flash attention runs its plain
version (``flash_ref``) on CPU tensors.

Tolerances: float32 within rtol = atol = 1e-4 (``test_torch_models``'s),
the loss's parts within 1e-5. ``_sinusoid`` bit for bit. bfloat16: the
encoder alone within ``2e-2 * max |ref|`` (``test_torch_models``'s
``Case.close``); the whole stack, through prefill and decode, as close to
the float32 reference as the reference's own bf16 is (``test_torch_ssm``'s
rule): ``max |port - ref32| <= 2 * max |ref16 - ref32| + 2e-2 * max
|ref32|``.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as RT
from repro.configs import SMOKE as REF_SMOKE
from repro.models import layers as RL
from repro.models.model import _sinusoid as ref_sinusoid
from repro.models.model import build as ref_build
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch.steps import make_serve_steps, make_train_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import _sinusoid, build
from repro_torch.optim import adamw

WHISPER, VLM = "whisper-medium", "qwen2-vl-72b"
B, S, P = 2, 12, 4           # batch, prompt, patches (tests/test_models.py)


def perturb(rng, tree, key=None):
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in ("scale", "bq", "bk", "bv"):
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(dtype, out, ref, tol=1e-4):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    else:
        err, scale = np.abs(out - ref).max(), np.abs(ref).max()
        assert err <= 2e-2 * scale, (err, scale)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class Case:
    """One (config, dtype): both packages' models, the same parameters, a
    prompt with its frames or patches, and the reference's jitted entry
    points."""

    def __init__(self, name: str, dtype: str):
        self.name, self.dtype = name, dtype
        self.rcfg = REF_SMOKE[name].scaled(dtype=dtype)
        self.cfg = SMOKE[name].scaled(dtype=dtype)
        self.ref = ref_build(self.rcfg)
        self.model = build(self.cfg, "cpu")
        rng = np.random.default_rng(23)
        tree = jax.tree.map(np.asarray, self.ref.init(jax.random.key(6)))
        self.np_params = perturb(rng, tree)
        self.rparams = jax.tree.map(jnp.asarray, self.np_params)
        self.params = params_from_jax(self.np_params, device="cpu")
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.extra = {}
        if self.cfg.enc_dec:
            self.extra["frames"] = (0.02 * rng.standard_normal(
                (B, self.cfg.n_frames, self.cfg.d_model))).astype(np.float32)
        else:
            self.extra["patches"] = (0.02 * rng.standard_normal(
                (B, P, self.cfg.d_model))).astype(np.float32)
        self.offset = P if "patches" in self.extra else 0
        self.ref_prefill = jax.jit(self.ref.prefill)
        self.ref_decode = jax.jit(self.ref.decode_step)
        self.ref_full = jax.jit(self._ref_full)

    def rbatch(self, tokens):
        return {"tokens": jnp.asarray(tokens),
                **{k: jnp.asarray(v) for k, v in self.extra.items()}}

    def tbatch(self, tokens):
        return {"tokens": t(tokens), **{k: t(v) for k, v in
                                        self.extra.items()}}

    def _ref_full(self, params, batch):
        """The reference's full forward: last-position logits."""
        x, pos, enc_out, _ = self.ref._embed_inputs(params, batch)
        h, _, _ = self.ref._trunk(params, x, pos, enc_out=enc_out)
        return RL.unembed(params["embed"], self.rcfg,
                          h[:, -1:]).astype(jnp.float32)

    def full(self, tokens):
        """The port's full forward: last-position logits."""
        x, pos, enc_out, _ = self.model._embed_inputs(self.params,
                                                      self.tbatch(tokens))
        h, aux = self.model._trunk(self.params, x, pos, enc_out=enc_out)
        assert float(aux) == 0.0
        return L.unembed(self.params["embed"], self.cfg, h[:, -1:]).float()

    def ref_full_of(self, tokens):
        return self.ref_full(self.rparams, self.rbatch(tokens))

    def close(self, out, ref):
        close(self.dtype, out, ref)


@functools.lru_cache(maxsize=None)
def case(name, dtype="float32"):
    return Case(name, dtype)


def close_tree(c, mine, ref):
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == getattr(torch, str(ref[k].dtype)), k
        c.close(mine[k], ref[k])


# ------------------------------------------------------------ sinusoid ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_,d", [(16, 64), (1500, 1024)],
                         ids=["smoke", "whisper-medium"])
def test_sinusoid_is_bit_equal_to_reference(S_, d, dtype):
    """``_sinusoid`` rounds the float64 table to the model's dtype as
    ``jnp.asarray`` does, bit for bit, at SMOKE and full width."""
    mine = _sinusoid(S_, d, getattr(torch, dtype))
    ref = np.asarray(ref_sinusoid(S_, d, jnp.dtype(dtype)))
    assert mine.dtype == getattr(torch, dtype) and mine.shape == ref.shape
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert np.array_equal(mine.view(bits).numpy(),
                          ref.view(np.int16 if dtype == "bfloat16"
                                   else np.int32))


# ------------------------------------------------------ params and shapes ----
def test_params_from_jax_carries_encdec_leaves():
    """``convert.params_from_jax`` carries ``enc_layers``, ``dec_layers``
    (``lnx``, ``cross``), ``enc_lnf`` and ``lnf`` name for name and back to
    the same numpy bits; the port's own init gives the same tree of shapes
    and dtypes."""
    c = case(WHISPER)
    back = params_to_numpy(c.params)
    flat = jax.tree_util.tree_leaves_with_path(c.np_params)
    assert jax.tree.structure(back) == jax.tree.structure(c.np_params)
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    own = c.model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                          c.np_params)
    mine = jax.tree.map(lambda x: (tuple(x.shape),
                                   str(x.dtype).replace("torch.", "")), own)
    assert mine == shapes
    assert {"lnx", "cross"} <= set(own["dec_layers"])
    assert "cross" not in own["enc_layers"]


def test_init_fills_both_stacks_in_draw_order():
    """``_stack_init`` for both stacks: encoder layer i, then decoder layer
    i, equal the layer drawn alone from the same generator in the
    reference's order (the embedding, the encoder, the decoder)."""
    cfg = SMOKE[WHISPER]
    p = build(cfg, "cpu").init(torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    L.embed_init(g, cfg, "cpu")
    for stack, n, cross in (("enc_layers", cfg.n_enc_layers, False),
                            ("dec_layers", cfg.n_layers, True)):
        for i in range(n):
            one = [L.attention_init(g, cfg, "cpu")]
            if cross:
                one.append(L.attention_init(g, cfg, "cpu"))
            one.append(L.mlp_init(g, cfg, "cpu"))
            keys = ("attn", "cross", "mlp") if cross else ("attn", "mlp")
            for key, drawn in zip(keys, one):
                for a, b in zip(_leaves(drawn), _leaves(p[stack][key])):
                    assert torch.equal(a, b[i]), (stack, i, key)


@pytest.mark.parametrize("name", [WHISPER, VLM])
def test_abstract_params_cache_and_input_specs_match_reference(name):
    """``abstract_params`` (meta tensors) against the reference's
    ``jax.eval_shape`` of its init; ``make_cache`` (whisper's ``enc_out``
    beside K/V) leaf for leaf; ``input_specs`` in each mode (``frames``,
    ``patches`` in train and prefill modes)."""
    rm = ref_build(REF_SMOKE[name])
    model = build(SMOKE[name], "cpu")
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       rm.abstract_params())
    mine = model.abstract_params()
    assert all(v.device.type == "meta" for v in _leaves(mine))
    assert jax.tree.map(lambda v: (tuple(v.shape), str(v.dtype).replace(
        "torch.", "")), mine) == ref
    for ctx in (8, 32):
        mc, rc = model.make_cache(B, ctx), rm.make_cache(B, ctx)
        assert sorted(mc) == sorted(rc)
        for k in rc:
            assert tuple(mc[k].shape) == rc[k].shape, k
            assert mc[k].dtype == getattr(torch, str(rc[k].dtype)), k
            assert not mc[k].any() and not np.asarray(rc[k]).any()
    extra = "frames" if SMOKE[name].enc_dec else "patches"
    for mode in ("train", "prefill", "decode"):
        specs = rm.input_specs(32, 4, mode)
        got = model.input_specs(32, 4, mode)
        assert (extra in got) == (mode != "decode")
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}


# ------------------------------------------------------------- encoder ----
@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_fwd_matches_reference(dtype, grad):
    """``encoder_fwd`` on the same input (frames with the sinusoid added,
    from a numpy seed) against the reference's, with grad off and on (on:
    each layer under ``torch.utils.checkpoint``)."""
    c = case(WHISPER, dtype)
    x = np.random.default_rng(2).standard_normal(
        (B, c.cfg.n_frames, c.cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, x: RT.encoder_fwd(c.rcfg, p, x))(
        c.rparams, jnp.asarray(x, dtype))
    with torch.set_grad_enabled(grad):
        out = T.encoder_fwd(c.cfg, c.params, t(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    close(dtype, out, ref)


def _spy_flash():
    """A patch of ``layers.flash_attention`` recording (q's shape,
    causal) of each call."""
    calls, inner = [], L.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), causal))
        return inner(q, k, v, causal)

    return calls, mock.patch.object(L, "flash_attention", spy)


def test_encoder_runs_flash_unmasked_and_decoder_causal():
    """One ``flash_attention`` call a layer in each stack, in the full
    forward and in the prefill: the encoder's non-causal over the frames,
    the decoder's causal over the prompt; a decode step calls none."""
    c = case(WHISPER)
    cfg = c.cfg
    enc = [((B * cfg.n_heads, cfg.n_frames, cfg.d_head), False)] \
        * cfg.n_enc_layers
    dec = [((B * cfg.n_heads, S, cfg.d_head), True)] * cfg.n_layers
    calls, patch = _spy_flash()
    with patch, torch.inference_mode():
        c.full(c.tokens)
        assert calls == enc + dec
        calls.clear()
        _, cache = c.model.prefill(c.params, c.tbatch(c.tokens),
                                   c.model.make_cache(B, 16))
        assert calls == enc + dec
        calls.clear()
        c.model.decode_step(c.params, t(c.tokens[:, :1]), cache, S)
        assert calls == []


# ------------------------------------------------------- serving, loss ----
NAMES = [WHISPER, VLM]


@pytest.mark.parametrize("name", NAMES)
def test_full_forward_matches_reference(name):
    c = case(name)
    c.close(c.full(c.tokens), c.ref_full_of(c.tokens))


@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_reference(name, grad):
    """``Model.loss``'s value (nll, aux = 0, zloss, total) against the
    reference's in float32, with grad off and on; a VLM's loss drops the
    patch positions."""
    c = case(name)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, c.cfg.vocab, (B, 16)).astype(np.int32)
    labels = rng.integers(0, c.cfg.vocab, (B, 16)).astype(np.int32)
    rtotal, rparts = jax.jit(c.ref.loss)(
        c.rparams, {**c.rbatch(tokens), "labels": jnp.asarray(labels)})
    with torch.set_grad_enabled(grad):
        total, parts = c.model.loss(c.params, {**c.tbatch(tokens),
                                               "labels": t(labels)})
    for k in ("nll", "aux", "zloss"):
        np.testing.assert_allclose(float(parts[k]), float(rparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), float(rtotal), rtol=1e-5,
                               atol=1e-6)


def test_vlm_train_step_with_patches_matches_reference_gradients():
    """qwen2-vl's patches go through ``make_train_step`` as the tokens do:
    the loss and every gradient leaf against ``jax.value_and_grad`` of the
    reference's loss on the same batch, within 1e-4 of the leaf's max
    (``test_torch_train``'s tolerance)."""
    c = case(VLM)
    labels = np.random.default_rng(9).integers(
        0, c.cfg.vocab, (B, S)).astype(np.int32)
    (rl, _), rg = jax.jit(jax.value_and_grad(c.ref.loss, has_aux=True))(
        c.rparams, {**c.rbatch(c.tokens), "labels": jnp.asarray(labels)})
    _, step, _, _ = make_train_step(c.cfg, device="cpu")
    leaves = jax.tree.map(lambda p: p.detach().clone().requires_grad_(),
                          c.params)
    loss, _ = c.model.loss(leaves, {**c.tbatch(c.tokens),
                                    "labels": t(labels)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(rl), rtol=1e-5)
    flat = jax.tree_util.tree_leaves_with_path(rg)
    assert len(flat) == len(list(_leaves(leaves)))
    for path, ref in flat:
        leaf = leaves
        for key in path:
            leaf = leaf[key.key]
        err = np.abs(leaf.grad.numpy() - np.asarray(ref)).max()
        assert err <= 1e-4 * np.abs(np.asarray(ref)).max(), path
    _, _, metrics = step(c.params, adamw.init(c.params),
                         {**c.tbatch(c.tokens), "labels": t(labels)})
    np.testing.assert_allclose(float(metrics["loss"]), float(rl), rtol=1e-5)


def test_whisper_loss_backward_reaches_every_leaf():
    """Under grad (each layer of both stacks checkpointed) the loss's
    backward gives every parameter leaf a finite gradient. (Held against
    ``jax.value_and_grad`` by ``tests/test_torch_train_stacks.py``.)"""
    c = case(WHISPER)
    leaves = jax.tree.map(lambda p: p.detach().clone().requires_grad_(),
                          c.params)
    rng = np.random.default_rng(8)
    labels = rng.integers(0, c.cfg.vocab, (B, S)).astype(np.int32)
    loss, _ = c.model.loss(leaves, {**c.tbatch(c.tokens),
                                    "labels": t(labels)})
    loss.backward()
    for leaf in _leaves(leaves):
        assert leaf.grad is not None and bool(torch.isfinite(leaf.grad)
                                              .all())


@pytest.mark.parametrize("ctx", [8, S + P])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference_when_prompt_fills_cache(name, ctx):
    """S >= ctx: the reference's ring is right (it is short only below
    S), and the port's last-token logits and every cache leaf (whisper's
    ``enc_out`` too) equal it; qwen2-vl's prompt is its 4 patches and 12
    tokens."""
    c = case(name)
    if c.offset == 0 and ctx > S:
        ctx = S
    logits, cache = c.model.prefill(c.params, c.tbatch(c.tokens),
                                    c.model.make_cache(B, ctx))
    rlogits, rcache = c.ref_prefill(c.rparams, c.rbatch(c.tokens),
                                    c.ref.make_cache(B, ctx))
    assert logits.dtype == torch.float32
    c.close(logits, rlogits)
    close_tree(c, cache, rcache)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference_at_full_cache(name):
    """A cache as long as the prompt (qwen2-vl's 4 patches and 12 tokens):
    two decode steps at positions ``offset + S`` and one on, each writing
    over the oldest slot in both packages; logits and every cache leaf
    after each (whisper's cross-attention reading ``enc_out``)."""
    c = case(name)
    n = c.offset + S
    _, cache = c.model.prefill(c.params, c.tbatch(c.tokens),
                               c.model.make_cache(B, n))
    _, rcache = c.ref_prefill(c.rparams, c.rbatch(c.tokens),
                              c.ref.make_cache(B, n))
    tok = c.tokens[:, :1]
    for pos in (n, n + 1):
        logits, cache = c.model.decode_step(c.params, t(tok), cache, pos)
        rlogits, rcache = c.ref_decode(c.rparams, jnp.asarray(tok), rcache,
                                       pos)
        c.close(logits, rlogits)
        close_tree(c, cache, rcache)
        tok = np.asarray(jnp.argmax(rlogits[:, -1], -1), np.int32)[:, None]


@pytest.mark.parametrize("name", NAMES)
def test_first_decode_equals_full_forward_when_prompt_is_shorter(name):
    """ctx past the prompt: the port's prefill fills all ctx slots (slots
    past the prompt zero), so the first decode step equals the reference's
    full forward over the prompt and one token more."""
    c = case(name)
    ctx = 32
    logits, cache = c.model.prefill(c.params, c.tbatch(c.tokens),
                                    c.model.make_cache(B, ctx))
    n = c.offset + S
    assert cache["k"].shape[2] == ctx
    assert not cache["k"][:, :, n:].any() and cache["k"][:, :, :n].any()
    c.close(logits, c.ref_full_of(c.tokens))
    nxt = c.tokens[:, -1:]
    step, _ = c.model.decode_step(c.params, t(nxt), cache, n)
    c.close(step, c.ref_full_of(np.concatenate([c.tokens, nxt], axis=1)))


def test_reference_encdec_prefill_returns_a_short_ring():
    """The fault the port's prefill does not copy (ROADMAP queue C): the
    reference's ``encdec_prefill`` returns K/V of S slots for a ctx-slot
    cache, and its first decode step then overwrites token 0's K/V and
    moves away from its own full forward."""
    c = case(WHISPER)
    _, rcache = c.ref_prefill(c.rparams, c.rbatch(c.tokens),
                              c.ref.make_cache(B, 32))
    assert rcache["k"].shape[2] == S != 32
    nxt = c.tokens[:, -1:]
    rstep, _ = c.ref_decode(c.rparams, jnp.asarray(nxt), rcache, S)
    full = c.ref_full_of(np.concatenate([c.tokens, nxt], axis=1))
    assert np.abs(np.asarray(rstep) - np.asarray(full)).max() > 1e-2


@pytest.mark.parametrize("name", NAMES)
def test_serve_steps_greedy_tokens_match_reference_full_forward(name):
    """``make_serve_steps``: prefill then 4 greedy decode steps, against
    teacher-forced argmax of the reference's full forward (float32)."""
    c = case(name)
    _, prefill_step, decode_step = make_serve_steps(c.cfg, device="cpu")
    logits, cache = prefill_step(c.params, c.tbatch(c.tokens),
                                 c.model.make_cache(B, 32))
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    mine = [tok]
    for i in range(4):
        tok, cache = decode_step(c.params, tok, cache, c.offset + S + i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        mine.append(tok)
    seq = c.tokens
    for i in range(5):
        nxt = np.asarray(jnp.argmax(c.ref_full_of(seq)[:, -1], -1),
                         np.int32)[:, None]
        np.testing.assert_array_equal(mine[i].numpy(), nxt)
        seq = np.concatenate([seq, nxt], axis=1)


def _bf16_run(c, port: bool):
    """Prefill (a cache as long as the prompt) and two decode steps:
    [(name, numpy)] of the prefill's logits and cache leaves, then each
    step's."""
    out = []

    def record(tag, logits, cache):       # copies: decode updates in place
        out.append((f"{tag} logits", np.array(logits, np.float32)))
        out.extend((f"{tag} {k}", np.array(v, np.float32))
                   for k, v in sorted(cache.items()))

    n = c.offset + S
    tok = c.tokens[:, :1]
    if port:
        with torch.inference_mode():
            logits, cache = c.model.prefill(c.params, c.tbatch(c.tokens),
                                            c.model.make_cache(B, n))
            record("prefill", logits, {k: v.float() for k, v in
                                       cache.items()})
            for pos in (n, n + 1):
                logits, cache = c.model.decode_step(c.params, t(tok), cache,
                                                    pos)
                record(f"decode {pos}", logits,
                       {k: v.float() for k, v in cache.items()})
        return out
    logits, cache = c.ref_prefill(c.rparams, c.rbatch(c.tokens),
                                  c.ref.make_cache(B, n))
    record("prefill", logits, cache)
    for pos in (n, n + 1):
        logits, cache = c.ref_decode(c.rparams, jnp.asarray(tok), cache, pos)
        record(f"decode {pos}", logits, cache)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_bf16_as_close_to_float32_as_the_reference(name):
    """bf16: the prefill's logits and every cache leaf, then two decode
    steps' (the tokens fed in the same order): the port's distance from
    the float32 reference at most twice the reference's own bf16 distance
    from it, plus 2e-2 of scale (see the module docstring)."""
    c16, c32 = case(name, "bfloat16"), case(name)
    port16 = _bf16_run(c16, True)
    ref16, ref32 = _bf16_run(c16, False), _bf16_run(c32, False)
    assert [k for k, _ in port16] == [k for k, _ in ref32]
    for (k, a), (_, r16), (_, r32) in zip(port16, ref16, ref32):
        scale = np.abs(r32).max()
        err, err_ref = np.abs(a - r32).max(), np.abs(r16 - r32).max()
        assert np.isfinite(a).all() and a.shape == r32.shape, k
        assert err <= 2 * err_ref + 2e-2 * scale, (k, err, err_ref, scale)


def test_prefill_refuses_a_cache_of_another_frame_count():
    c = case(WHISPER)
    cache = c.model.make_cache(B, 16)
    cache["enc_out"] = cache["enc_out"][:, :-1]
    with pytest.raises(ValueError, match="enc_out"):
        c.model.prefill(c.params, c.tbatch(c.tokens), cache)
