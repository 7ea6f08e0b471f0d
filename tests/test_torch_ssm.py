"""The port's recurrent blocks (``repro_torch.models.ssm``) and the zamba2
and xLSTM stacks of ``models/transformer.py`` against the reference
package on the SMOKE configs.

Both packages get the same parameters (the reference's ``init``, carried
across by ``convert.params_from_jax``, with the norm scales and Mamba2's
``A_log``, ``dt_bias`` and ``D`` perturbed so that their initial ones and
zeros hide no missing term) and the same inputs from a numpy seed. The
reference has no Pallas kernel on these paths; its scans are
``lax.scan``s, run on the CPU through ``jax.jit``.

Tolerances: a single block in float32 within rtol = atol = 1e-5, the
stacks in float32 within 1e-4 (``test_torch_models``'s), both in each
grad mode (with grad disabled the port's scans update their state in
place). bfloat16 is held to ``max |port - ref| <= 2e-2 * max |ref|``
(``test_torch_moe``'s ``Case.close``) for each block on identical inputs.
The stacks in bfloat16 are not held that way: at SMOKE size the
reference's own bf16 logits and states sit 0.05-0.21 (zamba2) and
0.006-0.035 (xLSTM) of their scale from its float32 ones on the same
weights, and the port's bf16 sits as far from the reference's (each
recurrence carries its bf16 inputs' rounding into every later step:
Mamba2's ``dt``, B and C, xLSTM's gates), past 2e-2 within a prefill
for zamba2 and two decode steps for xLSTM. They are held to be
as close to the float32 reference as the reference's bf16 is: ``max
|port - ref32| <= 2 * max |ref16 - ref32| + 2e-2 * max |ref32|``.
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
from repro.models import ssm as RSSM
from repro.models.model import build as ref_build
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch.steps import make_serve_steps
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.model import build

STACKS = ("zamba2-7b", "xlstm-125m")
B, S = 2, 12
PERTURBED = ("scale", "A_log", "dt_bias", "D")


def perturb(rng, tree, key=None):
    """Norm scales and Mamba2's A_log, dt_bias and D get noise."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in PERTURBED:
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(dtype, out, ref, tol=1e-4):
    out = out.float().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    else:
        err, scale = np.abs(out - ref).max(), np.abs(ref).max()
        assert err <= 2e-2 * scale, (err, scale)


def grad_mode(inplace: bool):
    """The serve steps' mode (grad off: the scans update in place) or
    the loss's (grad on: out of place)."""
    return torch.inference_mode() if inplace else torch.enable_grad()


# ------------------------------------------------------------- blocks ----
BLOCKS = {"mamba2": ("zamba2-7b", RSSM.mamba2_init, RSSM.mamba2_fwd,
                     SSM.mamba2_fwd),
          "mlstm": ("xlstm-125m", RSSM.mlstm_init, RSSM.mlstm_fwd,
                    SSM.mlstm_fwd),
          "slstm": ("xlstm-125m", RSSM.slstm_init, RSSM.slstm_fwd,
                    SSM.slstm_fwd)}


def block_state(block, cfg, Bb, rng):
    """A state of the block's layout, from a numpy seed (sLSTM's n >= 1
    and mLSTM's n such that the max(|q.n|, 1) takes both sides)."""
    d, H = cfg.d_model, cfg.n_heads
    if block == "mamba2":
        Hs = 2 * d // cfg.ssm_headdim
        return rng.standard_normal((Bb, Hs, cfg.ssm_state,
                                    cfg.ssm_headdim)).astype(np.float32)
    if block == "mlstm":
        dh = d // H
        return (rng.standard_normal((Bb, H, dh, dh)).astype(np.float32),
                0.3 * rng.standard_normal((Bb, H, dh)).astype(np.float32))
    return (rng.standard_normal((Bb, d)).astype(np.float32),
            1.0 + rng.random((Bb, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def block_case(block, dtype, shape, with_state):
    """(port params, x, state, the reference's (y, final state))."""
    name, rinit, rfwd, _ = BLOCKS[block]
    rcfg = REF_SMOKE[name].scaled(dtype=dtype)
    rng = np.random.default_rng([list(BLOCKS).index(block), *shape,
                                 with_state])
    np_p = perturb(rng, jax.tree.map(np.asarray,
                                     rinit(jax.random.key(7), rcfg)))
    x = rng.standard_normal(shape + (rcfg.d_model,)).astype(np.float32)
    state = block_state(block, rcfg, shape[0], rng) if with_state else None
    ry, rs = jax.jit(lambda p, x, s: rfwd(p, rcfg, x, s))(
        jax.tree.map(jnp.asarray, np_p), jnp.asarray(x, dtype),
        jax.tree.map(jnp.asarray, state))
    return (params_from_jax(np_p, device="cpu"), x, state,
            (np.asarray(ry, np.float32),
             jax.tree.map(lambda a: np.asarray(a, np.float32), rs)))


@pytest.mark.parametrize("inplace", [False, True], ids=["grad", "inplace"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zero-state", "given-state"])
@pytest.mark.parametrize("shape", [(2, 16), (1, 1), (3, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_reference(block, dtype, shape, with_state, inplace):
    """``mamba2_fwd``, ``mlstm_fwd``, ``slstm_fwd``: the output and every
    leaf of the final state; a given state is left as it was."""
    name, _, _, fwd = BLOCKS[block]
    cfg = SMOKE[name].scaled(dtype=dtype)
    p, x, state, (ry, rs) = block_case(block, dtype, shape, with_state)
    given = None if state is None else jax.tree.map(t, state)
    kept = None if given is None else jax.tree.map(torch.clone, given)
    with grad_mode(inplace):
        y, s = fwd(p, cfg, t(x).to(getattr(torch, dtype)), given)
    assert y.dtype == getattr(torch, dtype) and y.shape == x.shape
    close(dtype, y, ry, 1e-5)
    for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(rs)):
        assert a.dtype == torch.float32
        close(dtype, a, b, 1e-5)
    if given is not None:
        for a, b in zip(jax.tree.leaves(given), jax.tree.leaves(kept)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softplus_is_logaddexp(dtype):
    """``jax.nn.softplus`` in x's dtype, past F.softplus's threshold of 20
    too: within 1e-6 in float32, one ulp (2^-7 relative) in bf16."""
    x = np.array([-30.0, -3.0, 0.0, 0.7, 19.0, 21.0, 40.0], np.float32)
    got = SSM._softplus(t(x).to(getattr(torch, dtype)))
    want = np.asarray(jax.nn.softplus(jnp.asarray(x, dtype)), np.float32)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                               rtol=1e-6 if dtype == "float32" else 2**-7)


# ------------------------------------------------------------- stacks ----
class Case:
    """One (config, dtype): both packages' models, the same parameters, a
    prompt, and the reference's jitted entry points."""

    def __init__(self, name: str, dtype: str):
        self.name, self.dtype = name, dtype
        self.rcfg = REF_SMOKE[name].scaled(dtype=dtype)
        self.cfg = SMOKE[name].scaled(dtype=dtype)
        self.ref = ref_build(self.rcfg)
        self.model = build(self.cfg, "cpu")
        rng = np.random.default_rng(31)
        tree = jax.tree.map(np.asarray, self.ref.init(jax.random.key(4)))
        self.np_params = perturb(rng, tree)
        self.rparams = jax.tree.map(jnp.asarray, self.np_params)
        self.params = params_from_jax(self.np_params, device="cpu")
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(np.int32)
        self.ref_prefill = jax.jit(self.ref.prefill)
        self.ref_decode = jax.jit(self.ref.decode_step)
        self.ref_full = jax.jit(self._ref_full)

    def _ref_full(self, params, tokens):
        """The reference's full forward: last-position logits."""
        x, pos, enc_out, _ = self.ref._embed_inputs(params,
                                                    {"tokens": tokens})
        h, _, _ = self.ref._trunk(params, x, pos, enc_out=enc_out)
        return RL.unembed(params["embed"], self.rcfg,
                          h[:, -1:]).astype(jnp.float32)

    def full(self, tokens):
        """The port's full forward: last-position logits."""
        x, pos, _, _ = self.model._embed_inputs(self.params,
                                                {"tokens": t(tokens)})
        h, aux = self.model._trunk(self.params, x, pos)
        assert float(aux) == 0.0
        return L.unembed(self.params["embed"], self.cfg, h[:, -1:]).float()

    def close(self, out, ref):
        close(self.dtype, out, ref)


CASES = [("zamba2-7b", "float32"), ("xlstm-125m", "float32")]


@pytest.fixture(scope="module", params=CASES, ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return Case(*request.param)


@functools.lru_cache(maxsize=None)
def case32(name):
    return Case(name, "float32")


def close_tree(case, mine, ref):
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == getattr(torch, str(ref[k].dtype)), k
        case.close(mine[k], ref[k])


@pytest.mark.parametrize("inplace", [False, True], ids=["grad", "inplace"])
@pytest.mark.parametrize("ctx", [8, S])
def test_prefill_matches_reference_when_prompt_fills_cache(case, ctx,
                                                          inplace):
    """S >= ctx: the reference's cache is right (its ring is short only
    below S), and the port's last-token logits and every state leaf equal
    it."""
    with grad_mode(inplace):
        logits, cache = case.model.prefill(
            case.params, {"tokens": t(case.tokens)},
            case.model.make_cache(B, ctx))
    rlogits, rcache = case.ref_prefill(
        case.rparams, {"tokens": jnp.asarray(case.tokens)},
        case.ref.make_cache(B, ctx))
    assert logits.dtype == torch.float32
    case.close(logits, rlogits)
    close_tree(case, cache, rcache)


def test_decode_step_matches_reference_at_full_cache(case):
    """S == ctx: two decode steps from the prefill's state (zamba2's
    shared attention writing over the oldest ring slot), logits and
    every state leaf after each."""
    cache = case.model.make_cache(B, S)
    rcache = case.ref.make_cache(B, S)
    _, cache = case.model.prefill(case.params, {"tokens": t(case.tokens)},
                                  cache)
    _, rcache = case.ref_prefill(case.rparams,
                                 {"tokens": jnp.asarray(case.tokens)},
                                 rcache)
    tok = case.tokens[:, :1]
    for pos in (S, S + 1):
        with torch.inference_mode():
            logits, cache = case.model.decode_step(case.params, t(tok),
                                                   cache, pos)
        rlogits, rcache = case.ref_decode(case.rparams, jnp.asarray(tok),
                                          rcache, pos)
        case.close(logits, rlogits)
        close_tree(case, cache, rcache)
        tok = np.asarray(jnp.argmax(rlogits[:, -1], -1), np.int32)[:, None]


def test_first_decode_equals_full_forward_when_prompt_is_shorter(case):
    """S < ctx: the port's prefill fills zamba2's ctx-slot K/V cache
    (slots S.. zero), so the first decode step equals the reference's
    full forward over the S + 1 tokens."""
    ctx = 32
    logits, cache = case.model.prefill(case.params,
                                       {"tokens": t(case.tokens)},
                                       case.model.make_cache(B, ctx))
    if "ak" in cache:
        assert cache["ak"].shape[2] == ctx
        assert not cache["ak"][:, :, S:].any()
        assert cache["ak"][:, :, :S].any()
    case.close(logits, case.ref_full(case.rparams, jnp.asarray(case.tokens)))
    nxt = case.tokens[:, -1:]
    step, _ = case.model.decode_step(case.params, t(nxt), cache, S)
    full = np.concatenate([case.tokens, nxt], axis=1)
    case.close(step, case.ref_full(case.rparams, jnp.asarray(full)))


def test_reference_zamba2_prefill_returns_a_short_ring():
    """The fault the port's prefill does not copy (ROADMAP queue C): the
    reference's zamba2 prefill returns ``ak`` of S slots for a ctx-slot
    cache, and its first decode step then overwrites token 0's K/V and
    moves away from its own full forward."""
    case = case32("zamba2-7b")
    ctx = 32
    _, rcache = case.ref_prefill(case.rparams,
                                 {"tokens": jnp.asarray(case.tokens)},
                                 case.ref.make_cache(B, ctx))
    assert rcache["ak"].shape[2] == S != ctx
    nxt = case.tokens[:, -1:]
    rstep, _ = case.ref_decode(case.rparams, jnp.asarray(nxt), rcache, S)
    full = case.ref_full(case.rparams, jnp.asarray(
        np.concatenate([case.tokens, nxt], axis=1)))
    assert np.abs(np.asarray(rstep) - np.asarray(full)).max() > 1e-2


@pytest.mark.parametrize("name", STACKS)
def test_serve_steps_greedy_tokens_match_reference_full_forward(name):
    """``make_serve_steps``: prefill then 4 greedy decode steps (in
    ``inference_mode``: the scans in place), against teacher-forced argmax
    of the reference's full forward (float32)."""
    case = case32(name)
    _, prefill_step, decode_step = make_serve_steps(case.cfg, device="cpu")
    cache = case.model.make_cache(B, 32)
    logits, cache = prefill_step(case.params, {"tokens": t(case.tokens)},
                                 cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    mine = [tok]
    for i in range(4):
        tok, cache = decode_step(case.params, tok, cache, S + i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        mine.append(tok)
    seq = case.tokens
    for i in range(5):
        nxt = np.asarray(jnp.argmax(case.ref_full(
            case.rparams, jnp.asarray(seq))[:, -1], -1), np.int32)[:, None]
        np.testing.assert_array_equal(mine[i].numpy(), nxt)
        seq = np.concatenate([seq, nxt], axis=1)


def _bf16_run(c, port: bool):
    """Prefill (a cache of S = ctx) and two decode steps: [(name,
    numpy)] of the prefill's logits and state leaves, then each step's."""
    out = []

    def record(tag, logits, cache):       # copies: decode updates in place
        out.append((f"{tag} logits", np.array(logits, np.float32)))
        out.extend((f"{tag} {k}", np.array(v, np.float32))
                   for k, v in sorted(cache.items()))

    tok = c.tokens[:, :1]
    if port:
        with torch.inference_mode():
            logits, cache = c.model.prefill(
                c.params, {"tokens": t(c.tokens)}, c.model.make_cache(B, S))
            record("prefill", logits, {k: v.float() for k, v in
                                       cache.items()})
            for pos in (S, S + 1):
                logits, cache = c.model.decode_step(c.params, t(tok), cache,
                                                    pos)
                record(f"decode {pos}", logits,
                       {k: v.float() for k, v in cache.items()})
        return out
    logits, cache = c.ref_prefill(c.rparams, {"tokens": jnp.asarray(c.tokens)},
                                  c.ref.make_cache(B, S))
    record("prefill", logits, cache)
    for pos in (S, S + 1):
        logits, cache = c.ref_decode(c.rparams, jnp.asarray(tok), cache, pos)
        record(f"decode {pos}", logits, cache)
    return out


@pytest.mark.parametrize("name", STACKS)
def test_bf16_as_close_to_float32_as_the_reference(name):
    """bf16: the prefill's logits and every state leaf, then two decode
    steps' (a cache of S = ctx, the tokens fed in the same order): the
    port's distance from the float32 reference at most twice the
    reference's own bf16 distance from it, plus 2e-2 of scale (see the
    module docstring)."""
    c16, c32 = Case(name, "bfloat16"), case32(name)
    port16 = _bf16_run(c16, True)
    ref16, ref32 = _bf16_run(c16, False), _bf16_run(c32, False)
    assert [k for k, _ in port16] == [k for k, _ in ref32]
    for (k, a), (_, r16), (_, r32) in zip(port16, ref16, ref32):
        scale = np.abs(r32).max()
        err, err_ref = np.abs(a - r32).max(), np.abs(r16 - r32).max()
        assert np.isfinite(a).all() and a.shape == r32.shape, k
        assert err <= 2 * err_ref + 2e-2 * scale, (k, err, err_ref, scale)


@pytest.mark.parametrize("name", STACKS)
def test_loss_matches_reference(name):
    """``Model.loss``'s value (nll, aux = 0, zloss, total) against the
    reference's in float32."""
    case = case32(name)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, case.cfg.vocab, (B, 16)).astype(np.int32)
    labels = rng.integers(0, case.cfg.vocab, (B, 16)).astype(np.int32)
    rtotal, rparts = jax.jit(case.ref.loss)(
        case.rparams, {"tokens": jnp.asarray(tokens),
                       "labels": jnp.asarray(labels)})
    total, parts = case.model.loss(case.params, {"tokens": t(tokens),
                                                 "labels": t(labels)})
    for k in ("nll", "aux", "zloss"):
        np.testing.assert_allclose(float(parts[k]), float(rparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total), float(rtotal), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", STACKS)
def test_make_cache_matches_reference(name):
    """The cache's leaves, shapes, dtypes and initial values (sLSTM's n
    at ones), zamba2's K/V ring at min(ctx, ZAMBA_WINDOW) slots."""
    case = case32(name)
    for ctx in (8, T.ZAMBA_WINDOW + 8):
        mine = case.model.make_cache(B, ctx)
        ref = case.ref.make_cache(B, ctx)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert tuple(mine[k].shape) == ref[k].shape, k
            assert mine[k].dtype == getattr(torch, str(ref[k].dtype)), k
            np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("name", STACKS)
def test_params_from_jax_walks_nested_stacks(name):
    """``convert.params_from_jax`` carries the nested ``super`` trees
    (``[n_super, inner, ...]`` leaves) and back to the same numpy bits;
    the port's own init gives the same tree of shapes and dtypes."""
    case = case32(name)
    back = params_to_numpy(case.params)
    flat = jax.tree_util.tree_leaves_with_path(case.np_params)
    assert jax.tree.structure(back) == jax.tree.structure(case.np_params)
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    own = case.model.init(torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                          case.np_params)
    mine = jax.tree.map(lambda x: (tuple(x.shape),
                                   str(x.dtype).replace("torch.", "")), own)
    assert mine == shapes


@pytest.mark.parametrize("name", STACKS)
def test_abstract_params_match_reference_eval_shape(name):
    """``abstract_params`` (meta tensors, nothing drawn): the reference's
    ``jax.eval_shape`` of its init, leaf for leaf in shape and dtype; and
    ``input_specs`` the reference's in each mode."""
    ref_model = ref_build(REF_SMOKE[name])
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       ref_model.abstract_params())
    model = build(SMOKE[name], "cpu")
    mine = model.abstract_params()
    assert all(v.device.type == "meta" for v in _leaves(mine))
    mine = jax.tree.map(lambda v: (tuple(v.shape),
                                   str(v.dtype).replace("torch.", "")), mine)
    assert mine == ref
    for mode in ("train", "prefill", "decode"):
        specs = ref_model.input_specs(32, 4, mode)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in specs.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in model.input_specs(32, 4, mode).items()}


@pytest.mark.parametrize("name", STACKS)
def test_init_fills_nested_stacks_in_draw_order(name):
    """``_stack_init`` nested for the groups: group g's layer i of the
    stacked init equals the layer drawn alone from the same generator in
    the reference's order (the embedding, the groups, then zamba2's
    shared attention and its tail)."""
    cfg = SMOKE[name]
    p = build(cfg, "cpu").init(torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    L.embed_init(g, cfg, "cpu")
    if cfg.block == "mamba2":
        inner = cfg.attn_every
        n_super, tail = divmod(cfg.n_layers, inner)
        for s in range(n_super):
            for i in range(inner):
                one = T._mamba_layer_init(g, cfg, "cpu")
                for a, b in zip(_leaves(one), _leaves(p["super"])):
                    assert torch.equal(a, b[s, i])
        attn = L.attention_init(g, cfg, "cpu")
        for a, b in zip(_leaves(attn), _leaves(p["shared_attn"])):
            assert torch.equal(a, b)
        assert tail
        for i in range(tail):
            one = T._mamba_layer_init(g, cfg, "cpu")
            for a, b in zip(_leaves(one), _leaves(p["tail"])):
                assert torch.equal(a, b[i])
    else:
        inner = cfg.slstm_every - 1
        for s in range(cfg.n_layers // cfg.slstm_every):
            for i in range(inner):
                one = T._xl_layer_init(g, cfg, "m", "cpu")
                for a, b in zip(_leaves(one), _leaves(p["super"]["m"])):
                    assert torch.equal(a, b[s, i])
            one = T._xl_layer_init(g, cfg, "s", "cpu")
            for a, b in zip(_leaves(one), _leaves(p["super"]["s"])):
                assert torch.equal(a, b[s])


def _spy_attention():
    """Patches of ``flash_sdpa`` and ``_sdpa`` in the port's layers that
    record each call's route (and ``_sdpa``'s mask)."""
    calls = []
    flash, sdpa = L.flash_sdpa, L._sdpa

    def spy_flash(*a, **kw):
        calls.append(("flash", None))
        return flash(*a, **kw)

    def spy_sdpa(q, k, v, mask, cfg):
        calls.append(("sdpa", mask))
        return sdpa(q, k, v, mask, cfg)

    return calls, (mock.patch.object(L, "flash_sdpa", spy_flash),
                   mock.patch.object(L, "_sdpa", spy_sdpa))


@pytest.mark.parametrize("window", [None, 5], ids=["within", "past"])
def test_shared_attention_routes(window):
    """zamba2's shared attention: S within ``ZAMBA_WINDOW`` runs the
    flash route (its plain version on the CPU) once a group and no
    ``_sdpa``; with the window patched down to 5 in both packages (S =
    12 past it) it runs ``_sdpa`` with ``causal_mask(S, S, 5)`` and no
    flash. Either way the full forward, the prefill (its cache at
    min(ctx, window) slots) and a decode step equal the reference's."""
    case = case32("zamba2-7b")
    n_super = case.cfg.n_layers // case.cfg.attn_every
    calls, (p_flash, p_sdpa) = _spy_attention()
    w = window or T.ZAMBA_WINDOW
    with p_flash, p_sdpa, mock.patch.object(T, "ZAMBA_WINDOW", w), \
            mock.patch.object(RT, "ZAMBA_WINDOW", w):
        got = case.full(case.tokens)
        routes = [r for r, _ in calls]
        if window is None:
            assert routes == ["flash"] * n_super
        else:
            assert routes == ["sdpa"] * n_super
            mask = L.causal_mask(S, S, window)
            assert all(torch.equal(m, mask) for _, m in calls)
        # fresh functions, so that jax traces them under this window
        ref_full = jax.jit(lambda p, tok: case._ref_full(p, tok))
        case.close(got, ref_full(case.rparams, jnp.asarray(case.tokens)))
        ctx = 16
        logits, cache = case.model.prefill(
            case.params, {"tokens": t(case.tokens)},
            case.model.make_cache(B, ctx))
        rlogits, rcache = jax.jit(lambda p, b, c: case.ref.prefill(p, b, c))(
            case.rparams, {"tokens": jnp.asarray(case.tokens)},
            case.ref.make_cache(B, ctx))
        assert cache["ak"].shape[2] == min(ctx, w)
        case.close(logits, rlogits)
        if window is not None:          # S >= Tw: the reference's ring
            close_tree(case, cache, rcache)
        nxt = case.tokens[:, -1:]
        step, _ = case.model.decode_step(case.params, t(nxt), cache, S)
        full = np.concatenate([case.tokens, nxt], axis=1)
        case.close(step, ref_full(case.rparams, jnp.asarray(full)))
