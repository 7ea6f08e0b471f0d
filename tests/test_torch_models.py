"""The port's LM serving path (``repro_torch.models``, ``launch.steps``)
against the reference package on the dense SMOKE configs.

Both packages get the same parameters (the reference's ``init``, carried
across as numpy by ``convert.params_from_jax``, with every bias and norm
scale perturbed so that those leaves count) and the same token ids from a
numpy seed. The reference runs on the CPU through ``jax.jit``.

Tolerances: float32 is held elementwise at rtol = atol = 1e-4. In bfloat16
both packages round at different places (XLA keeps excess precision
across fused ops; the port's flash attention keeps P in fp32 where the
reference's ``_sdpa`` casts it to bf16), and at SMOKE width the
reference's own bf16 logits sit 0.03 from its fp32 logits on the same
weights, which is above an elementwise 2e-2. So bf16 results are held to
the reference's tolerance, 2e-2, relative to their scale:
``max |port - ref| <= 2e-2 * max |ref|``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as REF_SMOKE
from repro.models import layers as RL
from repro.models.model import build as ref_build
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.launch.steps import make_serve_steps
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model import build

# the dense decoder-only configs; qwen2-vl-72b on its text path (M-RoPE)
DENSE = ("qwen3-0.6b", "qwen3-1.7b", "starcoder2-3b", "qwen1.5-110b",
         "qwen2-vl-72b")
B, S = 2, 12


class Case:
    """One (config, dtype): both packages' models, the same parameters, a
    prompt, and the reference's jitted entry points."""

    def __init__(self, name: str, dtype: str):
        self.name, self.dtype = name, dtype
        self.rcfg = REF_SMOKE[name].scaled(dtype=dtype)
        self.cfg = SMOKE[name].scaled(dtype=dtype)
        self.ref = ref_build(self.rcfg)
        self.model = build(self.cfg, "cpu")
        rng = np.random.default_rng(11)
        tree = jax.tree.map(np.asarray, self.ref.init(jax.random.key(2)))
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

    def close(self, out, ref):
        out = out.float().numpy() if torch.is_tensor(out) else out
        ref = np.asarray(ref, np.float32)
        assert out.shape == ref.shape
        if self.dtype == "float32":
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        else:
            err, scale = np.abs(out - ref).max(), np.abs(ref).max()
            assert err <= 2e-2 * scale, (err, scale)


def perturb(rng, tree, key=None):
    """Norm scales and biases get noise, so that their initial ones and
    zeros do not hide a missing term."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in ("scale", "bq", "bk", "bv"):
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


@pytest.fixture(scope="module", params=[(n, d) for n in DENSE
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return Case(*request.param)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_params_from_jax_round_trip(case):
    """Name for name, shape and dtype, and back to the same numpy bits;
    the port's own init gives the same tree of shapes and dtypes."""
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


def test_init_draws_from_the_generator(case):
    a = case.model.init(torch.Generator().manual_seed(5))
    b = case.model.init(torch.Generator().manual_seed(5))
    c = case.model.init(torch.Generator().manual_seed(6))
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])


@pytest.mark.parametrize("m_rope", [False, True])
def test_norm_rope_and_qkv_match_reference(case, m_rope):
    rng = np.random.default_rng(4)
    dt = case.dtype
    x = rng.standard_normal((B, S, case.cfg.d_model)).astype(np.float32)
    rx, tx = jnp.asarray(x, dt), t(x).to(getattr(torch, dt))
    ln = jax.tree.map(lambda a: a[0], case.np_params["layers"]["ln1"])
    case.close(L.rmsnorm(params_from_jax(ln, device="cpu"), tx,
                         case.cfg.norm_eps),
               RL.rmsnorm(jax.tree.map(jnp.asarray, ln), rx,
                          case.rcfg.norm_eps))
    heads = rng.standard_normal((B, S, 4, case.cfg.d_head)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, B, S) if m_rope else (B, S))
    case.close(L.apply_rope(t(heads).to(getattr(torch, dt)), t(pos),
                            case.cfg.rope_theta, m_rope),
               RL.apply_rope(jnp.asarray(heads, dt), jnp.asarray(pos),
                             case.rcfg.rope_theta, m_rope))
    attn = jax.tree.map(lambda a: a[0], case.np_params["layers"]["attn"])
    cfg_t = case.cfg.scaled(m_rope=m_rope)
    cfg_r = case.rcfg.scaled(m_rope=m_rope)
    mine = L._qkv(params_from_jax(attn, device="cpu"), cfg_t, tx, t(pos))
    ref = RL._qkv(jax.tree.map(jnp.asarray, attn), cfg_r, rx,
                  jnp.asarray(pos))
    for a, b in zip(mine, ref):
        case.close(a, b)


@pytest.mark.parametrize("ctx", [8, S])
def test_prefill_matches_reference_when_prompt_fills_cache(case, ctx):
    """S >= ctx: the reference's ring cache is right, and the port's
    last-token logits and every layer's K/V cache equal it."""
    logits, cache = case.model.prefill(
        case.params, {"tokens": t(case.tokens)}, case.model.make_cache(B, ctx))
    rlogits, rcache = case.ref_prefill(
        case.rparams, {"tokens": jnp.asarray(case.tokens)},
        case.ref.make_cache(B, ctx))
    assert logits.dtype == torch.float32
    case.close(logits, rlogits)
    case.close(cache["k"], rcache["k"])
    case.close(cache["v"], rcache["v"])


def test_decode_step_matches_reference_at_full_cache(case):
    """S == ctx: two decode steps, each writing over the oldest token's
    ring slot in both packages; logits and caches after each."""
    cache = case.model.make_cache(B, S)
    rcache = case.ref.make_cache(B, S)
    logits, cache = case.model.prefill(case.params,
                                       {"tokens": t(case.tokens)}, cache)
    _, rcache = case.ref_prefill(case.rparams,
                                 {"tokens": jnp.asarray(case.tokens)},
                                 rcache)
    tok = case.tokens[:, :1]
    for pos in (S, S + 1):
        logits, cache = case.model.decode_step(case.params, t(tok), cache,
                                               pos)
        rlogits, rcache = case.ref_decode(case.rparams, jnp.asarray(tok),
                                          rcache, pos)
        case.close(logits, rlogits)
        case.close(cache["k"], rcache["k"])
        case.close(cache["v"], rcache["v"])
        tok = np.asarray(jnp.argmax(rlogits[:, -1], -1),
                         np.int32)[:, None]


def test_first_decode_equals_full_forward_when_prompt_is_shorter(case):
    """S < ctx: the port's prefill fills a ctx-slot cache (slots S.. zero),
    so the first decode step equals the reference's full forward over the
    S + 1 tokens (the reference's own S-slot ring overwrites token 0)."""
    ctx = 32
    logits, cache = case.model.prefill(case.params,
                                       {"tokens": t(case.tokens)},
                                       case.model.make_cache(B, ctx))
    assert cache["k"].shape[2] == ctx
    assert not cache["k"][:, :, S:].any() and cache["k"][:, :, :S].any()
    case.close(logits, case.ref_full(case.rparams,
                                     jnp.asarray(case.tokens)))
    nxt = case.tokens[:, -1:]
    step, _ = case.model.decode_step(case.params, t(nxt), cache, S)
    full = np.concatenate([case.tokens, nxt], axis=1)
    case.close(step, case.ref_full(case.rparams, jnp.asarray(full)))


@pytest.mark.parametrize("name", DENSE)
def test_serve_steps_greedy_tokens_match_reference_full_forward(name):
    """``make_serve_steps``: prefill then 4 greedy decode steps, against
    teacher-forced argmax of the reference's full forward (float32)."""
    case = Case(name, "float32")
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


def test_ring_keeps_the_reference_layout_when_prompt_fills_cache():
    kv = torch.arange(2 * 10).reshape(2, 10, 1, 1)
    for Tw in (3, 7, 10):
        slots = T._ring(kv, 10, Tw)[0, :, 0, 0].tolist()
        assert all(tok % Tw == j for j, tok in enumerate(slots))
    short = T._ring(kv, 10, 16)[0, :, 0, 0].tolist()
    assert short == list(range(10)) + [0] * 6


def test_entry_points_need_a_card_or_device_cpu():
    cfg = SMOKE["qwen3-0.6b"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_serve_steps(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).make_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(cfg).init(torch.Generator())


def test_params_from_jax_go_to_the_card_unless_asked():
    """No ``device`` means the card; without one ``params_from_jax`` raises
    as ``resolve_device`` does, rather than placing weights on the CPU."""
    tree = {"embed": np.ones((4, 2), np.float32),
            "layers": {"w": np.zeros((2, 3, 3), np.float32)}}
    if torch.cuda.is_available():
        assert params_from_jax(tree)["layers"]["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree)
    cpu = params_from_jax(tree, device="cpu")
    assert cpu["embed"].device.type == "cpu"
    assert torch.equal(cpu["layers"]["w"], torch.zeros((2, 3, 3)))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_moe_stacks_build_with_param_count_total(name):
    """The MoE configs build, and their init holds ``param_count``'s total
    plus what it leaves out: each layer's fp32 router and the final
    norm."""
    cfg = SMOKE[name]
    p = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    n = sum(v.numel() for v in jax.tree.leaves(
        p, is_leaf=lambda v: torch.is_tensor(v)))
    total, _ = cfg.param_count()
    assert n == total + cfg.n_layers * cfg.d_model * cfg.n_experts \
        + cfg.d_model
    assert p["layers"]["moe"]["router"].dtype == torch.float32
