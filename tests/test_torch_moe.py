"""The port's MoE (``repro_torch.models.moe`` and the MoE branches of the
decoder stack) against the reference package on the two MoE SMOKE configs,
deepseek-moe-16b (shared experts, top-2 of 8 at SMOKE size) and
mixtral-8x7b (top-2 of 8, GQA, a sliding window).

Both packages get the same parameters (the reference's ``init``, carried
across by ``convert.params_from_jax``, norm scales perturbed so that they
count) and the same inputs from a numpy seed. The reference's MoE is plain
``jnp`` (no Pallas on its path) and runs on the CPU as its own tests run
it.

Tolerances: ``moe_fwd`` in float32 within rtol = atol = 1e-5 on y and
1e-6 on aux; the loss and every gradient leaf within 1e-4 of the leaf's
max; the float32 stack elementwise within 1e-4 (``test_torch_models``'s).
In bfloat16, ``moe_fwd`` on identical inputs and the whole stack are held
to ``test_torch_models``'s bf16 criterion, ``max |port - ref| <= 2e-2 *
max |ref|``. The two packages' bf16 hidden states differ by rounding, so
a router score within that rounding of the next expert's would pick
another expert in the other package and move that token's output past
the criterion; at these seeds the stack holds to it. The MoE block is
also held on identical inputs, where the kept pairs must be the
reference's.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import repro.models.moe as RM
from repro.configs import SMOKE as REF_SMOKE
from repro.models import layers as RL
from repro.models.model import build as ref_build
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.launch import train
from repro_torch.launch.steps import make_serve_steps, make_train_step
from repro_torch.models import moe as M
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager

MOE = ("deepseek-moe-16b", "mixtral-8x7b")
B, S = 2, 12


def perturb(rng, tree, key=None):
    """Norm scales get noise, so that their initial ones do not hide a
    missing term."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key != "scale":
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def layer0(tree):
    """Layer 0's leaves of a stacked ``[L, ...]`` tree."""
    if isinstance(tree, dict):
        return {k: layer0(v) for k, v in tree.items()}
    return tree[0]


class Case:
    """One (config, dtype): both packages' models, the same parameters, a
    prompt, and the reference's jitted entry points."""

    def __init__(self, name: str, dtype: str):
        self.name, self.dtype = name, dtype
        self.rcfg = REF_SMOKE[name].scaled(dtype=dtype)
        self.cfg = SMOKE[name].scaled(dtype=dtype)
        self.ref = ref_build(self.rcfg)
        self.model = build(self.cfg, "cpu")
        rng = np.random.default_rng(21)
        tree = jax.tree.map(np.asarray, self.ref.init(jax.random.key(3)))
        self.np_params = perturb(rng, tree)
        self.rparams = jax.tree.map(jnp.asarray, self.np_params)
        self.params = params_from_jax(self.np_params, device="cpu")
        self.np_moe = layer0(self.np_params["layers"]["moe"])
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
        """The stack's tolerances, test_torch_models's."""
        out = out.float().numpy() if torch.is_tensor(out) else out
        ref = np.asarray(ref, np.float32)
        assert out.shape == ref.shape
        if self.dtype == "float32":
            np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        else:
            err, scale = np.abs(out - ref).max(), np.abs(ref).max()
            assert err <= 2e-2 * scale, (err, scale)


@pytest.fixture(scope="module", params=[(n, d) for n in MOE
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    return Case(*request.param)


@pytest.fixture(scope="module", params=MOE)
def case32(request):
    return Case(request.param, "float32")


def ref_routing(np_moe, rcfg, x):
    """The reference's ``moe_fwd(x)`` with its own dispatch tensor read:
    ``dispatch [T, E, C]`` is the first operand pair of its
    ``einsum("td,tec->ecd")``. Returns (y, aux, dispatch) as numpy."""
    seen = {}
    einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "td,tec->ecd":
            seen["dispatch"] = np.asarray(ops[1])
        return einsum(spec, *ops, **kw)

    with mock.patch.object(RM.jnp, "einsum", spy):
        y, aux = RM.moe_fwd(jax.tree.map(jnp.asarray, np_moe), rcfg, x)
    return np.asarray(y, np.float32), float(aux), seen["dispatch"]


def kept_pairs(gate_idx, dispatch):
    """{(t, k): slot} of the pairs that ``dispatch [T, E, C]`` routes,
    by their experts ``gate_idx [T, K]``."""
    out = {}
    for (tk, e) in np.ndenumerate(np.asarray(gate_idx)):
        row = dispatch[tk[0], e]
        if row.any():
            out[tk] = int(row.argmax())
    return out


def port_kept(r):
    keep, slot = r.keep.numpy(), r.slot.numpy()
    return {tk: int(slot[tk]) for tk in zip(*np.nonzero(keep))}


def moe_inputs(case, x_np):
    dt = case.dtype
    x_t = t(x_np).to(getattr(torch, dt))
    return x_t, jnp.asarray(x_np, dt), params_from_jax(case.np_moe,
                                                       device="cpu")


def check_moe(case, y, aux, ry, raux):
    if case.dtype == "float32":
        np.testing.assert_allclose(y.float().numpy(), ry, rtol=1e-5,
                                   atol=1e-5)
    else:
        case.close(y, ry)
    np.testing.assert_allclose(float(aux), raux, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(B, S), (1, 3), (4, 1)],
                         ids=["prefill", "short", "decode"])
def test_moe_fwd_matches_reference(case, shape):
    """y and aux of one MoE block on the same x; the same pairs kept, in
    the same slots, as the reference's own dispatch tensor."""
    rng = np.random.default_rng(sum(shape))
    x_np = rng.standard_normal(shape + (case.cfg.d_model,)).astype(
        np.float32)
    x_t, x_r, p = moe_inputs(case, x_np)
    y, aux = M.moe_fwd(p, case.cfg, x_t)
    ry, raux, dispatch = ref_routing(case.np_moe, case.rcfg, x_r)
    assert y.dtype == x_t.dtype and y.shape == x_t.shape
    check_moe(case, y, aux, ry, raux)
    r = M.route(p, case.cfg, x_t.reshape(-1, case.cfg.d_model))
    assert port_kept(r) == kept_pairs(r.gate_idx.numpy(), dispatch)


@pytest.mark.parametrize("name", MOE)
def test_capacity_drops_the_reference_pairs(name):
    """One router column biased so that nearly every token picks expert 0:
    T=64 at top-2 of 8 gives C=20, so capacity drops most of expert 0's
    pairs; the port keeps the pairs the reference keeps, in the same
    slots, and y and aux agree (float32)."""
    case = Case(name, "float32")
    rng = np.random.default_rng(7)
    d, E = case.cfg.d_model, case.cfg.n_experts
    case.np_moe = dict(case.np_moe)
    router = case.np_moe["router"].copy()
    router[:, 0] += 8.0 / d
    case.np_moe["router"] = router
    x_np = (rng.standard_normal((4, 16, d)) + 1.0).astype(np.float32)
    x_t, x_r, p = moe_inputs(case, x_np)
    r = M.route(p, case.cfg, x_t.reshape(-1, d))
    assert r.capacity == 20 == M.capacity(64, E, case.cfg.moe_top_k, 1.25)
    dropped = int((~r.keep).sum())
    assert dropped > 0 and bool((r.gate_idx == 0).any(-1).all())
    y, aux = M.moe_fwd(p, case.cfg, x_t)
    ry, raux, dispatch = ref_routing(case.np_moe, case.rcfg, x_r)
    assert port_kept(r) == kept_pairs(r.gate_idx.numpy(), dispatch)
    assert len(port_kept(r)) == 64 * case.cfg.moe_top_k - dropped
    check_moe(case, y, aux, ry, raux)


def test_moe_dispatch_capacity():
    """``tests/test_models.py::test_moe_dispatch_capacity`` on the port:
    its own init, bf16 input; the shape, finite, aux > 0."""
    cfg = SMOKE["mixtral-8x7b"]
    p = M.moe_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    y, aux = M.moe_fwd(p, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())
    assert float(aux) > 0


@settings(max_examples=40, deadline=None, derandomize=True)
@given(T=st.integers(1, 48), E=st.integers(2, 12), K=st.integers(1, 4),
       cf=st.sampled_from([0.25, 0.5, 1.0, 1.25, 2.0]),
       shared=st.booleans())
@example(T=4, E=8, K=2, cf=1.25, shared=False)     # decode: C = 8 > T
@example(T=16, E=8, K=2, cf=4.0, shared=True)      # C = T
@example(T=40, E=4, K=4, cf=1.0, shared=False)     # every expert, C = T
def test_index_route_equals_onehot(T, E, K, cf, shared):
    """``moe_fwd`` (index route) == ``moe_fwd_onehot`` (the reference's
    one-hot dispatch) on random inputs: y within 1e-5 of its max (fp32
    sums over the kept pairs in another order), aux bit for bit, and the
    kept pairs and their slots those of the one-hot."""
    K = min(K, E)
    cfg = SMOKE["mixtral-8x7b"].scaled(
        dtype="float32", d_model=16, d_ff_expert=24, n_experts=E,
        moe_top_k=K, n_shared_experts=int(shared))
    g = torch.Generator().manual_seed(T * 1000 + E * 10 + K)
    p = M.moe_init(g, cfg, "cpu")
    x = torch.randn((1, T, cfg.d_model), generator=g)
    y, aux = M.moe_fwd(p, cfg, x, cf)
    y1, aux1 = M.moe_fwd_onehot(p, cfg, x, cf)
    assert torch.equal(aux, aux1)
    err, scale = float((y - y1).abs().max()), float(y1.abs().max())
    assert err <= 1e-5 * max(scale, 1e-30), (err, scale)
    r = M.route(p, cfg, x[0], cf)
    assert r.capacity == M.capacity(T, E, K, cf)
    oh = M.onehot_slots(r.gate_idx, E, r.capacity)        # [T, K, E, C]
    assert torch.equal(r.keep, oh.sum((2, 3)) > 0)
    assert torch.equal(r.slot[r.keep],
                       oh.sum(2).argmax(-1)[r.keep])


def test_loss_and_gradients_match_reference(case32):
    """``Model.loss`` (nll, aux, zloss, total) and every gradient leaf
    against ``jax.value_and_grad`` of the reference's ``Model.loss`` in
    float32: the aux term and the differentiable dispatch (the scatter, the
    gather and the gates) within 1e-4 of each leaf's max."""
    case = case32
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, case.cfg.vocab, (B, 16)).astype(np.int32)
    labels = rng.integers(0, case.cfg.vocab, (B, 16)).astype(np.int32)
    (rtotal, rparts), rgrads = jax.jit(jax.value_and_grad(
        case.ref.loss, has_aux=True))(
        case.rparams, {"tokens": jnp.asarray(tokens),
                       "labels": jnp.asarray(labels)})
    leaves = adamw.tree_map(lambda p: p.detach().clone().requires_grad_(),
                            case.params)
    total, parts = case.model.loss(leaves, {"tokens": t(tokens),
                                            "labels": t(labels)})
    total.backward()
    assert float(parts["aux"].detach()) > 0
    for k in ("nll", "aux", "zloss"):
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(rparts[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(rtotal),
                               rtol=1e-5, atol=1e-6)
    flat = jax.tree_util.tree_leaves_with_path(rgrads)
    mine = []
    adamw.tree_map(lambda p: mine.append(p.grad), leaves)
    assert len(mine) == len(flat)
    for (path, rg), g in zip(flat, mine):
        rg = np.asarray(rg, np.float32)
        err = np.abs(g.numpy() - rg).max()
        assert err <= 1e-4 * max(np.abs(rg).max(), 1e-12), (path, err)


@pytest.mark.parametrize("ctx", [8, S])
def test_prefill_matches_reference_when_prompt_fills_cache(case, ctx):
    """S >= ctx: last-token logits and every layer's K/V cache."""
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
    """S == ctx: two decode steps (T = B tokens, C = 8 > T, every expert
    on 8 rows), logits and caches after each."""
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


def no_drops(cfg):
    """Both packages' ``moe_fwd`` at capacity factor E/K, so C = T and
    capacity drops nothing."""
    cf = cfg.n_experts / cfg.moe_top_k
    return (mock.patch.object(M, "moe_fwd",
                              functools.partial(M.moe_fwd,
                                                capacity_factor=cf)),
            mock.patch.object(RM, "moe_fwd",
                              functools.partial(RM.moe_fwd,
                                                capacity_factor=cf)))


def test_first_decode_equals_full_forward_when_prompt_is_shorter(case):
    """S < ctx: the prefill's logits equal the reference's full forward
    over the S tokens (the same batch, so the same drops), and the first
    decode step equals its full forward over the S + 1 tokens. That full
    forward routes another batch (T = B(S+1), another capacity), so at
    capacity factor 1.25 it may drop other pairs than prefill and decode
    do; both packages run this comparison at C = T, where nothing drops."""
    ctx = 32
    logits, cache = case.model.prefill(case.params,
                                       {"tokens": t(case.tokens)},
                                       case.model.make_cache(B, ctx))
    assert cache["k"].shape[2] == ctx
    assert not cache["k"][:, :, S:].any() and cache["k"][:, :, :S].any()
    case.close(logits, case.ref_full(case.rparams,
                                     jnp.asarray(case.tokens)))
    nxt = case.tokens[:, -1:]
    full = np.concatenate([case.tokens, nxt], axis=1)
    port_cf, ref_cf = no_drops(case.cfg)
    with port_cf, ref_cf:
        _, cache = case.model.prefill(case.params,
                                      {"tokens": t(case.tokens)},
                                      case.model.make_cache(B, ctx))
        step, _ = case.model.decode_step(case.params, t(nxt), cache, S)
        ref = jax.jit(case._ref_full)(case.rparams, jnp.asarray(full))
    case.close(step, ref)


@pytest.mark.parametrize("name", MOE)
def test_serve_steps_greedy_tokens_match_reference_full_forward(name):
    """``make_serve_steps``: prefill then 4 greedy decode steps, against
    teacher-forced argmax of the reference's full forward (float32), both
    at C = T (see the test above)."""
    case = Case(name, "float32")
    _, prefill_step, decode_step = make_serve_steps(case.cfg, device="cpu")
    port_cf, ref_cf = no_drops(case.cfg)
    with port_cf, ref_cf:
        cache = case.model.make_cache(B, 32)
        logits, cache = prefill_step(case.params,
                                     {"tokens": t(case.tokens)}, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        mine = [tok]
        for i in range(4):
            tok, cache = decode_step(case.params, tok, cache, S + i)
            assert tok.dtype == torch.int32 and tok.shape == (B, 1)
            mine.append(tok)
        ref_full = jax.jit(case._ref_full)
        seq = case.tokens
        for i in range(5):
            nxt = np.asarray(jnp.argmax(ref_full(
                case.rparams, jnp.asarray(seq))[:, -1], -1),
                np.int32)[:, None]
            np.testing.assert_array_equal(mine[i].numpy(), nxt)
            seq = np.concatenate([seq, nxt], axis=1)


@pytest.mark.parametrize("name", MOE)
def test_abstract_params_match_reference_eval_shape(name):
    """``abstract_params`` (meta tensors, nothing drawn): the reference's
    ``jax.eval_shape`` of its init, leaf for leaf in shape and dtype."""
    ref = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                       ref_build(REF_SMOKE[name]).abstract_params())
    mine = build(SMOKE[name], "cpu").abstract_params()
    assert all(v.device.type == "meta" for v in _leaves(mine))
    mine = jax.tree.map(lambda v: (tuple(v.shape),
                                   str(v.dtype).replace("torch.", "")), mine)
    assert mine == ref


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("name", MOE)
def test_init_fills_stacked_leaves_in_draw_order(name):
    """``_stack_init`` fills each stacked leaf in place: layer i of the
    stacked init equals the i-th layer drawn alone from the same
    generator, after the embedding's draws."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = SMOKE[name]
    p = build(cfg, "cpu").init(torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    L.embed_init(g, cfg, "cpu")
    for i in range(cfg.n_layers):
        one = T.dense_block_init(g, cfg, "cpu")
        for a, b in zip(_leaves(one), _leaves(p["layers"])):
            assert torch.equal(a, b[i])


@pytest.mark.parametrize("name", MOE)
def test_make_train_step_takes_moe_configs(name):
    """One ``train_step`` on a MoE SMOKE config: every leaf gets a
    gradient, the router and the experts move, the loss carries aux."""
    model, step, p_shapes, _ = make_train_step(SMOKE[name], device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw.init(params)
    rng = np.random.default_rng(3)
    tok = t(rng.integers(0, model.cfg.vocab, (B, 16)).astype(np.int32))
    new, opt, metrics = step(params, opt, {"tokens": tok, "labels": tok})
    assert float(metrics["aux"]) > 0
    assert np.isfinite(float(metrics["loss"]))
    moe, moe1 = params["layers"]["moe"], new["layers"]["moe"]
    for k in ("router", "wi", "wo"):
        assert not torch.equal(moe[k], moe1[k]), k


def test_train_cli_trains_mixtral_smoke(tmp_path, capsys):
    """``--arch mixtral-8x7b --smoke --device cpu`` trains and
    checkpoints (it raised before MoE was ported)."""
    train.main(["--arch", "mixtral-8x7b", "--smoke", "--seq", "16",
                "--batch", "2", "--steps", "2", "--ckpt-every", "2",
                "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert CheckpointManager(tmp_path).latest_step() == 2
