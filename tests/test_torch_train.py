"""The port's training path (``Model.loss``, ``optim.adamw``,
``launch.steps.make_train_step``) against the reference package on the
dense SMOKE configs in float32.

Both packages get the same parameters (the reference's ``init``, carried
across by ``convert.params_from_jax``; for the gradient check every norm
scale and bias is perturbed so that those leaves count), the same optimizer
state (``convert.opt_state_from_jax``) and the same tokens from a numpy
seed. The reference runs on the CPU through ``jax.jit``; the port's
attention runs its plain versions (``flash_ref`` forward, ``flash_bwd_ref``
backward through ``FlashAttention``).

Tolerances, each for its reason:
* loss and gradients: ``max |port - ref| <= 1e-4 * max |ref|`` per leaf
  (fp32 sums in another order; measured about 1e-6);
* one AdamW step: the same fp32 formulas, so only the global norm's sum
  order differs: the norm within 1e-5, and with it the clip scale, which
  the moments carry (m with it, v with its square), so m and v within
  1e-5; fp32 params within 1e-6, bf16 params bit for bit;
* a train step with int8 compression: where the two packages' fp32
  gradients straddle a rounding boundary, one int8 quantum (1/127 of the
  leaf's max) flips, so its m is held within 1e-2 of the leaf's max;
* the 8-step trajectory at lr = 1e-2: the loss within 1e-5 at every step;
  the params after 8 steps within 5e-3 (lr / 2): Adam's early steps move
  an element whose gradient sits at the rounding level of its leaf by up
  to lr either way, so the params cannot be held tighter than that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as REF_SMOKE
from repro.models.model import build as ref_build
from repro.optim import adamw as ref_adamw
from repro_torch.configs import SMOKE
from repro_torch.convert import (opt_state_from_jax, opt_state_to_numpy,
                                 params_from_jax)
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build
from repro_torch.optim import adamw

# the dense decoder-only configs; qwen2-vl-72b on its text path (M-RoPE)
DENSE = ("qwen3-0.6b", "qwen3-1.7b", "starcoder2-3b", "qwen1.5-110b",
         "qwen2-vl-72b")
B, S = 2, 16


def perturb(rng, tree, key=None):
    """Norm scales and biases get noise, so that their initial ones and
    zeros do not hide a missing term."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in ("scale", "bq", "bk", "bv"):
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def make_batch(cfg, seed=0):
    """tests/test_models.py's text batch, as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def grads_of(model, params, batch):
    """The port's (loss, metrics, grads) by ``backward()``."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch)
    loss.backward()
    return loss, metrics, adamw.tree_map(lambda p: p.grad, leaves)


def rel_close(out, ref, rel, path=""):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, path
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, (path, err, scale)


def each_leaf(fn, port_tree, ref_tree):
    """``fn(port leaf, reference leaf, path)`` for every leaf, matched by
    name; both trees hold the same names."""
    flat = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert len(list(adamw.leaves(port_tree))) == len(flat)
    for path, ref in flat:
        out = port_tree
        for key in path:
            out = out[key.key]
        fn(out, ref, jax.tree_util.keystr(path))


class Case:
    """One dense SMOKE config in float32: both packages' models and the
    reference's parameters, as numpy."""

    def __init__(self, name: str):
        self.rcfg = REF_SMOKE[name].scaled(dtype="float32")
        self.cfg = SMOKE[name].scaled(dtype="float32")
        self.ref = ref_build(self.rcfg)
        self.model = build(self.cfg, "cpu")
        self.batch = make_batch(self.cfg)


@pytest.fixture(scope="module", params=DENSE)
def case(request):
    return Case(request.param)


def test_loss_and_every_gradient_leaf_match_reference(case):
    np_params = perturb(np.random.default_rng(3),
                        np_tree(case.ref.init(jax.random.key(0))))
    (rl, rm), rg = jax.jit(jax.value_and_grad(case.ref.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jbatch(case.batch))
    loss, metrics, grads = grads_of(
        case.model, params_from_jax(np_params, device="cpu"),
        tbatch(case.batch))
    np.testing.assert_allclose(loss.item(), float(rl), rtol=1e-5)
    assert set(metrics) == set(rm) == {"nll", "aux", "zloss"}
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(rm[k]),
                                   rtol=1e-5, atol=1e-7)
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p), grads, np_tree(rg))


def test_loss_trajectory_matches_reference(case):
    """tests/test_models.py::test_loss_decreases on both packages, step by
    step: 8 steps of ``loss`` + ``adamw.apply(lr=1e-2)`` on one batch."""
    rp = case.ref.init(jax.random.key(1))
    params = params_from_jax(np_tree(rp), device="cpu")
    ro, opt = ref_adamw.init(rp), adamw.init(params)

    def one(p, o, b):
        (loss, _), g = jax.value_and_grad(case.ref.loss, has_aux=True)(p, b)
        p, o, _ = ref_adamw.apply(p, g, o, lr=1e-2)
        return p, o, loss

    ref_step = jax.jit(one)
    rb, tb = jbatch(case.batch), tbatch(case.batch)
    losses = []
    for _ in range(8):
        rp, ro, rl = ref_step(rp, ro, rb)
        loss, _, grads = grads_of(case.model, params, tb)
        params, opt, _ = adamw.apply(params, grads, opt, lr=1e-2)
        np.testing.assert_allclose(loss.item(), float(rl), rtol=0,
                                   atol=1e-5)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert int(opt.step) == int(ro.step) == 8
    each_leaf(lambda o, r, p: np.testing.assert_allclose(
        o.numpy(), r, rtol=0, atol=5e-3, err_msg=p), params, np_tree(rp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_adamw_apply_matches_reference(dtype):
    """From the same params, grads and a state one step in (so that the
    bias corrections count), with the cosine schedule's lr; bf16 params
    come back rounded to bf16, bit for bit."""
    rng = np.random.default_rng(4)
    rcfg = REF_SMOKE["qwen3-0.6b"].scaled(dtype=dtype)
    rp = ref_build(rcfg).init(jax.random.key(0))
    rg = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01, p.dtype), rp)
    _, ro, _ = ref_adamw.apply(rp, rg, ref_adamw.init(rp))
    new_rp, new_ro, rnorm = ref_adamw.apply(rp, rg, ro)

    params = params_from_jax(np_tree(rp), device="cpu")
    grads = params_from_jax(np_tree(rg), device="cpu")
    opt = opt_state_from_jax(np_tree(ro), device="cpu")
    new_p, new_o, gnorm = adamw.apply(params, grads, opt)
    np.testing.assert_allclose(float(gnorm), float(rnorm), rtol=1e-5)
    assert int(new_o.step) == int(new_ro.step) == 2
    want = np_tree(new_rp)
    if dtype == "bfloat16":
        each_leaf(lambda o, r, p: np.testing.assert_array_equal(
            o.view(torch.int16).numpy(), r.view(np.int16), err_msg=p),
            new_p, want)
    else:
        each_leaf(lambda o, r, p: np.testing.assert_allclose(
            o.numpy(), r, rtol=1e-6, atol=1e-6, err_msg=p), new_p, want)
    for field in ("m", "v"):
        each_leaf(lambda o, r, p: np.testing.assert_allclose(
            o.numpy(), r, rtol=1e-5, atol=1e-12, err_msg=p),
            getattr(new_o, field), np_tree(getattr(new_ro, field)))


@pytest.mark.parametrize("step", [0, 199, 200, 10000])
def test_cosine_lr_matches_reference(step):
    got = adamw.cosine_lr(torch.tensor(step, dtype=torch.int32))
    want = ref_adamw.cosine_lr(jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_grad_compression_error_feedback():
    """tests/test_runtime.py::test_grad_compression_error_feedback on the
    port."""
    grads = {"w": torch.from_numpy(np.random.default_rng(0)
                                   .standard_normal((64, 64))
                                   .astype(np.float32))}
    ef = adamw.tree_map(torch.zeros_like, grads)
    q, s, resid = adamw.compress_grads(grads, ef)
    deq = adamw.tree_map(adamw.dequantize_int8, q, s)
    err1 = float((deq["w"] - grads["w"]).abs().max())
    assert err1 < float(s["w"]) + 1e-6          # bounded by one quantum
    q2, s2, resid2 = adamw.compress_grads(grads, resid)
    deq2 = adamw.tree_map(adamw.dequantize_int8, q2, s2)
    two_round = (deq["w"] + deq2["w"]).numpy() / 2
    base = grads["w"].numpy()
    assert np.abs(two_round - base).mean() < np.abs(
        deq["w"].numpy() - base).mean()


def test_compress_grads_matches_reference():
    """Two rounds with error feedback on both packages: the same int8
    payload and scales, residuals within 1e-7 (one fp32 rounding)."""
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((64, 64)).astype(np.float32),
         "b": {"c": (rng.standard_normal((33,)) * 1e-3).astype(np.float32)}}
    rg, tg = jax.tree.map(jnp.asarray, g), adamw.tree_map(torch.from_numpy, g)
    ref_ef = jax.tree.map(jnp.zeros_like, rg)
    ef = adamw.tree_map(torch.zeros_like, tg)
    for _ in range(2):
        rq, rs, ref_ef = ref_adamw.compress_grads(rg, ref_ef)
        q, s, ef = adamw.compress_grads(tg, ef)
        each_leaf(lambda o, r, p: np.testing.assert_array_equal(
            o.numpy(), r, err_msg=p), q, np_tree(rq))
        each_leaf(lambda o, r, p: np.testing.assert_allclose(
            o.numpy(), r, rtol=1e-7, err_msg=p), s, np_tree(rs))
        each_leaf(lambda o, r, p: np.testing.assert_allclose(
            o.numpy(), r, rtol=0, atol=1e-7, err_msg=p), ef, np_tree(ref_ef))


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference_step(compress):
    """``make_train_step``'s step (the cosine schedule's lr, and with
    ``compress`` the int8 round trip) against the reference's step body,
    ``value_and_grad`` + ``compress_grads`` + ``adamw.apply``, two steps
    on qwen3-0.6b's SMOKE config."""
    c = Case("qwen3-0.6b")
    model, step, p_shapes, opt_shapes = make_train_step(
        c.cfg, device="cpu", compress_grads=compress)
    rp = c.ref.init(jax.random.key(0))
    ro = ref_adamw.init(rp, compress=compress)

    @jax.jit
    def ref_step(p, o, b):
        (loss, _), g = jax.value_and_grad(c.ref.loss, has_aux=True)(p, b)
        if compress:
            q, s, ef = ref_adamw.compress_grads(g, o.ef)
            g = jax.tree.map(ref_adamw.dequantize_int8, q, s)
            o = o._replace(ef=ef)
        p, o, gnorm = ref_adamw.apply(p, g, o)
        return p, o, loss, gnorm

    params = params_from_jax(np_tree(rp), device="cpu")
    opt = opt_state_from_jax(np_tree(ro), device="cpu")
    assert (opt.ef is None) == (opt_shapes.ef is None) == (not compress)
    for i in range(2):
        batch = make_batch(c.cfg, seed=i)
        rp, ro, rl, rn = ref_step(rp, ro, jbatch(batch))
        params, opt, metrics = step(params, opt, tbatch(batch))
        np.testing.assert_allclose(float(metrics["loss"]), float(rl),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["gnorm"]), float(rn),
                                   rtol=1e-4)
        assert {"loss", "gnorm", "nll", "aux", "zloss"} <= set(metrics)
    each_leaf(lambda o, r, p: np.testing.assert_allclose(
        o.numpy(), r, rtol=0, atol=1e-6, err_msg=p), params, np_tree(rp))
    back = opt_state_to_numpy(opt)
    assert int(back.step) == 2
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-2 if compress else 1e-4,
                                        p), opt.m, np_tree(ro.m))


def test_abstract_params_and_input_specs_match_reference(case):
    """Meta tensors name for name, shape and dtype as the reference's
    ``ShapeDtypeStruct``s; the train, prefill and decode specs of every
    input (qwen2-vl's ``patches`` too)."""
    ref_shapes = case.ref.abstract_params()
    mine = case.model.abstract_params()
    each_leaf(lambda o, r, p: (o.device.type == "meta"
                               and tuple(o.shape) == tuple(r.shape)
                               and str(o.dtype) == f"torch.{r.dtype}")
              or pytest.fail(p), mine, ref_shapes)
    for mode in ("train", "prefill", "decode"):
        ref = case.ref.input_specs(32, 4, mode)
        got = case.model.input_specs(32, 4, mode)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}
