"""Tensor parallelism over the ``model`` axis for the stacks that are not
plain decoders (zamba2-7b's Mamba2 hybrid, xlstm-125m, whisper-medium's
encoder-decoder: ``models/ssm.py``'s ``tp_mamba2_fwd``, ``tp_mlstm_fwd``
and ``tp_slstm_fwd``, ``models/transformer.py``'s ``tp_zamba2_fwd``,
``tp_xlstm_fwd`` and ``tp_encoder_fwd``/``tp_encdec_*``) and for the
sequence-sharded K/V cache (``REPRO_KV_SHARD=seq``: ``layers.seq_partial``
and ``tensor_parallel.Group.join``), through ``make_train_step(cfg, mesh)``
and ``make_serve_steps(cfg, mesh)``, on the CPU in float32 at SMOKE size.

As in ``tests/test_torch_tensor_parallel.py`` (whose helpers, batch and
tolerances these are), a train step is held against the reference's
single-device ``value_and_grad`` and ``adamw.apply`` on the full batch,
with the reference's parameters (norm scales and biases perturbed)
carried across by ``convert.params_from_jax``: the loss within rtol
1e-5, gnorm 1e-4, every gradient leaf joined from the blocks AdamW was
handed within 1e-4 of its max, the moments within 1e-4, the data and
model replicas bit-equal, and the params within 1e-6 of the reference's
``adamw.apply`` of those gradients. (Not of the reference's own
gradients: AdamW's first step moves an element by about lr x sign(g), 2 x
1.5e-6 apart across a sign, so it turns an element whose gradient lies
within float32 rounding of zero into a 3e-6 difference. zamba2's SMOKE
stack amplifies rounding about a thousandfold: evaluated in float64,
its gradients over 2 and 4 shards agree with one device's within 2e-13
of a leaf's max; in float32 within about 1e-4, as the one-device port
agrees with the reference, and one element in 50 000 of an MLP leaf
lands within that of zero.) Mamba2's ``A_log``, ``dt_bias`` and ``D`` and the norm scales are
perturbed per head in the block tests, one layer each, within 1e-5 of a
leaf's max (``tests/test_torch_ssm.py``'s block tolerance).

A serve step is held against the reference's single-device prefill and
greedy decode on the same params and prompt (``reference_serve``): the
prefill's logits within 1e-4 of their max (the port's one-device
tolerance against the reference in ``tests/test_torch_ssm.py``: zamba2's
SMOKE stack sits 1.2e-5 from it over 2 shards, 6e-6 on one device) and
the greedy tokens equal. It is held too against the same rows served on
one device a data shard: the logits within 1e-5 of their max, the greedy
tokens equal, and each cache block on its slice of the one-device cache
within 1e-4 of the leaf's max (a block in the wrong place is off by the
leaf's own size).

Meshes: (1, 2), (1, 4) and (2, 2). At SMOKE, zamba2's fused ``in_proj``
(280 columns: ``z`` 128, ``x`` 128, ``B`` 8, ``C`` 8, ``dt`` 8) splits in
blocks of 140 or 70 whose edges fall inside ``x`` and ``z``; SMOKE's
xLSTM (d 64) keeps sLSTM's ``wi``/``wf`` whole by the guard, so one case
at d 512 splits them.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as REF_SMOKE
from repro.models import layers as RL
from repro.models.model import build as ref_build
from repro.optim import adamw as ref_adamw
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import steps
from repro_torch.models import float64 as F64
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.model import build
from repro_torch.optim import adamw
from test_torch_tensor_parallel import (blocks_differ, each_leaf, mesh_of,
                                        np_tree, placed, rel_close)

B, S = 4, 16
PERTURBED = ("scale", "bq", "bk", "bv")
WIDE_XLSTM = (("d_model", 512), ("d_head", 128), ("n_layers", 2),
              ("slstm_every", 2))


def perturb(rng, tree, key=None):
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in PERTURBED:
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def cfgs(name, scale=()):
    return (SMOKE[name].scaled(dtype="float32", **dict(scale)),
            REF_SMOKE[name].scaled(dtype="float32", **dict(scale)))


def make_batch(cfg, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)
    if cfg.enc_dec:
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference_step(name, scale=()):
    """The reference's loss, gradients, and moments and gnorm after
    ``adamw.apply``, on the full batch."""
    cfg, rcfg = cfgs(name, scale)
    ref = ref_build(rcfg)
    np_params = perturb(np.random.default_rng(3),
                        np_tree(ref.init(jax.random.key(0))))
    rp = jax.tree.map(jnp.asarray, np_params)
    batch = make_batch(cfg)
    (rl, _), rg = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    _, ro2, rn = ref_adamw.apply(rp, rg, ref_adamw.init(rp))
    return np_params, batch, float(rl), np_tree(rg), np_tree(ro2.m), float(rn)


TRAIN_CASES = [("zamba2-7b", 1, 2, ()), ("zamba2-7b", 1, 4, ()),
               ("zamba2-7b", 2, 2, ()), ("xlstm-125m", 1, 2, ()),
               ("xlstm-125m", 1, 4, ()), ("xlstm-125m", 1, 4, WIDE_XLSTM),
               ("whisper-medium", 1, 2, ()), ("whisper-medium", 1, 4, ())]


@pytest.mark.parametrize("name,D,M,scale", TRAIN_CASES)
def test_tp_train_step_matches_full_batch_reference(name, D, M, scale):
    """``make_train_step(cfg, mesh)`` on a (D, M) mesh of CPU shards
    against the reference's full-batch step: loss, gnorm, every gradient
    leaf joined from the blocks AdamW was handed, the moments after the
    step; the params after the step against the reference's
    ``adamw.apply`` of those gradients (see the module docstring); the
    step returns trees placed as it was given them, every block the shape
    its spec gives, the replicas bit-equal."""
    cfg, _ = cfgs(name, scale)
    np_params, batch, rl, rg, rm2, rn = reference_step(name, scale)
    mesh = mesh_of(D, M)
    _, step, p_shapes, _ = steps.make_train_step(cfg, mesh)
    P, O = placed(cfg, mesh, params_from_jax(np_params, device="cpu"),
                  p_shapes)
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    with mock.patch.object(adamw, "apply", spy):
        pr, orr, m = step(P, O, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    assert len(seen) == D * M
    np.testing.assert_allclose(float(m["loss"]), rl, rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), rn, rtol=1e-4)
    flat = [p for row in TP.grid(mesh) for p in row]
    grads = TP.assemble(P, dict(zip(flat, seen)))
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p),
              SH.gather_tree(grads), rg)
    rp = jax.tree.map(jnp.asarray, np_params)
    rp2, _, _ = ref_adamw.apply(rp, jax.tree.map(
        lambda r, g: jnp.asarray(g.numpy()), rp, SH.gather_tree(grads)),
        ref_adamw.init(rp))
    each_leaf(lambda o, r, p: np.testing.assert_allclose(
        o.numpy(), r, rtol=0, atol=1e-6, err_msg=p), SH.gather_tree(pr),
        np_tree(rp2))
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p),
              SH.gather_tree(orr.m), rm2)
    for new, old in zip(SH.tree_leaves(pr), SH.tree_leaves(P)):
        assert new.sharding is old.sharding
        for pos in np.ndindex(new.blocks.shape):
            want = tuple(len(range(*s.indices(n))) for s, n in zip(
                new.sharding.block(new.shape, pos), new.shape))
            assert tuple(new.blocks[pos].shape) == want
    assert blocks_differ(grads) == blocks_differ(pr) == 0
    assert blocks_differ(orr) == 0 and int(orr.step.gather()) == 1


@pytest.mark.parametrize("name,M", [("zamba2-7b", 4), ("xlstm-125m", 4),
                                    ("whisper-medium", 2)])
def test_tp_gradients_in_float64_equal_one_device(name, M):
    """Under ``float64.in_float64`` (the model code's float32 arithmetic in
    float64, attention on its plain version) the loss and every gradient
    leaf over (1, M) shards (``TP.shard_grads``) equal one device's
    within 1e-10 of a leaf's max: what is left of the float32 gap
    (zamba2's 4e-5 at SMOKE) is rounding. The yardstick ``chip_smoke.py``
    holds the full-width float32 steps to. Every gradient is float64, and
    the context puts ``Tensor.float``, ``torch.float32`` and the
    attention back on the way out."""
    cfg, _ = cfgs(name)
    cfg64 = cfg.scaled(dtype="float64")
    np_params, batch, *_ = reference_step(name)
    params = adamw.tree_map(lambda t: t.double(),
                            params_from_jax(np_params, device="cpu"))
    tb = {k: torch.from_numpy(v.astype(np.float64) if v.dtype.kind == "f"
                              else v) for k, v in batch.items()}
    model = build(cfg64, "cpu")
    mesh = mesh_of(1, M)
    saved = (torch.Tensor.float, torch.float32, L.flash_attention)
    with F64.in_float64():
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        loss1, _ = model.loss(leaves, tb)
        loss1.backward()
        P = SH.shard_tree(params, SH.to_named(
            mesh, SH.param_specs(cfg64, mesh, params)))
        _, losses, _, grads = TP.shard_grads(model.loss_tp, mesh, P, tb)
    assert (torch.Tensor.float, torch.float32, L.flash_attention) == saved
    assert torch.get_default_dtype() == torch.float32
    np.testing.assert_allclose(float(losses[0].detach()), float(loss1.detach()),
                               rtol=1e-12)
    got = SH.gather_tree(TP.assemble(P, dict(zip(TP.grid(mesh)[0],
                                                 grads[0]))))
    want = adamw.tree_map(lambda p: p.grad, leaves)
    for g, w in zip(adamw.leaves(got), adamw.leaves(want)):
        assert g.dtype == w.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-10 * float(w.abs().max())


def test_tp_split_leaves_are_split_where_the_cases_say():
    """What the cases above rely on: zamba2's ``in_proj`` blocks at M = 2
    and M = 4 have edges inside its fields, so the product is gathered;
    SMOKE's sLSTM ``wi``/``wf`` are whole and the d-512 case's are split,
    as its mLSTM gates stay whole; whisper's cross-attention and
    ``enc_out`` split on ``model``."""
    d_in, N = 128, 8
    edges = {d_in, 2 * d_in, 2 * d_in + N, 2 * d_in + 2 * N}
    for M in (2, 4):
        cfg, _ = cfgs("zamba2-7b")
        mesh = mesh_of(1, M)
        specs = SH.param_specs(cfg, mesh, build(cfg, "cpu")
                               .abstract_params())
        assert tuple(specs["super"]["mamba"]["in_proj"]) == (
            None, None, None, "model")
        width = (2 * d_in + 2 * N + 8) // M
        cuts = {width * m for m in range(1, M)}
        assert cuts and not cuts & edges
    for scale, split in (((), False), (WIDE_XLSTM, True)):
        cfg, _ = cfgs("xlstm-125m", scale)
        mesh = mesh_of(1, 4)
        specs = SH.param_specs(cfg, mesh, build(cfg, "cpu")
                               .abstract_params())
        s = specs["super"]["s"]["core"]
        assert ("model" in tuple(s["wi"])) == ("model" in tuple(s["wf"]))
        assert ("model" in tuple(s["wi"])) == split
        assert "model" not in tuple(specs["super"]["m"]["core"]["wi"])
    cfg, _ = cfgs("whisper-medium")
    mesh = mesh_of(1, 2)
    specs = SH.param_specs(cfg, mesh, build(cfg, "cpu")
                           .abstract_params())
    assert "model" in tuple(specs["dec_layers"]["cross"]["wk"])
    cache = build(cfg, "cpu").make_cache(B, 8, "cpu")
    assert tuple(SH.cache_specs(cfg, mesh, cache)["enc_out"]) == (
        "data", None, "model")


def test_scan_chunks_nest_in_the_reentrant_layer_checkpoint():
    """Under ``_tp_checkpoint`` (reentrant) a layer's forward runs without
    grad, so each scan runs once, whole and in place; the backward
    recomputes the layer with grad, each scan in its checkpointed chunks
    (``SCAN_CHUNK`` 5 over S = 16: 4 chunks), and each chunk's steps
    again in its own backward: a scan's steps run 1 + 2 x 4 times, one
    chunk's states held at a time. The loss and every gradient are bit
    for bit those of one chunk of 16."""
    name = "zamba2-7b"
    cfg, _ = cfgs(name)
    np_params, batch, rl, _, _, _ = reference_step(name)
    mesh = mesh_of(1, 2)
    P = SH.shard_tree(params_from_jax(np_params, device="cpu"),
                      SH.to_named(mesh, SH.param_specs(
                          cfg, mesh, build(cfg, "cpu")
                          .abstract_params())))
    calls = {"fwd": [], "bwd": []}
    phase = ["fwd"]
    steps_fn = SSM._mamba2_steps

    def spy(h, *seqs):
        calls[phase[0]].append(seqs[0].shape[1])
        return steps_fn(h, *seqs)

    model = build(cfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def grads(chunk):
        ps = [SH.tree_map(lambda t, _, m=m: t.blocks[0, m].detach()
                          .requires_grad_(), P) for m in range(2)]
        with mock.patch.object(SSM, "_mamba2_steps", spy), \
                mock.patch.object(SSM, "SCAN_CHUNK", chunk):
            phase[0] = "fwd"
            loss, _ = model.loss_tp(TP.Group(["cpu"] * 2), ps, tb)
            phase[0] = "bwd"
            loss.backward()
        return loss.detach(), [SH.tree_leaves(p) for p in ps]

    whole = grads(S)
    calls["fwd"].clear()
    calls["bwd"].clear()
    loss, leaves = grads(5)
    n_scans = cfg.n_layers * 2          # each layer's scan on each shard
    assert calls["fwd"] == [S] * n_scans
    assert sorted(calls["bwd"]) == sorted([5, 5, 5, 1] * 2 * n_scans)
    np.testing.assert_allclose(float(loss), rl, rtol=1e-5)
    assert torch.equal(loss, whole[0])
    for a, b in zip(leaves, whole[1]):
        for x, y in zip(a, b):
            assert torch.equal(x.grad, y.grad)


# The cores alone: one layer's ``tp_*`` against its one-device function,
# with every per-head leaf perturbed, from a random state or none.
CORES = {"mamba2": ("zamba2-7b", (), ("super", "mamba"), (0, 0),
                    SSM.mamba2_fwd, SSM.tp_mamba2_fwd),
         "mlstm": ("xlstm-125m", (), ("super", "m", "core"), (0, 0),
                   SSM.mlstm_fwd, SSM.tp_mlstm_fwd),
         "slstm": ("xlstm-125m", (), ("super", "s", "core"), (0,),
                   SSM.slstm_fwd, SSM.tp_slstm_fwd),
         "slstm_wide": ("xlstm-125m", WIDE_XLSTM, ("super", "s", "core"),
                        (0,), SSM.slstm_fwd, SSM.tp_slstm_fwd)}


def core_state(kind, cfg, rng):
    """A random state of the core (sLSTM's n positive), as the cache
    holds it."""
    d = cfg.d_model
    if kind == "mamba2":
        H = 2 * d // cfg.ssm_headdim
        return rng.standard_normal((B, H, cfg.ssm_state, cfg.ssm_headdim))
    if kind == "mlstm":
        H, dh = cfg.n_heads, d // cfg.n_heads
        return (rng.standard_normal((B, H, dh, dh)),
                rng.standard_normal((B, H, dh)))
    return rng.standard_normal((B, d)), 1 + rng.random((B, d))


def shard_state(kind, cfg, state, M, m):
    """Shard m's block of the state, as ``cache_specs`` splits it."""
    if kind in ("mamba2", "mlstm"):
        H = state.shape[1] if kind == "mamba2" else state[0].shape[1]
        h0, h1 = L.own_heads(H, M, m)
        return state[:, h0:h1] if kind == "mamba2" else tuple(
            t[:, h0:h1] for t in state)
    lo, hi = L.block_cols(cfg.d_model // M if cfg.d_model % M == 0
                          else cfg.d_model, cfg.d_model, m)
    return tuple(t[:, lo:hi] for t in state)


def join_state(kind, parts, whole):
    """The shards' final states joined as the cache holds them."""
    if kind == "mamba2":
        return parts[0] if parts[0].shape == whole.shape else torch.cat(
            parts, 1)
    return tuple(p[0] if p[0].shape == w.shape else torch.cat(p, 1)
                 for p, w in zip(zip(*parts), whole))


@pytest.mark.parametrize("kind,M,with_state", [
    ("mamba2", 2, False), ("mamba2", 4, True), ("mlstm", 2, True),
    ("mlstm", 4, False), ("slstm", 4, True), ("slstm_wide", 4, True)])
def test_tp_core_matches_one_device_core(kind, M, with_state):
    """``tp_mamba2_fwd``, ``tp_mlstm_fwd`` and ``tp_slstm_fwd`` over M
    shards against ``mamba2_fwd``, ``mlstm_fwd`` and ``slstm_fwd`` on one
    layer of the reference's parameters with every norm scale and
    Mamba2's ``A_log``, ``dt_bias`` and ``D`` perturbed (each head its
    own), x [B, S, d] random: the output (the shards' partial sums
    added), the final state joined from the shards' blocks, and the
    gradients of ``sum(y * w)`` with respect to every parameter leaf
    (each split leaf's blocks joined, each whole leaf's contributions
    added) and x, within 1e-5 of a leaf's max."""
    name, scale, path, idx, fwd, tp_fwd = CORES[kind]
    cfg, rcfg = cfgs(name, scale)
    rng = np.random.default_rng(21)
    np_params = np_tree(ref_build(rcfg).init(jax.random.key(6)))
    for k in path:
        np_params = np_params[k]
    np_params = {k: v[idx] for k, v in np_params.items() if k != "norm"} | \
        {"norm": {"scale": np_params["norm"]["scale"][idx]}}
    for k in ("A_log", "dt_bias", "D"):
        if k in np_params:
            np_params[k] = np_params[k] + 0.1 * rng.standard_normal(
                np_params[k].shape).astype(np.float32)
    np_params["norm"]["scale"] = np_params["norm"]["scale"] + 0.1 * \
        rng.standard_normal(np_params["norm"]["scale"].shape).astype(
            np.float32)
    p1 = adamw.tree_map(lambda t: t.requires_grad_(),
                        params_from_jax(np_params, device="cpu"))
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(
        np.float32))
    state = None
    if with_state:
        state = core_state(kind, cfg, rng)
        state = torch.from_numpy(state.astype(np.float32)) \
            if kind == "mamba2" else tuple(torch.from_numpy(
                t.astype(np.float32)) for t in state)
    y1, s1 = fwd(p1, cfg, x, state)
    (y1 * w).sum().backward()

    mesh = mesh_of(1, M)
    specs = SH.param_specs(cfg, mesh, build(cfg, "cpu").abstract_params())
    for k in path:
        specs = specs[k]
    specs = SH.tree_map(lambda sp, _: SH.P(*tuple(sp)[len(idx):]), specs)
    P = SH.shard_tree(params_from_jax(np_params, device="cpu"),
                      SH.to_named(mesh, specs))
    ps = [SH.tree_map(lambda t, _, m=m: t.blocks[0, m].detach()
                      .requires_grad_(), P) for m in range(M)]
    xs = [x.detach().clone().requires_grad_() for _ in range(M)]
    outs, st, split = tp_fwd(TP.Group(["cpu"] * M), ps, cfg, xs,
                             None if state is None else
                             [shard_state(kind, cfg, state, M, m)
                              for m in range(M)])
    y = sum(outs[1:], outs[0]) if split else outs[0]
    (y * w).sum().backward()
    rel_close(y, y1.detach().numpy(), 1e-5, "y")
    s2 = join_state(kind, st, s1)
    for a, b in zip(*(((s2,), (s1,)) if kind == "mamba2" else (s2, s1))):
        rel_close(a, b.detach().numpy(), 1e-5, "state")
    rel_close(sum(t.grad for t in xs), x.grad.numpy(), 1e-5, "x")
    flat = {}
    SH.tree_map(lambda t, p_: flat.__setitem__(p_, t), P)
    want = {}
    SH.tree_map(lambda t, p_: want.__setitem__(p_, t.grad), p1)
    for p_, t in flat.items():
        whole = torch.zeros(t.shape)
        for m in range(M):
            g = ps[m]
            for k in p_:
                g = g[k]
            if g.grad is not None:
                whole[t.sharding.block(t.shape, (0, m))] += g.grad
        rel_close(whole, want[p_].numpy(), 1e-5, "/".join(p_))



# ---------------------------------------------------------- serving ----
SERVE_S, SERVE_DECODE = 12, 4


def serve(prefill, decode, params, batch, cache):
    logits, cache = prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = [tok]
    for i in range(SERVE_DECODE):
        tok, cache = decode(params, tok, cache, SERVE_S + i)
        toks.append(tok)
    return logits, torch.cat(toks, 1)


@functools.lru_cache(maxsize=None)
def serve_inputs(name, scale=()):
    """The reference's parameters (scales and biases perturbed) and a
    prompt of SERVE_S tokens (whisper's with its frames)."""
    cfg, rcfg = cfgs(name, scale)
    np_params = perturb(np.random.default_rng(5),
                        np_tree(ref_build(rcfg).init(jax.random.key(2))))
    batch = {k: v[:, :SERVE_S] if k == "tokens" else v
             for k, v in make_batch(cfg, 11, labels=False).items()}
    return np_params, batch


@functools.lru_cache(maxsize=None)
def reference_serve(name, scale, ctx):
    """The reference's single-device serve of ``serve_inputs`` with a
    ``ctx``-slot cache: its prefill's logits and SERVE_DECODE + 1 greedy
    tokens. The tokens come from its ``decode_step`` where the prompt
    fills the cache's ring (or there is no ring), else from its full
    forward over the prompt and the tokens before each: below its ring's
    length the reference's prefill returns a ring of S slots, whose first
    decode step overwrites token 0's K/V (ROADMAP queue C), and the full
    forward is what the port's prefill and decode steps compute there,
    except where an MoE's capacity drops tokens by the batch it routes."""
    _, rcfg = cfgs(name, scale)
    ref = ref_build(rcfg)
    np_params, batch = serve_inputs(name, scale)
    rp = jax.tree.map(jnp.asarray, np_params)
    extra = {k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"}
    cache = ref.make_cache(B, ctx)
    ring = cache.get("k", cache.get("ak"))
    logits, cache = jax.jit(ref.prefill)(
        rp, {"tokens": jnp.asarray(batch["tokens"]), **extra}, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    if ring is None or ring.shape[2] <= SERVE_S:
        decode = jax.jit(ref.decode_step)
        for i in range(SERVE_DECODE):
            step, cache = decode(rp, tok, cache, SERVE_S + i)
            tok = jnp.argmax(step[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
        return np.asarray(logits), np.concatenate(toks, 1)
    assert not rcfg.n_experts, "an MoE's decode is not its full forward"

    @jax.jit
    def last(tokens):
        x, pos, enc_out, _ = ref._embed_inputs(rp, {"tokens": tokens,
                                                    **extra})
        h, _, _ = ref._trunk(rp, x, pos, enc_out=enc_out)
        return jnp.argmax(RL.unembed(rp["embed"], rcfg, h[:, -1]), -1)

    seq = np.concatenate([batch["tokens"], toks[0]], 1)
    for _ in range(SERVE_DECODE):
        nxt = np.asarray(last(jnp.asarray(seq)), np.int32)[:, None]
        seq = np.concatenate([seq, nxt], 1)
    return np.asarray(logits), seq[:, SERVE_S:]


def serve_case(name, D, M, scale=(), ctx=None):
    """The prefill logits, greedy tokens and cache on a (D, M) mesh, held
    to the reference's (``reference_serve``: the logits within 1e-4 of
    their max, the port's one-device tolerance against it in
    ``tests/test_torch_ssm.py``; the tokens equal) and to the same rows
    served on D data shards of one device each (the logits within 1e-5
    of their max, the tokens equal). Returns both caches."""
    cfg, _ = cfgs(name, scale)
    np_params, np_batch = serve_inputs(name, scale)
    params = params_from_jax(np_params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    ctx = ctx or SERVE_S + SERVE_DECODE + 4
    rlogits, rtoks = reference_serve(name, scale, ctx)
    dp = mesh_of(D, 1)
    m1, p1, d1 = steps.make_serve_steps(cfg, dp)
    one = steps.shard_cache(cfg, dp, m1.make_cache(B, ctx))
    want, wtoks = serve(p1, d1, SH.replicate(params, dp), batch, one)
    mesh = mesh_of(D, M)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    P = SH.shard_tree(params, SH.to_named(
        mesh, SH.param_specs(cfg, mesh, params)))
    cache = steps.shard_cache(cfg, mesh, model.make_cache(B, ctx))
    logits, toks = serve(prefill, decode, P, batch, cache)
    assert logits.shape == want.shape == rlogits.shape == (B, 1, cfg.vocab)
    rel_close(logits, rlogits, 1e-4, "vs the reference")
    np.testing.assert_array_equal(toks.numpy(), rtoks)
    rel_close(logits, want.numpy(), 1e-5, "vs one device")
    assert torch.equal(toks, wtoks)
    return cfg, cache, one


def check_blocks(cache, one, want_spec):
    """Each block of each cache leaf is its spec's slice of the one-device
    cache (within 1e-4 of the leaf's max), and lies where ``want_spec``
    says."""
    for k, leaf in cache.items():
        assert tuple(leaf.sharding.spec) == want_spec[k], k
        whole = one[k].gather()
        scale = float(whole.abs().max())
        assert scale > 0, k
        for pos in np.ndindex(leaf.blocks.shape):
            blk = leaf.blocks[pos]
            sl = leaf.sharding.block(leaf.shape, pos)
            assert tuple(blk.shape) == tuple(whole[sl].shape), k
            err = float((blk - whole[sl]).abs().max())
            assert err <= 1e-4 * scale, (k, pos, err, scale)


SSM_SERVE = {
    "zamba2-7b": {"ssm": (None, None, "data", "model", None, None),
                  "tail_ssm": (None, "data", "model", None, None),
                  "ak": (None, "data", None, "model", None),
                  "av": (None, "data", None, "model", None)},
    "xlstm-125m": {"mC": (None, None, "data", "model", None, None),
                   "mn": (None, None, "data", "model", None),
                   "sc": (None, "data", "model"),
                   "sn": (None, "data", "model")},
    "whisper-medium": {"k": (None, "data", None, "model", None),
                       "v": (None, "data", None, "model", None),
                       "enc_out": ("data", None, "model")}}


@pytest.mark.parametrize("name,D,M", [
    ("zamba2-7b", 1, 2), ("zamba2-7b", 1, 4), ("zamba2-7b", 2, 2),
    ("xlstm-125m", 1, 2), ("xlstm-125m", 1, 4),
    ("whisper-medium", 1, 2), ("whisper-medium", 1, 4)])
def test_tp_serve_steps_match_one_device(name, D, M, monkeypatch):
    """``make_serve_steps(cfg, mesh)`` for the recurrent stacks and
    whisper: logits and tokens against the reference's and the one-device
    serve (``serve_case``), every cache block (states split on heads or
    channels, K/V on KV heads, ``enc_out`` on ``d``) against the
    one-device cache."""
    monkeypatch.delenv("REPRO_KV_SHARD", raising=False)
    _, cache, one = serve_case(name, D, M)
    check_blocks(cache, one, SSM_SERVE[name])


SEQ_CASES = [("qwen3-0.6b", 1, 4, (), None), ("qwen3-0.6b", 2, 2, (), None),
             ("mixtral-8x7b", 1, 2, (), SERVE_S),
             ("mixtral-8x7b", 1, 2, (("swa_window", 8),), None),
             ("whisper-medium", 1, 2, (), None),
             ("qwen3-0.6b", 1, 4, (), 32)]


@pytest.mark.parametrize("name,D,M,scale,ctx", SEQ_CASES)
def test_seq_sharded_cache_serves_as_one_device(name, D, M, scale, ctx,
                                                monkeypatch):
    """``REPRO_KV_SHARD=seq``: each model shard holds every KV head of
    ``T / M`` slots; the prefill writes each shard's slot range of the
    ring, a decode step the token's K/V on the shard of its slot, and the
    shards' partial softmaxes join on shard 0. Against the one-device
    serve (whose cache splits by KV heads or not at all) and the
    reference's (``serve_case``): logits, tokens, and each block equal to
    its slot range of the one-device cache. mixtral at ctx 12 wraps its
    ring from the first decode step, and at window 8 its ring of 8 slots
    (the prompt alone is 12); qwen3 at ctx 32 over 4 shards leaves the
    last shard with no valid slot for every decode step."""
    monkeypatch.setenv("REPRO_KV_SHARD", "seq")
    cfg, cache, one = serve_case(name, D, M, scale, ctx)
    spec = {"k": (None, "data", "model", None, None),
            "v": (None, "data", "model", None, None)}
    if cfg.enc_dec:
        spec["enc_out"] = ("data", None, "model")
    T_ = cache["k"].shape[2]
    assert cache["k"].blocks[0, 0].shape[2] == T_ // M
    assert cache["k"].blocks[0, 0].shape[3] == cfg.n_kv_heads
    check_blocks(cache, one, spec)


def test_seq_join_of_a_shard_with_no_valid_slot():
    """``seq_partial`` and ``Group.join`` over 3 shards of a 12-slot
    cache at position 4: shard 0 holds slots 0-3 (all valid), shard 1
    slots 4-7 (slot 4, written now), shard 2 slots 8-11 (none valid yet:
    max -inf). The join equals ``_sdpa`` over the valid slots, finite,
    and shard 2's block is left as it was."""
    cfg = SMOKE["qwen3-0.6b"].scaled(dtype="float32")
    rng = np.random.default_rng(8)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    Bq, H, Hkv, dh, Tw, M_ = 2, 4, 2, 16, 12, 3
    q, k, v = rand(Bq, 1, H, dh), rand(Bq, 1, Hkv, dh), rand(Bq, 1, Hkv, dh)
    ck, cv = rand(Bq, Tw, Hkv, dh), rand(Bq, Tw, Hkv, dh)
    pos = torch.full((Bq, 1), 4)
    blocks = [(ck[:, 4 * m:4 * m + 4].clone(), cv[:, 4 * m:4 * m + 4].clone())
              for m in range(M_)]
    before = [b[0].clone() for b in blocks]
    parts = [L.seq_partial(cfg, q, k, v, bk, bv, pos, m, Tw)
             for m, (bk, bv) in enumerate(blocks)]
    assert bool(torch.isneginf(parts[2][0]).all())
    assert float(parts[2][1].abs().max()) == 0.0
    assert float(parts[2][2].abs().max()) == 0.0
    got = L.seq_attend(TP.Group(["cpu"] * M_), parts, torch.float32)
    ck[:, 4:5], cv[:, 4:5] = k, v
    mask = (torch.arange(Tw) <= 4)[None, None, None, None, :]
    want = L._sdpa(q, ck, cv, mask, cfg)
    for g in got:
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)
    assert torch.equal(blocks[2][0], before[2])
    assert torch.equal(blocks[1][0][:, 0], k[:, 0])
    assert torch.equal(blocks[0][0], before[0])


# -------------------------------------------- MoE routes across shards ----
def route_flips(name, M, dtype):
    """deepseek's prefill on one device and over M model shards on the
    same params and prompts in ``dtype``: each layer's (token, k) routes
    that the tensor-parallel run picks and the one-device run does not
    (``moe.route_flips``), and the logits of each, and of the
    tensor-parallel run with each layer's route forced to the one-device
    run's."""
    cfg = SMOKE[name].scaled(dtype=dtype)
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(4))
    tokens = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab, (B, S)))
    routes = {"one": [], "tp": []}
    real = MOE.route

    def spy(kind):
        def fn(*a, **kw):
            r = real(*a, **kw)
            routes[kind].append(r)
            return r
        return mock.patch.object(MOE, "route", fn)

    _, pre1, _ = steps.make_serve_steps(cfg, "cpu")
    with spy("one"):
        one, _ = pre1(params, {"tokens": tokens},
                      model.make_cache(B, S, "cpu"))
    mesh = mesh_of(1, M)
    _, pre, _ = steps.make_serve_steps(cfg, mesh)
    P = SH.shard_tree(params, SH.to_named(mesh, SH.param_specs(
        cfg, mesh, params)))

    def run():
        return pre(P, {"tokens": tokens}, steps.shard_cache(
            cfg, mesh, model.make_cache(B, S, "cpu")))[0]

    with spy("tp"):
        tp = run()
    forced = iter(routes["one"])
    with mock.patch.object(MOE, "route", lambda *a, **kw: next(forced)):
        tp_forced = run()
    flips = [MOE.route_flips(a, b) for a, b in zip(routes["tp"],
                                                 routes["one"])]
    return cfg, flips, one, tp, tp_forced


def test_moe_route_flips_counted_in_bf16():
    """The count ``chip_smoke.py``'s ``lm_serve_tp`` makes at full size,
    at SMOKE in bf16 over 4 expert-parallel shards: per layer the (token,
    k) routes that differ from the one-device run's, none in layer 0 (the
    same embedding, the same router input). SMOKE's two layers flip none,
    so the logits differ by bf16's rounding alone, within 2e-2 of their
    max, with every layer's route forced to the one-device run's or
    not."""
    cfg, flips, one, tp, tp_forced = route_flips("deepseek-moe-16b", 4,
                                                 "bfloat16")
    assert len(flips) == cfg.n_layers and flips[0] == 0
    assert all(0 <= f <= B * S * cfg.moe_top_k for f in flips)
    scale = float(one.abs().max())
    for got in (tp, tp_forced):
        assert float((got - one).abs().max()) <= 2e-2 * scale


def test_route_flips_counts_experts_not_order():
    """``moe.route_flips``: per token, the experts of the first route not
    among the second's; their order within the top k does not count."""
    def r(idx):
        idx = torch.tensor(idx)
        z = torch.zeros(idx.shape)
        return MOE.Route(z, idx, idx, idx >= 0, z.sum(), 8)

    assert MOE.route_flips(r([[0, 1], [2, 3]]), r([[1, 0], [2, 3]])) == 0
    assert MOE.route_flips(r([[0, 1], [2, 3]]), r([[0, 5], [4, 6]])) == 3


def test_train_cli_model_parallel_zamba2_resumes_onto_another_mesh(
        tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch zamba2-7b --smoke
    --model-parallel 2 --devices cpu,cpu,cpu,cpu`` takes two steps on (2,
    2); restarted with ``--model-parallel 4`` it resumes that checkpoint
    onto (1, 4), saves it again bit for bit, and takes a third step."""
    from repro_torch.launch import train
    from repro_torch.runtime.checkpoint import CheckpointManager
    d = str(tmp_path)
    cli = ["--arch", "zamba2-7b", "--smoke", "--seq", "16", "--batch", "4",
           "--log-every", "1", "--devices", "cpu,cpu,cpu,cpu",
           "--ckpt-dir", d]
    train.main([*cli, "--model-parallel", "2", "--steps", "2"])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "step     2 loss" in out
    _, saved = CheckpointManager(d).restore(2)
    train.main([*cli, "--model-parallel", "4", "--steps", "2"])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 4}" in out
    assert "resumed from step 2" in out
    _, again = CheckpointManager(d).restore(2)
    assert saved.keys() == again.keys()
    assert any(k.startswith("params/super/mamba/") for k in saved)
    for k in saved:
        assert torch.equal(saved[k], again[k]), k
    train.main([*cli, "--model-parallel", "4", "--steps", "3"])
    assert "step     3 loss" in capsys.readouterr().out
    step, last = CheckpointManager(d).restore()
    assert step == 3 and int(last["opt/.step"]) == 3
