"""Tensor parallelism over the ``model`` axis (``distributed/
tensor_parallel.py``, the ``tp_*`` model functions, the mesh paths of
``launch/steps.py`` with a model axis > 1, the train CLI's
``--model-parallel``) against the reference package, on the CPU in
float32 at SMOKE size.

A mesh takes a list of devices that may repeat: ``["cpu"] * 4`` is the
port's counterpart of ``--xla_force_host_platform_device_count=4``. The
reference's GSPMD mesh steps raise on this JAX (ROADMAP queue C), so, as
``tests/test_torch_distributed.py`` does, the steps are held against the
math that sharding must keep: the reference's single-device
``value_and_grad`` and ``adamw.apply`` on the full batch (MoE with its
grouped dispatch at G = the data-shard count, ``repro.models.moe.
_n_groups`` patched). Meshes: (1, 2), (2, 2), (1, 4) (SMOKE's 2 KV heads
cut in half a head a shard) and (1, 3) (the guard keeps the attention,
MLP and vocab whole; deepseek's experts go ffn-parallel).

Tolerances (``tests/test_torch_distributed.py``'s, for the same reasons):
loss within rtol 1e-5, gnorm 1e-4 (fp32 sums in another order); every
gradient leaf, gathered from the blocks AdamW was handed, within 1e-4 of
its max; params within 1e-6 after a step; the data replicas and the
model replicas of each leaf kept whole bit for bit (one sum, copied).
Served logits within 1e-5 of their max, greedy tokens equal.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as RM
from repro.configs import SMOKE as REF_SMOKE
from repro.models.model import build as ref_build
from repro.optim import adamw as ref_adamw
from repro_torch.configs import SMOKE
from repro_torch.convert import params_from_jax
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps, train
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.runtime.checkpoint import CheckpointManager, _flatten

B, S, PATCHES = 4, 16, 8


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def at(tree, path):
    for k in path:
        tree = getattr(tree, k.name) if hasattr(k, "name") else tree[k.key]
    return tree


def each_leaf(fn, port_tree, ref_tree):
    flat = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert len(SH.tree_leaves(port_tree)) == len(flat)
    for path, ref in flat:
        fn(at(port_tree, path), ref, jax.tree_util.keystr(path))


def rel_close(out, ref, rel, path=""):
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape, path
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, (path, err, scale)


def perturb(rng, tree, key=None):
    """Norm scales and biases get noise, so that their initial ones and
    zeros do not hide a missing term."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in ("scale", "bq", "bk", "bv"):
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


def blocks_differ(tree) -> int:
    """Blocks of a tree of ``ShardedTensor`` not bit-equal to the first
    block of the same slice of their leaf (data replicas, and the model
    replicas of a leaf kept whole)."""
    n = 0
    for t in SH.tree_leaves(tree):
        first = {}
        for pos in np.ndindex(t.blocks.shape):
            key = tuple((s.start, s.stop)
                        for s in t.sharding.block(t.shape, pos))
            if key in first:
                n += not torch.equal(first[key], t.blocks[pos])
            else:
                first[key] = t.blocks[pos]
    return n


def grouped(D):
    return mock.patch.object(RM, "_n_groups", lambda B: D)


def cfgs(name):
    return (SMOKE[name].scaled(dtype="float32"),
            REF_SMOKE[name].scaled(dtype="float32"))


def train_batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = (0.02 * rng.standard_normal(
            (B, PATCHES, cfg.d_model))).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference_step(name, D):
    """The reference's loss, gradients, and params, moments and gnorm
    after ``adamw.apply``, on the full batch (MoE grouped at G = D)."""
    cfg, rcfg = cfgs(name)
    ref = ref_build(rcfg)
    np_params = perturb(np.random.default_rng(3),
                        np_tree(ref.init(jax.random.key(0))))
    rp = jax.tree.map(jnp.asarray, np_params)
    batch = train_batch(cfg)
    with grouped(D if cfg.is_moe else 1):
        (rl, _), rg = jax.value_and_grad(ref.loss, has_aux=True)(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
        rp2, ro2, rn = ref_adamw.apply(rp, rg, ref_adamw.init(rp))
    return (np_params, batch, float(rl), np_tree(rg), np_tree(rp2),
            np_tree(ro2.m), float(rn))


def mesh_of(D, M):
    return MESH.make_host_mesh(M, ["cpu"] * (D * M))


def placed(cfg, mesh, params, p_shapes):
    p_specs, o_specs = steps.train_specs(cfg, mesh, p_shapes)
    return (SH.shard_tree(params, SH.to_named(mesh, p_specs)),
            SH.shard_tree(adamw.init(params), SH.to_named(mesh, o_specs)))


TRAIN_CASES = [("qwen3-0.6b", 1, 2), ("qwen3-0.6b", 2, 2),
               ("qwen3-0.6b", 1, 4), ("qwen3-0.6b", 1, 3),
               ("starcoder2-3b", 1, 4), ("starcoder2-3b", 2, 2),
               ("qwen2-vl-72b", 1, 2), ("qwen2-vl-72b", 1, 4),
               ("mixtral-8x7b", 1, 2), ("mixtral-8x7b", 2, 2),
               ("mixtral-8x7b", 1, 4), ("deepseek-moe-16b", 1, 3),
               ("deepseek-moe-16b", 1, 4), ("deepseek-moe-16b", 2, 2)]


@pytest.mark.parametrize("name,D,M", TRAIN_CASES)
def test_tp_train_step_matches_full_batch_reference(name, D, M):
    """``make_train_step(cfg, mesh)`` on a (D, M) mesh of CPU shards:
    loss, gnorm, every gradient leaf joined from the blocks AdamW was
    handed, the params and moments after the step, against the
    reference's full-batch step; the step returns ``ShardedTensor`` trees
    placed as it was given them, whose data replicas and model replicas
    are bit-equal."""
    cfg, _ = cfgs(name)
    np_params, batch, rl, rg, rp2, rm2, rn = reference_step(name, D)
    mesh = mesh_of(D, M)
    _, step, p_shapes, _ = steps.make_train_step(cfg, mesh)
    params = params_from_jax(np_params, device="cpu")
    P, O = placed(cfg, mesh, params, p_shapes)
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
    each_leaf(lambda o, r, p: np.testing.assert_allclose(
        o.numpy(), r, rtol=0, atol=1e-6, err_msg=p), SH.gather_tree(pr),
        rp2)
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p),
              SH.gather_tree(orr.m), rm2)
    for new, old in zip(SH.tree_leaves(pr), SH.tree_leaves(P)):
        assert new.sharding is old.sharding
        assert new.blocks.shape == (D, M)
    assert blocks_differ(grads) == blocks_differ(pr) == 0
    assert blocks_differ(orr) == 0 and int(orr.step.gather()) == 1


def test_tp_loss_splits_what_the_specs_split():
    """On (1, 4), qwen3's attention and MLP products are split (their
    row-parallel outputs summed across the shards, as the embedding's
    rows are), its K/V columns cut half a head a shard (gathered) and the
    vocab split; on (1, 3) the guard keeps them all whole, and no shard
    sums or gathers a thing. Counted over one forward of the loss."""
    cfg, _ = cfgs("qwen3-0.6b")
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    counts = {}
    for M in (4, 3):
        mesh = mesh_of(1, M)
        P = SH.shard_tree(params, SH.to_named(
            mesh, SH.param_specs(cfg, mesh, params)))
        calls = {"sum": 0, "gather": 0, "total": 0}

        def count(kind):
            fn = getattr(TP.Group, kind)

            def inner(self, *a, **kw):
                calls[kind] += 1
                return fn(self, *a, **kw)
            return mock.patch.object(TP.Group, kind, inner)

        with count("sum"), count("gather"), count("total"), \
                torch.no_grad():
            model.loss_tp(TP.Group(["cpu"] * M),
                          [SH.blocks_at(P, (0, m)) for m in range(M)],
                          batch)
        counts[M] = calls
        kv_cols = P["layers"]["attn"]["wk"].blocks[0, 0].shape[-1]
        assert kv_cols * (M if M == 4 else 1) == cfg.n_kv_heads * cfg.d_head
    # the embedding and 2 a layer; K and V a layer; the logsumexp's sum
    # of exponentials and the gold logit on shard 0, each a total
    n = cfg.n_layers
    assert counts[4] == {"sum": 1 + 2 * n, "gather": 2 * n,
                         "total": 1 + 2 * n + 2}
    assert counts[3] == {"sum": 0, "gather": 0, "total": 0}


def test_vocab_sharded_loss_equals_whole_logit_loss():
    """``Model.loss_tp`` over 4 model shards of a split vocab (each shard
    unembeds only its quarter of the columns) against ``Model.loss`` on
    one device: the total and every part, and the gradient of the
    unembedding, joined."""
    cfg, _ = cfgs("qwen3-0.6b")
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(2))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    mesh = mesh_of(1, 4)
    P = SH.shard_tree(params, SH.to_named(
        mesh, SH.param_specs(cfg, mesh, params)))
    ps = [SH.tree_map(lambda t, _, m=m: t.blocks[0, m].detach()
                      .requires_grad_(), P) for m in range(4)]
    widths, unembed = [], L.unembed

    def spy(p, c, h):
        out = unembed(p, c, h)
        widths.append(out.shape[-1])
        return out

    with mock.patch.object(L, "unembed", spy):
        got, parts = model.loss_tp(TP.Group(["cpu"] * 4), ps, batch)
    assert widths == [cfg.vocab // 4] * 4
    leaves = adamw.tree_map(lambda t: t.detach().requires_grad_(), params)
    want, wparts = model.loss(leaves, batch)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    for k in wparts:
        np.testing.assert_allclose(float(parts[k].detach()),
                                   float(wparts[k].detach()),
                                   rtol=1e-6, atol=1e-9)
    got.backward()
    want.backward()
    out = torch.cat([p["embed"]["out"].grad for p in ps], -1)
    rel_close(out, leaves["embed"]["out"].grad.numpy(), 1e-5)


@pytest.mark.parametrize("name,shards", [("mixtral-8x7b", 4),
                                    ("deepseek-moe-16b", 4),
                                    ("deepseek-moe-16b", 3)])
def test_tp_moe_fwd_matches_one_device_under_drops(name, shards):
    """``moe.tp_moe_fwd`` over ``shards`` model shards (expert-parallel at 4,
    E / 4 experts a shard; deepseek ffn-parallel at 3, its shared
    experts split either way) against ``moe_fwd`` on one device, on
    64 tokens that overflow the capacity: y within 1e-5 of its max, the
    same aux, and pairs dropped."""
    cfg, _ = cfgs(name)
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(4))
    mesh = mesh_of(1, shards)
    P = SH.shard_tree(params, SH.to_named(
        mesh, SH.param_specs(cfg, mesh, params)))
    ps = [{k: v[0] for k, v in SH.blocks_at(P, (0, m))["layers"]["moe"]
           .items() if k != "shared"} for m in range(shards)]
    if cfg.n_shared_experts:
        for m, p in enumerate(ps):
            p["shared"] = {k: v[0] for k, v in SH.blocks_at(
                P, (0, m))["layers"]["moe"]["shared"].items()}
    ep = cfg.n_experts % shards == 0
    assert ps[0]["wi"].shape[0] == (cfg.n_experts // shards if ep
                                    else cfg.n_experts)
    one = {k: v[0] for k, v in params["layers"]["moe"].items()
           if k != "shared"}
    if cfg.n_shared_experts:
        one["shared"] = {k: v[0] for k, v in
                         params["layers"]["moe"]["shared"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    # the router favours expert 0, so its rows overflow
    one["router"] = one["router"].clone()
    one["router"][:, 0] += 2.0
    for p in ps:
        p["router"] = one["router"]
    r = M.route(one, cfg, x.reshape(-1, cfg.d_model))
    assert int((~r.keep).sum()) > 0
    ys, aux = M.tp_moe_fwd(TP.Group(["cpu"] * shards), ps, cfg,
                             [x] * shards)
    y1, aux1 = M.moe_fwd(one, cfg, x)
    for y in ys:
        rel_close(y, y1.numpy(), 1e-5)
    assert torch.equal(ys[0], ys[-1])
    assert float(aux) == float(aux1) and r.capacity < 64


def test_tp_compress_quantizes_each_leaf_by_its_whole_scale():
    """The TP step's int8 round trip (``tensor_parallel._compress``): a
    leaf split over the model shards is quantized with the scale of the
    whole leaf, so its dequantized blocks and residuals join to exactly
    what ``adamw.compress_grads`` gives the whole gradient; a whole leaf
    is each shard's own round trip."""
    rng = np.random.default_rng(7)
    g = {"w": torch.from_numpy(rng.standard_normal((6, 8), np.float32)),
         "n": torch.from_numpy(rng.standard_normal(5).astype(np.float32))}
    ef = adamw.tree_map(lambda t: 0.01 * torch.ones_like(t), g)
    q, sc, want_ef = adamw.compress_grads(g, ef)
    want = adamw.tree_map(adamw.dequantize_int8, q, sc)
    split = {"w": True, "n": False}
    blocks = [{"w": g["w"][:, 4 * m:4 * m + 4], "n": g["n"]}
              for m in range(2)]
    efs = [{"w": ef["w"][:, 4 * m:4 * m + 4], "n": ef["n"]}
           for m in range(2)]
    deq, res = TP._compress(TP.Group(["cpu"] * 2), blocks, efs, split)
    for got, wanted in ((deq, want), (res, want_ef)):
        assert torch.equal(torch.cat([d["w"] for d in got], -1),
                           wanted["w"])
        assert all(torch.equal(d["n"], wanted["n"]) for d in got)


def test_tp_step_with_compressed_grads_follows_one_device():
    """``make_train_step(cfg, mesh, compress_grads=True)`` on (1, 2)
    against the one-device compressed step on the same params and batch:
    the loss within 1e-5, the params within 1e-5 (an element whose int8
    level rounds the other way moves by AdamW's first-step lr, 3e-6),
    the residuals placed like the params."""
    cfg, _ = cfgs("qwen3-0.6b")
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(6))
    opt = adamw.init(params, compress=True)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    _, one, _, _ = steps.make_train_step(cfg, "cpu", compress_grads=True)
    p1, o1, m1 = one(params, opt, batch)
    mesh = mesh_of(1, 2)
    _, step, p_shapes, _ = steps.make_train_step(cfg, mesh,
                                                 compress_grads=True)
    p_specs, o_specs = steps.train_specs(cfg, mesh, p_shapes, True)
    pr, orr, m = step(SH.shard_tree(params, SH.to_named(mesh, p_specs)),
                      SH.shard_tree(opt, SH.to_named(mesh, o_specs)), batch)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for a, b in zip(SH.tree_leaves(SH.gather_tree(pr)),
                    SH.tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    for e, p in zip(SH.tree_leaves(orr.ef), SH.tree_leaves(pr)):
        assert e.sharding.spec == p.sharding.spec


SERVE_CASES = [("qwen3-0.6b", 1, 4), ("qwen3-0.6b", 2, 2),
               ("starcoder2-3b", 1, 4), ("qwen2-vl-72b", 1, 2),
               ("mixtral-8x7b", 1, 2), ("mixtral-8x7b", 2, 2),
               ("deepseek-moe-16b", 1, 3), ("deepseek-moe-16b", 1, 4)]
SERVE_S, SERVE_DECODE = 12, 4


@pytest.mark.parametrize("name,D,M", SERVE_CASES)
def test_tp_serve_steps_match_one_device(name, D, M):
    """``make_serve_steps(cfg, mesh)`` on a (D, M) mesh against the same
    rows on D data shards of one device each (one device at D = 1; the
    MoE routed per data shard either way, as ``test_torch_distributed``
    holds the reference's grouped dispatch to): the prefill's logits
    within 1e-5, the greedy tokens equal, and each cache block where
    ``cache_specs`` puts it (its rows, and its KV heads where they split
    on ``model``)."""
    cfg, rcfg = cfgs(name)
    np_params = np_tree(ref_build(rcfg).init(jax.random.key(2)))
    params = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, SERVE_S)).astype(np.int32))}
    start = SERVE_S
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy((0.02 * rng.standard_normal(
            (B, PATCHES, cfg.d_model))).astype(np.float32))
        start += PATCHES
    ctx = start + SERVE_DECODE + 4

    def serve(prefill, decode, p, cache):
        logits, cache = prefill(p, batch, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(SERVE_DECODE):
            tok, cache = decode(p, tok, cache, start + i)
            toks.append(tok)
        return logits, torch.cat(toks, 1)

    dp = mesh_of(D, 1)
    m1, p1, d1 = steps.make_serve_steps(cfg, dp)
    want, wtoks = serve(p1, d1, SH.replicate(params, dp),
                        steps.shard_cache(cfg, dp, m1.make_cache(B, ctx)))
    mesh = mesh_of(D, M)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    P = SH.shard_tree(params, SH.to_named(
        mesh, SH.param_specs(cfg, mesh, params)))
    cache = steps.shard_cache(cfg, mesh, model.make_cache(B, ctx))
    logits, toks = serve(prefill, decode, P, cache)
    assert logits.shape == want.shape == (B, 1, cfg.vocab)
    rel_close(logits, want.numpy(), 1e-5)
    assert torch.equal(toks, wtoks)
    split = cfg.n_kv_heads % M == 0
    for leaf in (cache["k"], cache["v"]):
        assert tuple(leaf.sharding.spec) == (
            None, "data", None, "model" if split else None, None)
        blk = leaf.blocks[0, M - 1]
        assert blk.shape[1] == B // D
        assert blk.shape[3] == cfg.n_kv_heads // (M if split else 1)
        assert torch.count_nonzero(blk) > 0


def test_tp_serve_steps_replicate_a_batch_of_one():
    """One prompt on a (2, 2) mesh: the two data shards do not split it,
    so each serves it whole, tensor-parallel over its model shards, on its
    copy of the cache; the prefill's logits within 1e-5 of the one-device
    serve's, the greedy tokens equal."""
    cfg, rcfg = cfgs("qwen3-0.6b")
    params = params_from_jax(np_tree(ref_build(rcfg).init(
        jax.random.key(2))), device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (1, SERVE_S)).astype(np.int32))}
    ctx = SERVE_S + SERVE_DECODE + 4

    def serve(prefill, decode, p, cache):
        logits, cache = prefill(p, batch, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        toks = [tok]
        for i in range(SERVE_DECODE):
            tok, cache = decode(p, tok, cache, SERVE_S + i)
            toks.append(tok)
        return logits, torch.cat(toks, 1)

    m1, p1, d1 = steps.make_serve_steps(cfg, device="cpu")
    want, wtoks = serve(p1, d1, params, m1.make_cache(1, ctx))
    mesh = mesh_of(2, 2)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    P = SH.shard_tree(params, SH.to_named(
        mesh, SH.param_specs(cfg, mesh, params)))
    cache = steps.shard_cache(cfg, mesh, model.make_cache(1, ctx))
    logits, toks = serve(prefill, decode, P, cache)
    assert logits.shape == want.shape == (1, 1, cfg.vocab)
    rel_close(logits, want.numpy(), 1e-5)
    assert torch.equal(toks, wtoks)
    for leaf in (cache["k"], cache["v"]):
        assert tuple(leaf.sharding.spec) == (None, None, None, "model", None)
        for m in range(2):
            assert torch.equal(leaf.blocks[0, m], leaf.blocks[1, m])


def test_train_cli_model_parallel_resumes_onto_another_mesh(tmp_path,
                                                            capsys):
    """``--model-parallel 2`` over 4 CPU devices takes two steps; the run
    restarted with ``--model-parallel 4`` resumes its checkpoint onto
    (1, 4) and saves it again bit for bit; the same state resharded by
    ``elastic.reshard`` onto (4, 1) and back gathers bit-equal; then two
    more steps on (1, 4) end with params within the bf16 criterion
    (``tests/test_torch_models.py``'s 2e-2 of a leaf's max) of four
    uninterrupted steps on (2, 2): the bf16 products are summed across 2
    model shards in one run and 4 in the other. (The second moments, the
    squares of those bf16 gradients, are not compared.)"""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    cli = ["--smoke", "--seq", "32", "--batch", "4", "--log-every", "1",
           "--devices", "cpu,cpu,cpu,cpu"]
    train.main([*cli, "--model-parallel", "2", "--steps", "2",
                "--ckpt-dir", b])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "step     2 loss" in out
    _, saved = CheckpointManager(b).restore(2)
    train.main([*cli, "--model-parallel", "4", "--steps", "2",
                "--ckpt-dir", b])
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 4}" in out
    assert "resumed from step 2" in out
    _, again = CheckpointManager(b).restore(2)
    assert saved.keys() == again.keys()
    for k in saved:
        assert torch.equal(saved[k], again[k]), k
    # the resumed tree onto (4, 1) and back to (1, 4), by reshard
    cfg = SMOKE["qwen3-0.6b"]
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    template = {"params": params, "opt": adamw.init(params)}
    p_shapes = model.abstract_params()

    def named(mesh):
        p, o = steps.train_specs(cfg, mesh, p_shapes)
        return SH.to_named(mesh, {"params": p, "opt": o})

    _, on14 = CheckpointManager(b).restore_tree(template,
                                                shardings=named(mesh_of(1, 4)))
    back = elastic.reshard(elastic.reshard(on14, named(mesh_of(4, 1))),
                           named(mesh_of(1, 4)))
    flat = dict(_flatten(SH.gather_tree(back)))
    assert flat.keys() == saved.keys()
    for k in saved:
        assert torch.equal(saved[k], flat[k]), k
    train.main([*cli, "--model-parallel", "4", "--steps", "4",
                "--ckpt-dir", b])
    train.main([*cli, "--model-parallel", "2", "--steps", "4",
                "--ckpt-dir", a])
    (sa, fa), (sb, fb) = (CheckpointManager(d).restore() for d in (a, b))
    assert sa == sb == 4 and fa.keys() == fb.keys()
    assert int(fa["opt/.step"]) == int(fb["opt/.step"]) == 4
    for k in fa:
        if k.startswith("params/"):
            rel_close(fb[k], fa[k].float().numpy(), 2e-2, k)
