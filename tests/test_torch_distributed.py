"""The port's LM scaffold across devices (``distributed/``,
``launch/mesh.py``, the mesh paths of ``launch/steps.py``, the train CLI's
``--devices``, ``restore_tree(shardings=)`` and ``elastic.reshard``)
against the reference package, on the CPU.

A mesh of the port takes a list of devices that may repeat: ``["cpu"] *
4`` is its counterpart of ``--xla_force_host_platform_device_count=4``.
The reference's spec rules run in-process on ``jax.sharding.AbstractMesh``
(no devices, no allocation); its ``make_manual_dp_step`` needs devices and
runs in a subprocess with 4 forced host devices, saving ``.npz``. Its
GSPMD mesh steps raise ``ShardingTypeError`` on this JAX (ROADMAP queue
C), so the mesh steps are held against the math that sharding must keep:
the reference's single-device ``value_and_grad`` and ``adamw.apply`` on
the full batch (for MoE, with its grouped dispatch at G = the shard
count, ``repro.models.moe._n_groups`` patched).

Tolerances, each for its reason (``tests/test_torch_train.py``'s for the
same comparisons, float32 throughout): the spec trees, the buckets and
every placement round trip exactly; the loss within rtol 1e-5 and
``gnorm`` within 1e-4 (fp32 sums in another order); gradients and AdamW's
moments within 1e-4 of each leaf's max; params within 1e-6 after a step;
the data-parallel replicas bit for bit (one reduction, copied); served
logits within 1e-5 of their max, greedy tokens equal. The cross-mesh
resume of the CLI (bf16 SMOKE) holds every leaf within the bf16
criterion of ``tests/test_torch_models.py``, 2e-2 of its max: the first
steps' gradients are summed over 2 shards in one run and over 1 in the
other.
"""
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.distributed.ctx as RCTX
import repro.distributed.overlap as ROV
import repro.distributed.sharding as RSH
import repro.models.moe as RM
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SMOKE as REF_SMOKE
from repro.models.model import build as ref_build
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS, SMOKE
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import overlap as OV
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch import steps, train
from repro_torch.models import moe as M
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.runtime import elastic
from repro_torch.runtime.checkpoint import CheckpointManager

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
# batch and context of the spec trees: 16 rows shard on (16, 16) and
# demote on (2, 16, 16), where the batch axes are 32 wide
SPEC_B, SPEC_CTX, SPEC_S = 16, 64, 128
CPU4 = ["cpu"] * 4
B, S = 4, 16


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def at(tree, path):
    """The leaf of a nested port tree at a reference key path."""
    for k in path:
        tree = getattr(tree, k.name) if hasattr(k, "name") else tree[k.key]
    return tree


def each_leaf(fn, port_tree, ref_tree):
    """``fn(port leaf, reference leaf, path)`` for every reference leaf,
    matched by name; both trees hold the same number of leaves."""
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


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def bit_equal(a, b) -> bool:
    la, lb = SH.tree_leaves(a), SH.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def perturb(rng, tree, key=None):
    """Norm scales and biases get noise, so that their initial ones and
    zeros do not hide a missing term."""
    if isinstance(tree, dict):
        return {k: perturb(rng, v, k) for k, v in tree.items()}
    if key not in ("scale", "bq", "bk", "bv"):
        return tree
    return (tree.astype(np.float32)
            + 0.1 * rng.standard_normal(tree.shape)).astype(tree.dtype)


# ------------------------------------------------------- mesh, context ----
def test_meshes():
    m = MESH.make_host_mesh(devices=CPU4)
    assert dict(m.shape) == {"data": 4, "model": 1}
    assert m.devices.shape == (4, 1) and m.size == 4
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    m = MESH.make_host_mesh(2, CPU4)
    assert dict(m.shape) == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        MESH.make_host_mesh(2, ["cpu"] * 3)
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        p = MESH.make_production_mesh(multi_pod=multi)
        assert tuple(p.shape.values()) == shape and p.devices is None
        assert p.axis_names == MESHES["x".join(map(str, shape))][1]


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
def test_mesh_context_and_batch_axes_match_reference(names):
    shape = (2,) * len(names)
    mine, ref = CTX.Mesh(shape, names), AbstractMesh(shape, names)
    spec = ("pod", "data", None, ("pod", "data"), "model")
    assert CTX.current_mesh() is None and RCTX.current_mesh() is None
    assert CTX.batch_axes() == RCTX.batch_axes() == "data"
    assert CTX._resolve(*spec) == RCTX._resolve(*spec)
    with CTX.mesh_context(mine), RCTX.mesh_context(ref):
        assert CTX.current_mesh() is mine
        assert CTX.batch_axes() == RCTX.batch_axes()
        assert CTX._resolve(*spec) == RCTX._resolve(*spec)
    assert CTX.current_mesh() is None


# ------------------------------------------------------------ spec rules --
@functools.lru_cache(maxsize=None)
def shapes(name: str):
    """Both packages' parameter and cache shapes at full size, with no
    storage: the reference's ``ShapeDtypeStruct``s, the port's meta
    tensors."""
    ref, mine = ref_build(REF_ARCHS[name]), build(ARCHS[name], "meta")
    return (ref, ref.abstract_params(),
            jax.eval_shape(functools.partial(ref.make_cache, SPEC_B,
                                             SPEC_CTX)),
            mine, mine.abstract_params(), mine.make_cache(SPEC_B, SPEC_CTX))


def same_specs(port_tree, ref_tree):
    flat = jax.tree_util.tree_leaves_with_path(
        ref_tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(SH.tree_leaves(port_tree)) == len(flat)
    for path, ref in flat:
        got = at(port_tree, path)
        assert isinstance(got, SH.P)
        assert tuple(got) == tuple(ref), (jax.tree_util.keystr(path), got,
                                          ref)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_spec_trees_equal_reference(name, mesh_name, monkeypatch):
    """``param_specs``, ``cache_specs`` (with and without
    ``REPRO_KV_SHARD=seq``) and the ``input_specs_sharding`` specs of
    every mode, at full size, exactly the reference's."""
    shape, names = MESHES[mesh_name]
    ref_mesh, mesh = AbstractMesh(shape, names), CTX.Mesh(shape, names)
    ref, r_params, r_cache, mine, params, cache = shapes(name)
    cfg, rcfg = ARCHS[name], REF_ARCHS[name]
    same_specs(SH.param_specs(cfg, mesh, params),
               RSH.param_specs(rcfg, ref_mesh, r_params))
    monkeypatch.delenv("REPRO_KV_SHARD", raising=False)
    same_specs(SH.cache_specs(cfg, mesh, cache),
               RSH.cache_specs(rcfg, ref_mesh, r_cache))
    monkeypatch.setenv("REPRO_KV_SHARD", "seq")
    same_specs(SH.cache_specs(cfg, mesh, cache),
               RSH.cache_specs(rcfg, ref_mesh, r_cache))
    for mode in ("train", "prefill", "decode"):
        got = SH.input_specs_sharding(cfg, mesh, mine.input_specs(
            SPEC_S, SPEC_B, mode))
        want = RSH.input_specs_sharding(rcfg, ref_mesh, ref.input_specs(
            SPEC_S, SPEC_B, mode))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].mesh is mesh
            assert tuple(got[k].spec) == tuple(want[k].spec), (mode, k)
    assert SH.batch_spec(mesh) == RSH.batch_spec(ref_mesh)


# --------------------------------------------------------------- buckets --
def ref_bucket_paths(tree, buckets):
    keys = ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    return [[keys[i] for i in b] for b in buckets]


def check_buckets(mine, want, sizes):
    assert mine == want
    order = [p for b in mine for p in b]
    assert sorted(order) == sorted(sizes)          # every leaf exactly once
    nbytes = [sizes[p] for p in order]
    assert nbytes == sorted(nbytes, reverse=True)  # largest first


def test_buckets_equal_reference_by_path():
    """``tests/test_overlap.py``'s dict, on both packages."""
    ref = {"a": jnp.zeros((1024, 1024)), "b": jnp.zeros((16,)),
           "c": jnp.zeros((512, 512)), "d": jnp.zeros((8, 8))}
    mine = {k: torch.zeros(tuple(v.shape)) for k, v in ref.items()}
    want = ref_bucket_paths(ref, ROV.make_buckets(ref, bucket_bytes=1 << 20))
    check_buckets(OV.make_buckets(mine, bucket_bytes=1 << 20), want,
                  {k: v.numel() * 4 for k, v in mine.items()})


@pytest.mark.parametrize("bucket_bytes", [32 << 20, 1 << 14])
@pytest.mark.parametrize("name", list(SMOKE))
def test_buckets_of_smoke_params_equal_reference(name, bucket_bytes):
    ref = ref_build(REF_SMOKE[name]).abstract_params()
    mine = build(SMOKE[name], "meta").abstract_params()
    want = ref_bucket_paths(ref, ROV.make_buckets(ref, bucket_bytes))
    sizes = {"/".join(map(str, p)): t.numel() * t.element_size()
             for p, t in _paths(mine)}
    check_buckets(OV.make_buckets(mine, bucket_bytes), want, sizes)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


# -------------------------------------------------- the manual DP step ----
def run_4dev(body: str) -> None:
    """``body`` in a subprocess with 4 forced host devices (the pattern of
    ``tests/test_overlap.py``)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr


class DP:
    """SMOKE qwen3-0.6b in float32, the reference's init, the pipeline's
    batches of 8 x 32 tokens."""
    cfg = SMOKE["qwen3-0.6b"].scaled(dtype="float32")
    rcfg = REF_SMOKE["qwen3-0.6b"].scaled(dtype="float32")

    @classmethod
    def start(cls):
        rp = ref_build(cls.rcfg).init(jax.random.key(0))
        return (params_from_jax(np_tree(rp), device="cpu"),
                opt_state_from_jax(np_tree(ref_adamw.init(rp)), device="cpu"))

    @classmethod
    def batch(cls, i):
        pipe = TokenPipeline(PipelineConfig(cls.cfg.vocab, 32, 8))
        return {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}


@pytest.fixture(scope="module")
def ref_manual_dp(tmp_path_factory):
    """The reference's ``make_manual_dp_step`` on 4 devices, one step:
    loss, gnorm, params and moments, flat by key path."""
    out = tmp_path_factory.mktemp("dp") / "ref.npz"
    run_4dev(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.configs import SMOKE
        from repro.models.model import build
        from repro.optim import adamw
        from repro.distributed.overlap import make_manual_dp_step
        from repro.data.pipeline import PipelineConfig, TokenPipeline

        cfg = SMOKE["qwen3-0.6b"].scaled(dtype="float32")
        model = build(cfg)
        params = model.init(jax.random.key(0))
        opt = adamw.init(params)
        assert len(jax.devices()) == 4
        mesh = jax.make_mesh((4,), ("data",))
        step = make_manual_dp_step(model.loss, adamw.apply, mesh)
        pipe = TokenPipeline(PipelineConfig(cfg.vocab, 32, 8))
        batch = {{k: jnp.asarray(v) for k, v in pipe.batch_at(0).items()}}
        p, o, m = jax.jit(step)(params, opt, batch)
        flat = {{"loss": m["loss"], "gnorm": m["gnorm"]}}
        for name, tree in (("p", p), ("m", o.m), ("v", o.v)):
            for path, x in jax.tree_util.tree_leaves_with_path(tree):
                key = "/".join(str(k.key) for k in path)
                flat[name + "/" + key] = np.asarray(x)
        np.savez({str(out)!r}, **flat)
    """)
    with np.load(out) as z:
        return dict(z)


def test_manual_dp_step_matches_reference(ref_manual_dp):
    params, opt = DP.start()
    mesh = MESH.make_host_mesh(devices=CPU4)
    step = OV.make_manual_dp_step(build(DP.cfg, "cpu").loss, adamw.apply,
                                  mesh)
    pr, orr, m = step(SH.replicate(params, mesh), SH.replicate(opt, mesh),
                      DP.batch(0))
    ref = ref_manual_dp
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), ref["gnorm"], rtol=1e-4)
    for (path, p), mm, vv in zip(_paths(pr[0]), SH.tree_leaves(orr[0].m),
                                 SH.tree_leaves(orr[0].v)):
        key = "/".join(path)
        np.testing.assert_allclose(p.numpy(), ref["p/" + key], rtol=0,
                                   atol=1e-6, err_msg=key)
        rel_close(mm, ref["m/" + key], 1e-4, key)
        rel_close(vv, ref["v/" + key], 1e-4, key)
    assert len(pr) == len(orr) == 4 and int(orr[0].step) == 1
    assert all(bit_equal(pr[0], p) and bit_equal(orr[0], o)
               for p, o in zip(pr[1:], orr[1:]))
    assert len(step.buckets) >= 1 and step.devices == list(mesh.devices.flat)


def test_manual_dp_step_follows_one_device_step_for_three_steps():
    params, opt = DP.start()
    mesh = MESH.make_host_mesh(devices=CPU4)
    _, one, _, _ = steps.make_train_step(DP.cfg, device="cpu")
    step = OV.make_manual_dp_step(build(DP.cfg, "cpu").loss, adamw.apply,
                                  mesh)
    pr, orr = SH.replicate(params, mesh), SH.replicate(opt, mesh)
    for i in range(3):
        batch = DP.batch(i)
        pr, orr, m = step(pr, orr, batch)
        params, opt, m1 = one(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["gnorm"]), float(m1["gnorm"]),
                                   rtol=1e-4)
        assert all(bit_equal(pr[0], p) for p in pr[1:])
    for a, b in zip(SH.tree_leaves(pr[0]), SH.tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(SH.tree_leaves(orr[0].m), SH.tree_leaves(opt.m)):
        rel_close(a, b.numpy(), 1e-4)


def test_bucketed_mean_is_the_shard_order_sum_on_every_shard():
    rng = np.random.default_rng(0)
    trees = [{"a": torch.from_numpy(rng.standard_normal((3, 5), np.float32)),
              "b": {"c": torch.from_numpy(
                  rng.standard_normal(7).astype(np.float32)).bfloat16()}}
             for _ in range(3)]
    buckets = OV.make_buckets(trees[0], bucket_bytes=16)
    assert len(buckets) == 2
    out = OV.bucketed_mean(trees, buckets)
    for k, get in (("a", lambda t: t["a"]), ("c", lambda t: t["b"]["c"])):
        want = get(trees[0]).clone()
        for t in trees[1:]:
            want = want + get(t)
        want = want / 3
        for o in out:
            assert torch.equal(get(o), want), k
        assert get(out[1]).data_ptr() != get(out[2]).data_ptr()


def test_split_batch_replicates_a_batch_it_does_not_split():
    """As the reference's guard drops the data axis of an input whose batch
    it does not divide: every shard gets the whole input, on its device;
    a batch the shards divide is split in order; inputs that disagree in
    their batch raise."""
    devices = ["cpu", "meta", "cpu", "meta"]
    batch = {"tokens": torch.arange(24).reshape(6, 4),
             "frames": torch.ones(6, 3, 2)}
    parts = OV.split_batch(batch, devices)
    assert OV.replicated(6, 4) and not OV.replicated(8, 4)
    assert not OV.replicated(1, 1)
    for part, dev in zip(parts, devices):
        assert set(part) == set(batch)
        for k, v in part.items():
            assert v.device.type == dev and v.shape == batch[k].shape
            if dev == "cpu":
                assert torch.equal(v, batch[k])
    even = OV.split_batch({"tokens": torch.arange(32).reshape(8, 4)}, CPU4)
    assert [p["tokens"][:, 0].tolist() for p in even] == [
        [0, 4], [8, 12], [16, 20], [24, 28]]
    with pytest.raises(ValueError, match="disagree in their batch"):
        OV.split_batch({"tokens": torch.zeros(6, 4),
                        "frames": torch.zeros(4, 3)}, CPU4)


def test_gather_rows_keeps_shard_zero_of_a_replicated_batch():
    parts = [torch.full((3, 2), float(i)) for i in range(2)]
    assert torch.equal(OV.gather_rows(parts, 3, "cpu"), parts[0])
    assert torch.equal(OV.gather_rows(parts, 6, "cpu"), torch.cat(parts))


def test_manual_dp_step_on_a_batch_the_shards_do_not_split():
    """B = 3 over 2 shards: each shard takes the whole batch, so the step
    equals the one-device full-batch step (loss, gnorm, the params and the
    moments after it), with the replicas bit-equal."""
    params, opt = DP.start()
    mesh = MESH.make_host_mesh(devices=["cpu"] * 2)
    _, one, _, _ = steps.make_train_step(DP.cfg, device="cpu")
    _, step, _, _ = steps.make_train_step(DP.cfg, mesh)
    batch = {k: v[:3] for k, v in DP.batch(0).items()}
    pr, orr, m = step(SH.replicate(params, mesh), SH.replicate(opt, mesh),
                      batch)
    params, opt, m1 = one(params, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(m1["gnorm"]),
                               rtol=1e-4)
    assert bit_equal(pr[0], pr[1]) and bit_equal(orr[0], orr[1])
    for a, b in zip(SH.tree_leaves(pr[0]), SH.tree_leaves(params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(SH.tree_leaves(orr[0].m), SH.tree_leaves(opt.m)):
        rel_close(a, b.numpy(), 1e-4)


# ------------------------------------------- make_train_step on a mesh ----
def text_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def grouped(D):
    """The reference's MoE with its grouped dispatch at G = D."""
    return mock.patch.object(RM, "_n_groups", lambda B: D)


@pytest.mark.parametrize("D", [4, 2])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "starcoder2-3b",
                                  "mixtral-8x7b"])
def test_mesh_train_step_matches_full_batch_reference(name, D):
    """``make_train_step(cfg, mesh)`` on D CPU shards: loss, gnorm, every
    gradient leaf (each replica's the same bits), the params and the
    moments after a step, against the reference's ``value_and_grad`` and
    ``adamw.apply`` on the full batch (MoE: grouped at G = D)."""
    rcfg = REF_SMOKE[name].scaled(dtype="float32")
    cfg = SMOKE[name].scaled(dtype="float32")
    ref = ref_build(rcfg)
    np_params = perturb(np.random.default_rng(3),
                        np_tree(ref.init(jax.random.key(0))))
    rp = jax.tree.map(jnp.asarray, np_params)
    ro = ref_adamw.init(rp)
    batch = text_batch(cfg)
    with grouped(D if cfg.is_moe else 1):
        (rl, _), rg = jax.value_and_grad(ref.loss, has_aux=True)(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
        rp2, ro2, rn = ref_adamw.apply(rp, rg, ro)

    mesh = MESH.make_host_mesh(devices=["cpu"] * D)
    _, step, _, _ = steps.make_train_step(cfg, mesh)
    seen, apply = [], adamw.apply

    def spy(p, g, o, **kw):
        seen.append(g)
        return apply(p, g, o, **kw)

    params = params_from_jax(np_params, device="cpu")
    with mock.patch.object(adamw, "apply", spy):
        pr, orr, m = step(SH.replicate(params, mesh),
                          SH.replicate(adamw.init(params), mesh),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(seen) == D and all(bit_equal(seen[0], g) for g in seen[1:])
    np.testing.assert_allclose(float(m["loss"]), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(rn), rtol=1e-4)
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p), seen[0], np_tree(rg))
    each_leaf(lambda o, r, p: np.testing.assert_allclose(
        o.numpy(), r, rtol=0, atol=1e-6, err_msg=p), pr[0], np_tree(rp2))
    each_leaf(lambda o, r, p: rel_close(o, r, 1e-4, p), orr[0].m,
              np_tree(ro2.m))
    assert all(bit_equal(pr[0], p) for p in pr[1:])


@pytest.mark.parametrize("D", [4, 2])
def test_shard_routing_is_reference_grouped_dispatch(D):
    """mixtral-8x7b's MoE layer: ``moe_fwd`` on each shard's tokens alone
    against the reference's ``_moe_groups`` at G = D on the same layer
    input (B = 4 rows of 16 tokens), y and the mean of the shards' aux."""
    rcfg = REF_SMOKE["mixtral-8x7b"].scaled(dtype="float32")
    cfg = SMOKE["mixtral-8x7b"].scaled(dtype="float32")
    tree = np_tree(ref_build(rcfg).init(jax.random.key(5)))["layers"]["moe"]
    p = {k: v[0] for k, v in tree.items()}
    x = np.random.default_rng(6).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    ry, raux = RM._moe_groups(jax.tree.map(jnp.asarray, p), rcfg,
                              jnp.asarray(x.reshape(D, B // D * S, -1)),
                              1.25)
    tp = params_from_jax(p, device="cpu")
    ys, auxes = zip(*(M.moe_fwd(tp, cfg, torch.from_numpy(xs))
                      for xs in np.split(x, D)))
    np.testing.assert_allclose(torch.cat(ys).reshape(D, -1, cfg.d_model),
                               np.asarray(ry), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(OV.pmean(auxes)), float(raux),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("maker", [steps.make_train_step,
                                   steps.make_serve_steps])
def test_model_axis_runs_every_stack(maker, monkeypatch):
    """A model axis > 1 runs every stack: zamba2, xLSTM and whisper build
    a step on (2, 2) of CPU shards and take it (a finite loss, or logits
    and a decode step), and so does qwen3's serving under
    ``REPRO_KV_SHARD=seq``. Held to the one-device math by
    ``tests/test_torch_tensor_parallel_stacks.py``."""
    mesh = MESH.make_host_mesh(2, CPU4)
    rng = np.random.default_rng(0)
    names = ["zamba2-7b", "xlstm-125m", "whisper-medium"]
    if maker is steps.make_serve_steps:
        names.append("qwen3-0.6b")
    for name in names:
        cfg = SMOKE[name]
        if name == "qwen3-0.6b":
            monkeypatch.setenv("REPRO_KV_SHARD", "seq")
        model, *fns = maker(cfg, mesh)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, 8)).astype(np.int32))}
        if cfg.enc_dec:
            batch["frames"] = torch.from_numpy((0.02 * rng.standard_normal(
                (B, cfg.n_frames, cfg.d_model))).astype(np.float32))
        if maker is steps.make_train_step:
            step, p_shapes = fns[0], fns[1]
            p_specs, o_specs = steps.train_specs(cfg, mesh, p_shapes)
            batch["labels"] = batch["tokens"]
            _, _, m = step(SH.shard_tree(params, SH.to_named(mesh, p_specs)),
                           SH.shard_tree(adamw.init(params),
                                         SH.to_named(mesh, o_specs)), batch)
            assert np.isfinite(float(m["loss"])), name
            continue
        prefill, decode = fns
        P = SH.shard_tree(params, SH.to_named(
            mesh, SH.param_specs(cfg, mesh, params)))
        cache = steps.shard_cache(cfg, mesh, model.make_cache(B, 12, "cpu"))
        if name == "qwen3-0.6b":
            assert tuple(cache["k"].sharding.spec)[2] == "model"
        logits, cache = prefill(P, batch, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        tok, _ = decode(P, tok, cache, 8)
        assert bool(torch.isfinite(logits).all()) and tok.shape == (B, 1)


def test_production_mesh_cannot_run_a_step():
    mesh = MESH.make_production_mesh()
    for maker in (steps.make_train_step, steps.make_serve_steps):
        with pytest.raises(ValueError, match="no devices"):
            maker(SMOKE["qwen3-0.6b"], mesh)


# ------------------------------------------------- serving on a mesh ----
SERVE = ("qwen3-0.6b", "mixtral-8x7b", "zamba2-7b", "xlstm-125m",
         "whisper-medium")
SERVE_S, SERVE_DECODE = 12, 4


def serve_inputs(cfg):
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, SERVE_S)
                                    ).astype(np.int32)}
    if cfg.enc_dec:
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model))).astype(np.float32)
    return batch


def serve(prefill, decode, params, batch, cache):
    logits, cache = prefill(params, batch, cache)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = [tok]
    for i in range(SERVE_DECODE):
        tok, cache = decode(params, tok, cache, SERVE_S + i)
        toks.append(tok)
    return logits, torch.cat(toks, 1)


@pytest.mark.parametrize("name", SERVE)
def test_mesh_serve_steps_match_one_device(name):
    """4 data shards of B = 4 prompts: the prefill's logits and the
    greedy tokens equal the one-device serve's (mixtral: the reference's
    grouped dispatch at G = 4, with a cache the prompt fills), and every
    cache leaf's rows lie on their shard."""
    cfg = SMOKE[name].scaled(dtype="float32")
    rcfg = REF_SMOKE[name].scaled(dtype="float32")
    np_params = np_tree(ref_build(rcfg).init(jax.random.key(2)))
    params = params_from_jax(np_params, device="cpu")
    batch = serve_inputs(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ctx = SERVE_S if cfg.is_moe else SERVE_S + SERVE_DECODE + 4
    mesh = MESH.make_host_mesh(devices=CPU4)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    cache = steps.shard_cache(cfg, mesh, model.make_cache(B, ctx))
    logits, toks = serve(prefill, decode, SH.replicate(params, mesh), tb,
                         cache)
    if cfg.is_moe:
        ref = ref_build(rcfg)
        rp = jax.tree.map(jnp.asarray, np_params)
        with grouped(4):
            want, rc = ref.prefill(rp, {"tokens": jnp.asarray(
                batch["tokens"])}, ref.make_cache(B, ctx))
            tok = jnp.argmax(want[:, -1], -1).astype(jnp.int32)[:, None]
            wtoks = [tok]
            for i in range(SERVE_DECODE):
                lg, rc = ref.decode_step(rp, tok, rc, SERVE_S + i)
                tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
                wtoks.append(tok)
        want = torch.from_numpy(np.array(want))
        wtoks = torch.from_numpy(np.concatenate(wtoks, 1))
    else:
        m1, p1, d1 = steps.make_serve_steps(cfg, device="cpu")
        want, wtoks = serve(p1, d1, params, tb, m1.make_cache(B, ctx))
    assert logits.shape == want.shape == (B, 1, cfg.vocab)
    rel_close(logits, want.numpy(), 1e-5)
    assert torch.equal(toks, wtoks)
    for leaf in SH.tree_leaves(cache):
        spec = tuple(leaf.sharding.spec)
        assert ("data",) in spec or "data" in spec, spec


@pytest.mark.parametrize("name,B", [("qwen3-0.6b", 1), ("qwen3-0.6b", 6),
                                    ("zamba2-7b", 1)])
def test_mesh_serve_steps_replicate_a_batch_they_do_not_split(name, B):
    """4 data shards of B = 1 or 6 prompts, which they do not divide: the
    batch and its cache are replicated, every shard serves the whole batch
    on its copy, and the prefill's logits and the greedy tokens are
    bit-equal to the one-device serve's (zamba2: its SSM states updated in
    place on each copy)."""
    cfg = SMOKE[name].scaled(dtype="float32")
    rcfg = REF_SMOKE[name].scaled(dtype="float32")
    params = params_from_jax(np_tree(ref_build(rcfg).init(
        jax.random.key(2))), device="cpu")
    tb = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (B, SERVE_S)).astype(np.int32))}
    ctx = SERVE_S + SERVE_DECODE + 4
    mesh = MESH.make_host_mesh(devices=CPU4)
    model, prefill, decode = steps.make_serve_steps(cfg, mesh)
    cache = steps.shard_cache(cfg, mesh, model.make_cache(B, ctx))
    logits, toks = serve(prefill, decode, SH.replicate(params, mesh), tb,
                         cache)
    m1, p1, d1 = steps.make_serve_steps(cfg, device="cpu")
    want, wtoks = serve(p1, d1, params, tb, m1.make_cache(B, ctx))
    assert logits.shape == want.shape == (B, 1, cfg.vocab)
    assert torch.equal(logits, want) and torch.equal(toks, wtoks)
    for leaf in SH.tree_leaves(cache):
        assert "data" not in tuple(leaf.sharding.spec)
        assert all(torch.equal(b, leaf.blocks[0, 0])
                   for b in leaf.blocks.flat)


# ------------------------------------------------ placement, reshard ----
def test_shard_and_gather_are_bit_equal_with_guard_demotion():
    mesh = MESH.make_host_mesh(2, CPU4)
    tree = {"a": torch.arange(24, dtype=torch.float32).reshape(6, 4),
            "b": torch.arange(20).reshape(5, 4).bfloat16()}
    specs = {k: SH._guard(mesh, v.shape, ("model", None))
             for k, v in tree.items()}
    assert specs == {"a": SH.P("model", None), "b": SH.P(None, None)}
    placed = SH.shard_tree(tree, SH.to_named(mesh, specs))
    a, b = placed["a"].blocks, placed["b"].blocks
    assert a.shape == (2, 2) and tuple(a[0, 0].shape) == (3, 4)
    assert torch.equal(a[1, 0], tree["a"][:3])         # model index 0
    assert torch.equal(a[0, 1], tree["a"][3:])         # model index 1
    assert all(torch.equal(x, tree["b"]) for x in b.flat)
    assert all(x.data_ptr() != tree["b"].data_ptr() for x in b.flat)
    assert bit_equal(SH.gather_tree(placed), tree)
    # the batch axes across two dims of one leaf, (pod, data) on one dim
    pod = CTX.Mesh((2, 2, 1), ("pod", "data", "model"), CPU4)
    t = torch.arange(16.).reshape(4, 4)
    st = SH.shard_tree(t, SH.Sharding(pod, SH.P(("pod", "data"))))
    assert [x[0, 0].item() for x in st.blocks.flat] == [0, 4, 8, 12]
    assert torch.equal(st.gather(), t)
    assert SH.data_positions(pod) == [(0, 0, 0), (0, 1, 0), (1, 0, 0),
                                      (1, 1, 0)]


def test_param_tree_round_trips_on_meshes_of_every_shape():
    cfg = SMOKE["qwen3-0.6b"]
    params = build(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for model in (1, 2, 4):
        mesh = MESH.make_host_mesh(model, CPU4)
        placed = SH.shard_tree(params, SH.to_named(
            mesh, SH.param_specs(cfg, mesh, params)))
        assert bit_equal(SH.gather_tree(placed), params)


def test_restore_onto_another_mesh_and_reshard_are_bit_equal(tmp_path):
    """A step on a (4, 1) mesh, saved from replica 0; restored onto (2, 2)
    and onto one device, and resharded back: each gathers bit-equal to
    what was saved."""
    cfg = DP.cfg
    params, opt = DP.start()
    mesh = MESH.make_host_mesh(devices=CPU4)
    _, step, p_shapes, _ = steps.make_train_step(cfg, mesh)
    pr, orr, _ = step(SH.replicate(params, mesh), SH.replicate(opt, mesh),
                      DP.batch(0))
    saved = {"params": pr[0], "opt": orr[0]}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, saved, blocking=True)
    template = {"params": params, "opt": opt}

    def named(mesh):
        p = SH.param_specs(cfg, mesh, p_shapes)
        return SH.to_named(mesh, {"params": p, "opt": adamw.AdamWState(
            step=SH.P(), m=p, v=p)})

    m22 = MESH.make_host_mesh(2, CPU4)
    at_step, on22 = mgr.restore_tree(template, shardings=named(m22))
    assert at_step == 1
    leaf = on22["params"]["layers"]["attn"]["wq"]
    assert isinstance(leaf, SH.ShardedTensor)
    assert leaf.blocks.shape == (2, 2)
    assert leaf.blocks[0, 0].shape[-1] * 2 == leaf.shape[-1]
    assert bit_equal(SH.gather_tree(on22), saved)
    _, one = mgr.restore_tree(template, device="cpu")
    assert bit_equal(one, saved)
    back = elastic.reshard(on22, named(mesh))
    assert bit_equal(SH.gather_tree(back), saved)
    assert all(bit_equal(s["params"], saved["params"])
               for s in SH.data_shards(back, mesh))
    # a checkpoint holds full arrays: a sharded tree saves as its gather
    mgr.save(2, on22, blocking=True)
    assert bit_equal(mgr.restore_tree(template, 2)[1], saved)


# ------------------------------------------------------------ train CLI ----
CLI = ["--smoke", "--seq", "32", "--batch", "4", "--log-every", "1"]


def test_train_cli_takes_steps_on_two_cpu_shards(tmp_path, capsys):
    train.main([*CLI, "--steps", "2", "--devices", "cpu,cpu",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 1}" in out
    assert "step     2 loss" in out and "done" in out
    step, flat = CheckpointManager(tmp_path).restore()
    assert step == 2 and int(flat["opt/.step"]) == 2


def test_train_cli_resumes_onto_another_mesh(tmp_path, capsys):
    """Two steps on two shards, then two more on one device from that
    checkpoint, against four uninterrupted steps on two shards."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train.main([*CLI, "--steps", "4", "--devices", "cpu,cpu",
                "--ckpt-dir", a])
    train.main([*CLI, "--steps", "2", "--devices", "cpu,cpu",
                "--ckpt-dir", b])
    train.main([*CLI, "--steps", "4", "--devices", "cpu", "--ckpt-dir", b])
    assert "resumed from step 2" in capsys.readouterr().out
    (sa, fa), (sb, fb) = (CheckpointManager(d).restore() for d in (a, b))
    assert sa == sb == 4 and fa.keys() == fb.keys()
    assert int(fa["opt/.step"]) == int(fb["opt/.step"]) == 4
    for k in fa:
        rel_close(fb[k], fa[k].float().numpy(), 2e-2, k)


def test_train_cli_refuses_model_parallel(tmp_path):
    """``--model-parallel`` runs (``tests/test_torch_tensor_parallel.py``,
    ``test_torch_tensor_parallel_stacks.py``) for every stack where it
    divides the devices; one that does not divide them raises, and so
    does whisper, whose frames the token pipeline does not give, on a
    model axis as on one device."""
    with pytest.raises(ValueError, match="does not divide"):
        train.main([*CLI, "--model-parallel", "3", "--devices", "cpu,cpu",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="'frames'"):
        train.main([*CLI, "--arch", "whisper-medium", "--model-parallel",
                    "2", "--devices", "cpu,cpu", "--ckpt-dir",
                    str(tmp_path)])
