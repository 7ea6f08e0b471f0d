"""The port's checkpoints, data pipeline, health monitor and train CLI on
the CPU: the reference's own tests (``tests/test_runtime.py``) on the
port, checkpoints across the two packages bit for bit, and the CLI
interrupted and resumed against an uninterrupted run."""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKE as REF_SMOKE
from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.models.model import build as ref_build
from repro.optim import adamw as ref_adamw
from repro.runtime.checkpoint import CheckpointManager as RefManager
from repro_torch.configs import SMOKE
from repro_torch.convert import opt_state_to_numpy
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import train
from repro_torch.models import ssm as SSM
from repro_torch.models.model import build
from repro_torch.optim import adamw
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.health import HealthMonitor


def bits(x) -> np.ndarray:
    """A leaf's bytes, whichever package holds it."""
    if torch.is_tensor(x):
        x = x.detach().cpu().reshape(-1)
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def port_tree():
    """qwen3-0.6b's SMOKE params (bf16) and an AdamW state one step in."""
    model = build(SMOKE["qwen3-0.6b"], "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    grads = adamw.tree_map(lambda p: torch.ones_like(p) * 1e-3, params)
    _, opt, _ = adamw.apply(params, grads, adamw.init(params))
    return {"params": params, "opt": opt}


def test_checkpoint_roundtrip(tmp_path):
    tree = port_tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, tree, blocking=True)
    assert mgr.latest_step() == 7
    template = {"params": adamw.tree_map(torch.zeros_like, tree["params"]),
                "opt": adamw.init(tree["params"])}
    step, restored = mgr.restore_tree(template)
    assert step == 7
    assert int(restored["opt"].step) == 1
    for f in ("params", "m", "v"):
        a_tree = tree["params"] if f == "params" else getattr(tree["opt"], f)
        b_tree = (restored["params"] if f == "params"
                  else getattr(restored["opt"], f))
        for a, b in zip(adamw.leaves(a_tree), adamw.leaves(b_tree)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(bits(a), bits(b))


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.arange(8)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    steps = sorted(int(p.name[5:-7]) for p in tmp_path.glob("step_*.COMMIT"))
    assert steps == [3, 4]
    # a partial (uncommitted) dir is ignored
    (tmp_path / "step_00000009").mkdir()
    assert mgr.latest_step() == 4


@pytest.mark.parametrize("template", [
    {"x": torch.zeros(4, dtype=torch.int64)},
    {"x": torch.zeros(8, dtype=torch.float32)},
    {"x": torch.zeros((2, 4), dtype=torch.int64)}])
def test_restore_refuses_another_shape_or_dtype(tmp_path, template):
    """A checkpoint of another configuration raises on restore instead of
    being cast or reshaped into the template."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.arange(8)}, blocking=True)
    with pytest.raises(ValueError, match="leaf x"):
        mgr.restore_tree(template)
    _, got = mgr.restore_tree({"x": torch.zeros(8, dtype=torch.int64)})
    assert torch.equal(got["x"], torch.arange(8))


def test_flat_keys_are_the_reference_s(tmp_path):
    """``params/embed/out``, ``opt/.step``, ``opt/.m/embed/tok``: the same
    keys, shapes and dtype names in both packages' manifests."""
    import json
    tree = port_tree()
    CheckpointManager(tmp_path / "port").save(1, tree, blocking=True)
    rp = ref_build(REF_SMOKE["qwen3-0.6b"]).init(jax.random.key(0))
    RefManager(tmp_path / "ref").save(
        1, {"params": rp, "opt": ref_adamw.init(rp)}, blocking=True)
    man = [json.loads((tmp_path / d / "step_00000001" / "manifest.json")
                      .read_text())["leaves"] for d in ("port", "ref")]
    assert man[0] == man[1]
    assert {"params/embed/out", "opt/.step", "opt/.m/embed/tok"} <= set(
        man[0])
    assert man[0]["params/embed/tok"]["dtype"] == "bfloat16"


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    tree = port_tree()
    CheckpointManager(tmp_path).save(3, tree, blocking=True)
    rp = ref_build(REF_SMOKE["qwen3-0.6b"]).init(jax.random.key(1))
    step, got = RefManager(tmp_path).restore_tree(
        {"params": rp, "opt": ref_adamw.init(rp)})
    assert step == 3
    flat = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat) == len(list(adamw.leaves(
        {"params": tree["params"], "m": tree["opt"].m,
         "v": tree["opt"].v}))) + 1
    for path, leaf in flat:
        mine = tree
        for key in path:
            mine = (mine[key.key] if hasattr(key, "key")
                    else getattr(mine, key.name))
        assert np.asarray(leaf).dtype.name == str(mine.dtype).replace(
            "torch.", ""), path
        assert np.array_equal(bits(leaf), bits(mine)), path


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rp = ref_build(REF_SMOKE["qwen3-0.6b"]).init(jax.random.key(2))
    rg = jax.tree.map(lambda p: p * 0 + 1e-3, rp)
    _, ro, _ = ref_adamw.apply(rp, rg, ref_adamw.init(rp))
    RefManager(tmp_path).save(5, {"params": rp, "opt": ro}, blocking=True)
    template = port_tree()
    step, got = CheckpointManager(tmp_path).restore_tree(template)
    assert step == 5
    want = {"params": rp, "m": ro.m, "v": ro.v}
    mine = {"params": got["params"], "m": got["opt"].m, "v": got["opt"].v}
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        src = mine
        for key in path:
            src = src[key.key]
        assert str(src.dtype) == f"torch.{leaf.dtype}", path
        assert np.array_equal(bits(src), bits(leaf)), path
    assert got["opt"].step.dtype == torch.int32
    assert np.array_equal(opt_state_to_numpy(got["opt"]).step,
                          np.asarray(ro.step))


def test_pipeline_deterministic_resume():
    cfg = PipelineConfig(vocab=128, seq_len=32, global_batch=8)
    p1 = TokenPipeline(cfg)
    p2 = TokenPipeline(cfg)
    b5 = p1.batch_at(5)
    assert np.array_equal(b5["tokens"], p2.batch_at(5)["tokens"])
    assert not np.array_equal(b5["tokens"], p1.batch_at(6)["tokens"])
    # host sharding partitions the batch deterministically
    h0 = TokenPipeline(PipelineConfig(128, 32, 8, n_hosts=2, host_id=0))
    h1 = TokenPipeline(PipelineConfig(128, 32, 8, n_hosts=2, host_id=1))
    assert h0.batch_at(3)["tokens"].shape[0] == 4
    assert not np.array_equal(h0.batch_at(3)["tokens"],
                              h1.batch_at(3)["tokens"])
    # the copy gives the reference's batches
    ref = RefTokenPipeline(RefPipelineConfig(128, 32, 8)).batch_at(5)
    assert all(np.array_equal(b5[k], ref[k]) for k in ("tokens", "labels"))


def test_health_monitor():
    m = HealthMonitor(n_hosts=4, heartbeat_timeout_s=10.0,
                      straggler_factor=1.5, min_samples=4)
    t0 = 1000.0
    for step in range(8):
        for h in range(4):
            if h == 3 and step >= 2:
                continue  # host 3 dies after step 1
            dt = 1.0 if h != 2 else 2.5  # host 2 straggles
            m.heartbeat(h, step_time_s=dt, now=t0 + step)
    d = m.decide(now=t0 + 12)   # hosts 0-2 beat 5s ago; host 3 beat 11s ago
    assert d["evict_now"] == [3]
    assert 2 in d["drain_at_checkpoint"]
    assert d["action"] == "restart_elastic"


CLI = ["--smoke", "--seq", "32", "--batch", "4", "--ckpt-every", "3",
       "--device", "cpu"]


def _resumes_exactly(tmp_path, capsys, cli):
    """``--steps 6`` in one run against ``--steps 3`` then ``--steps 6``
    from its checkpoint: the step-6 checkpoints are equal bit for bit."""
    train.main([*cli, "--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    train.main([*cli, "--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    assert CheckpointManager(tmp_path / "b").latest_step() == 3
    train.main([*cli, "--steps", "6", "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 3" in capsys.readouterr().out
    (sa, a), (sb, b) = (CheckpointManager(tmp_path / d).restore()
                        for d in ("a", "b"))
    assert sa == sb == 6 and a.keys() == b.keys()
    assert "opt/.step" in a and int(a["opt/.step"]) == 6
    for k in a:
        assert np.array_equal(bits(a[k]), bits(b[k])), k


def test_train_cli_resumes_exactly(tmp_path, capsys):
    _resumes_exactly(tmp_path, capsys, CLI)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_train_cli_resumes_exactly_on_the_ssm_stacks(tmp_path, capsys, arch):
    """The same for the recurrent stacks' SMOKE configs, their scans in
    checkpointed chunks (``SCAN_CHUNK`` patched to 5 of the 32 steps)."""
    with mock.patch.object(SSM, "SCAN_CHUNK", 5):
        _resumes_exactly(tmp_path, capsys, [*CLI, "--arch", arch])
    ckpt = CheckpointManager(tmp_path / "a").restore()[1]
    assert any(k.startswith("params/super/") for k in ckpt)


def test_train_cli_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        train.main([*CLI, "--model-parallel", "2", "--ckpt-dir",
                    str(tmp_path)])
    # the token pipeline gives whisper no frames
    with pytest.raises(ValueError, match="'frames'"):
        train.main([*CLI, "--arch", "whisper-medium", "--ckpt-dir",
                    str(tmp_path)])
