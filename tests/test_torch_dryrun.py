"""The dry run (``repro_torch.launch.dryrun``, ``launch/hlo_analysis.py``,
``launch/shapes.py``) on the CPU at SMOKE size.

The planner runs the port's own steps on fake tensors (``meta:i``, one
index a card) and counts FLOPs, HBM bytes, copies between devices and
live bytes from the op stream. Held here:

* the cells and shapes equal the reference's, and ``model_flops`` its
  formula written out;
* each flash custom op's fake outputs (shapes, dtypes) and FLOP formula,
  causal and full, dh 64/112/128;
* on a (2, 2) mesh of ``meta:i`` (serve steps), each device's argument
  bytes equal the bytes of the blocks the specs place there, and one
  layer's ``Group.sum``/``Group.gather`` bytes equal their reckoning;
* a train step's planned FLOPs equal ``FlopCounterMode`` over the same
  step on real CPU tensors, exactly, with each attention call counted at
  its kernel's formula;
* a long_500k cell (a batch of 1) plans on a mesh whose data axis does
  not divide it, each data row serving the whole batch, and 2 and 3
  such rows extrapolate to the traced mesh; a trace past torch's 8-bit
  device index raises;
* the depth calibration (2 and 3 units) equals a full-depth trace of a
  4-layer config, the 2-and-3-row scaling a traced (4, 2) mesh, and the
  planned scans the step-by-step ones: every count, exactly.

``repro.launch.dryrun`` is not imported: it asks for 512 host devices at
import.
"""
from unittest import mock

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import shapes as REF_SHAPES
from repro_torch.configs import SMOKE
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.ctx import Mesh
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as SHAPES
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ssm
from repro_torch.models.model import build
from repro_torch.optim import adamw

AXES = ("data", "model")


def test_shapes_and_cells_equal_the_reference():
    as_tuple = lambda s: (s.name, s.seq_len, s.global_batch, s.mode)  # noqa
    assert {k: as_tuple(v) for k, v in SHAPES.SHAPES.items()} == \
        {k: as_tuple(v) for k, v in REF_SHAPES.SHAPES.items()}
    assert SHAPES.LONG_OK == REF_SHAPES.LONG_OK
    assert SHAPES.ALL_ARCHS == REF_SHAPES.ALL_ARCHS
    assert [(a, as_tuple(s)) for a, s in SHAPES.cells()] == \
        [(a, as_tuple(s)) for a, s in REF_SHAPES.cells()]


@pytest.mark.parametrize("arch,shape", [(a, s.name)
                                        for a, s in SHAPES.cells()])
def test_model_flops_is_the_reference_formula(arch, shape):
    """6 N_active D for training, 2 N_active D for a prefill, 2 N_active
    B for a decode step, with the reference's parameter count."""
    s = SHAPES.SHAPES[shape]
    _, active = REF_ARCHS[arch].param_count()
    tokens = {"train": 6.0 * s.seq_len * s.global_batch,
              "prefill": 2.0 * s.seq_len * s.global_batch,
              "decode": 2.0 * s.global_batch}[s.mode]
    assert DR.model_flops(DR.ARCHS[arch], s) == active * tokens


def _fwd_flops(BH, S, dh, causal):
    return 4 * BH * S * S * dh // (2 if causal else 1)


@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(FA.COUNTS))
def test_flash_op_fake_shapes_and_flops(name, causal, dh):
    """Each op under ``FakeTensorMode`` (on ``meta:1``): o like q, lse
    ``[BH, S]`` fp32 (empty when not asked for), dq/dk/dv like q/k/v;
    FlopCounterMode counts 4 BH S^2 dh (halved when causal) forward and
    2.5 times that backward."""
    BH, BHkv, S = 8, 2, 96
    op = getattr(torch.ops.repro_torch, name)
    with FakeTensorMode():
        dev = torch.device("meta", 1)
        q, o, do = (torch.empty(BH, S, dh, dtype=torch.bfloat16, device=dev)
                    for _ in range(3))
        k, v = (torch.empty(BHkv, S, dh, dtype=torch.bfloat16, device=dev)
                for _ in range(2))
        lse = torch.empty(BH, S, dtype=torch.float32, device=dev)
        with FlopCounterMode(display=False) as fc:
            if name == "flash_attention_bwd_sm90":
                out = op(q, k, v, o, do, lse, causal)
            elif name == "flash_attention_bwd":
                out = op(q, k, v, o, do, causal, None)
            else:
                out = op(q, k, v, causal, True)
                o2, lse2 = op(q, k, v, causal, False)
                assert lse2.shape == (0,) and o2.shape == q.shape
    fwd = _fwd_flops(BH, S, dh, causal)
    if name.startswith("flash_attention_bwd"):
        want = [(t.shape, t.dtype, t.device) for t in (q, k, v)]
        assert fc.get_total_flops() == fwd * 5 // 2
    else:
        want = [(q.shape, q.dtype, dev),
                ((BH, S), torch.float32, dev)]
        assert fc.get_total_flops() == 2 * fwd
    assert [(t.shape, t.dtype, t.device) for t in out] == want


def test_flash_wrappers_count_on_meta_and_give_formula_flops():
    """Within a trace (``on_cards``) each wrapper calls its op on the
    mesh's ``meta:i`` tensors and counts the launch the card would make; a
    bf16 step at dh 128 is one sm90 forward and one sm90 backward (68.7 +
    171.8 GFLOP at BH 64, S 2048)."""
    FA.reset_counts()
    with DR.on_cards(), FlopCounterMode(display=False) as fc:
        q = torch.empty(64, 2048, 128, dtype=torch.bfloat16,
                        device="meta:2", requires_grad=True)
        k = torch.empty(16, 2048, 128, dtype=torch.bfloat16,
                        device="meta:2", requires_grad=True)
        FA.flash_attention(q, k, k, True).sum().backward()
    assert fc.get_total_flops() == 68719476736 + 171798691840
    assert FA.COUNTS == {"flash_attention_sm90": 1,
                         "flash_attention_simt": 0,
                         "flash_attention_bwd": 0,
                         "flash_attention_bwd_sm90": 1}
    FA.reset_counts()


def _block_bytes(tree, shardings, pos):
    total = 0
    for t, s in zip(SH.tree_leaves(tree), SH.tree_leaves(shardings)):
        sl = s.block(t.shape, pos)
        total += torch.empty(t.shape, device="meta")[sl].numel() * \
            t.element_size()
    return total


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mesh_arguments_and_collectives(mode):
    """A 2-layer qwen3 SMOKE serve step on a (2, 2) mesh of ``meta:i``:
    each device's argument bytes are its blocks of the params and the
    cache (``param_specs``/``cache_specs``), and device 0 also holds the
    batch; one layer adds, for each of the D = 2 data rows and M = 2
    model shards, two ``Group.sum`` of the hidden state (M - 1 parts in,
    M - 1 copies out) and ``Group.gather`` of K and V (M - 1 blocks in,
    M - 1 whole copies out)."""
    cfg = SMOKE["qwen3-0.6b"]
    D, M, B, S = 2, 2, 4, 16
    t = {L: DR.trace(cfg.scaled(n_layers=L), mode, S, B, (D, M), AXES)
         for L in (1, 2)}
    mesh = Mesh((D, M), AXES)
    model = build(cfg, "meta")
    p = model.abstract_params()
    psh = SH.to_named(mesh, SH.param_specs(cfg, mesh, p))
    cache = model.make_cache(B, S, "meta")
    csh = SH.to_named(mesh, SH.cache_specs(cfg, mesh, cache))
    batch = B * (S if mode == "prefill" else 1) * 4       # int32 tokens
    for i, pos in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        want = _block_bytes(p, psh, pos) + _block_bytes(cache, csh, pos)
        assert t[2][("dev", i, "argument")] == want + (batch if i == 0
                                                       else 0)
    rows = B // D * (S if mode == "prefill" else 1)
    kv = cfg.n_kv_heads * cfg.d_head
    one = {k[1]: t[2][k] - t[1].get(k, 0) for k in t[2]
           if k[0] == "coll_bytes"}
    assert one.pop("Group.sum") == D * 2 * 2 * (M - 1) * rows * \
        cfg.d_model * 2
    assert one.pop("Group.gather") == D * 2 * (M - 1) * \
        (kv // M + kv) * rows * 2
    assert set(one.values()) == {0}


@pytest.mark.parametrize("mesh", [None, (1, 1)])
def test_train_flops_equal_flop_counter_on_real_tensors(mesh):
    """The planned FLOPs of a train step (one device, and a (1, 1) mesh)
    equal ``FlopCounterMode`` over the same step on real CPU tensors,
    exactly. On the CPU a flash wrapper runs its plain version
    (``flash_ref``, ``flash_bwd_ref``); each such call's counted FLOPs
    are swapped for its op's formula, which the plan counts."""
    cfg = SMOKE["qwen3-0.6b"]
    B, S = 2, 16
    counts = DR.trace(cfg, "train", S, B, mesh, AXES if mesh else None)
    where = Mesh(mesh, AXES, ["cpu"]) if mesh else "cpu"
    model, step, _, _ = make_train_step(cfg, where)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = adamw.init(params)
    if mesh:
        params, opt = SH.replicate(params, where), [opt]
    batch = {k: torch.zeros(B, S, dtype=torch.int32)
             for k in ("tokens", "labels")}
    fc = FlopCounterMode(display=False)
    swap = {"calls": 0, "flops": 0}

    def as_kernel(plain, causal_at, times):
        # the op's formula (times/2 of the forward's) for plain's FLOPs
        def run(q, *args, **kwargs):
            before = fc.get_total_flops()
            out = plain(q, *args, **kwargs)
            BH, Sq, dh = q.shape
            formula = _fwd_flops(BH, Sq, dh, args[causal_at]) * times // 2
            swap["calls"] += 1
            swap["flops"] += formula - (fc.get_total_flops() - before)
            return out
        return run

    with mock.patch.object(FA, "flash_ref", as_kernel(FA.flash_ref, 2, 2)), \
            mock.patch.object(FA, "flash_bwd_ref",
                              as_kernel(FA.flash_bwd_ref, 4, 5)), fc:
        step(params, opt, batch)
    launches = sum(v for k, v in counts.items() if k[0] == "launch")
    assert swap["calls"] == launches == 3 * cfg.n_layers
    assert counts[("dev", 0, "flops")] == \
        fc.get_total_flops() + swap["flops"] > 0


def test_long_500k_plans_where_the_data_axis_does_not_divide_the_batch():
    """xlstm-125m's long_500k cell (one sequence) on a (4, 2) mesh standing
    in for the production one: the data axis does not divide the batch of
    1, so every data row serves it whole, and the cell plans; each data
    row's devices count the same work as row 0's."""
    mesh = Mesh((4, 2), AXES)
    with mock.patch.object(DR, "make_production_mesh",
                           lambda multi_pod=False: mesh):
        rec = DR.run_cell("xlstm-125m", "long_500k", False)
    assert rec["status"] == "ok" and rec["n_chips"] == 8
    cfg = SMOKE["xlstm-125m"]
    whole = DR.plan(cfg, "decode", 64, 1, (4, 2), AXES, calibrate=False)
    devs = DR.per_device(whole["counts"])
    for i in range(2, 8):
        assert devs[i]["flops"] == devs[i % 2]["flops"] > 0
    # from 2 and 3 rows, each with the whole batch: every count the same
    rows = DR.plan(cfg, "decode", 64, 1, (4, 2), AXES, calibrate=False,
                   trace_devices=4)
    assert rows["rows"] == [2, 3] and whole["rows"] is None
    assert rows["counts"] == whole["counts"]


def test_a_trace_past_torchs_device_index_raises():
    """``torch.device`` keeps its index in 8 signed bits (meta:256 is
    meta:0), so a trace of more than 128 devices would merge two cards:
    it raises before it runs."""
    assert torch.device("meta", 256) == torch.device("meta", 0)
    with pytest.raises(ValueError, match="at most 128 devices"):
        DR.trace(SMOKE["xlstm-125m"], "decode", 8, 1, (16, 16), AXES)


def test_depth_calibration_equals_full_depth():
    """2 and 3 units extrapolated to a 4-layer config: every count
    (FLOPs, bytes, argument, output and peak bytes, launches) equals a
    trace of all 4 layers."""
    cfg = SMOKE["qwen3-0.6b"].scaled(n_layers=4)
    a = DR.plan(cfg, "train", 16, 2, calibrate=True)
    b = DR.plan(cfg, "train", 16, 2, calibrate=False)
    assert a["units"] == 4 and b["units"] is None
    assert a["counts"] == b["counts"]
    assert b["counts"][("dev", 0, "peak")] > 0


def test_row_scaling_equals_traced_mesh():
    """A (4, 2) train step from traces of 2 and 3 data rows equals the
    (4, 2) mesh traced whole: every device's counts, every collective's
    bytes by label (``bucketed_mean`` and ``pmean`` sum on row 0)."""
    cfg = SMOKE["qwen3-0.6b"].scaled(n_layers=1)
    a = DR.plan(cfg, "train", 8, 4, (4, 2), AXES, calibrate=False,
                trace_devices=4)
    b = DR.plan(cfg, "train", 8, 4, (4, 2), AXES, calibrate=False,
                trace_devices=8)
    assert a["rows"] == [2, 3] and b["rows"] is None
    assert a["counts"] == b["counts"]
    assert a["counts"][("coll_bytes", "bucketed_mean")] > 0


def test_planned_scans_equal_step_by_step():
    """xLSTM (both scans) trained over 6 chunks of 4 steps: the scans
    measured at 2, 3 and 4 chunks and fitted give every count of the
    step-by-step trace."""
    cfg = SMOKE["xlstm-125m"]
    with mock.patch.object(ssm, "SCAN_CHUNK", 4):
        a = DR.trace(cfg, "train", 24, 1, None, None)
        b = DR.trace(cfg, "train", 24, 1, None, None, plan_scans=False)
    assert a == b
    assert a[("dev", 0, "peak")] > a[("dev", 0, "argument")] > 0
