"""The port's batch-sharded engine (``core.bsp.ShardedBatchedMachine``,
facade kind ``sharded``) against the reference's, on the CPU.

Mirrors ``tests/test_sharded.py``. The reference runs with 8 forced host
devices in a subprocess and saves its final state as ``.npz``; the port
runs the same Program (byte-identical, ``tests/test_torch_compile.py``) on
``devices=["cpu"] * 8``, eight shards in one process. Every comparison is
exact: the ISA is 16-bit integer arithmetic.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.sim as tsim
from repro_torch.circuits import FINISH, build
from repro_torch.circuits.common import Planes, make_counter
from repro_torch.core.bsp import (PAD_FROZEN_CYC, BatchedMachine, Machine,
                                  ShardedBatchedMachine, from_words)
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.core.netlist import Circuit
from repro_torch.sim import BatchedEngine, ShardedBatchedEngine

ROOT = Path(__file__).resolve().parents[1]
HW = HardwareConfig(grid_width=5, grid_height=5)
CPU8 = ["cpu"] * 8
NAMES = ("mm", "mc", "bc")
B = 11
SEEDS = [1000 + i for i in range(B)]
LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")


def run_8dev(body: str) -> str:
    """``body`` in a subprocess with 8 forced host devices (the pattern of
    ``tests/test_sharded.py::_run_8dev``)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``ShardedBatchedMachine`` on 8 devices, B=11 on mm, mc and
    bc (small, 5x5): its final state and accessors, per circuit."""
    out = tmp_path_factory.mktemp("sharded") / "ref.npz"
    run_8dev(f"""
        import json
        import numpy as np, jax
        from repro.circuits import build
        from repro.core.isa import HardwareConfig
        from repro.core.compile import compile_circuit
        from repro.core.bsp import ShardedBatchedMachine

        assert len(jax.devices()) == 8
        HW = HardwareConfig(grid_width=5, grid_height=5)
        arrays = {{}}
        for nm in {NAMES!r}:
            b = build(nm, "small", seeds={SEEDS!r})
            prog = compile_circuit(b.circuit, HW)
            sm = ShardedBatchedMachine(prog, images=b.images_batch(prog))
            assert (sm.D, sm.B, sm.Bp) == (8, {B}, 16)
            st = sm.run(sm.init_state(), b.n_cycles + 10)
            for k, leaf in zip({LEAVES!r}, st):
                arrays[nm + "/" + k] = np.asarray(leaf)
            arrays[nm + "/perf"] = np.array(json.dumps(sm.perf(st)))
            arrays[nm + "/exceptions"] = np.array(json.dumps(
                [{{str(c): e for c, e in x.items()}}
                 for x in sm.exceptions(st)]))
        np.savez("{out}", **arrays)
    """)
    return dict(np.load(out))


def gathered(sm, st) -> dict:
    """The port's sharded state on the host, in the reference's dtypes."""
    g = sm.gather(st)
    return {k: (leaf.numpy() if k == "cache_tags" else from_words(leaf))
            for k, leaf in zip(LEAVES, g)}


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_reference_8dev(reference, name):
    """B=11 over 8 shards (padded to 16): every leaf of every element,
    padding included, equals the reference's; padding never executes,
    raises or counts, and ``perf``/``exceptions`` cover the logical B."""
    import json
    b = build(name, "small", seeds=SEEDS)
    prog = compile_circuit(b.circuit, HW)
    sm = ShardedBatchedMachine(prog, images=b.images_batch(prog),
                               devices=CPU8)
    assert (sm.D, sm.B, sm.Bp, sm.Bl) == (8, B, 16, 2)
    st = sm.run(sm.init_state(), b.n_cycles + 10)
    got = gathered(sm, st)
    for k in LEAVES:
        np.testing.assert_array_equal(got[k], reference[f"{name}/{k}"],
                                      err_msg=k)
    assert not got["flags"][B:].any() and not got["counters"][B:].any()
    assert sm.perf(st) == json.loads(str(reference[f"{name}/perf"]))
    exc = sm.exceptions(st)
    assert len(exc) == B
    assert [{str(c): e for c, e in x.items()} for x in exc] == \
        json.loads(str(reference[f"{name}/exceptions"]))
    assert all(set(x.values()) == {FINISH} for x in exc)
    assert sm.perf(st)["vcycles"] == B * b.n_cycles


def test_sharded_single_device_matches_batched():
    """D=1 is the degenerate list: the sharded engine reproduces the
    batched one exactly (the same binding, one shard)."""
    b = build("mc", "small", seeds=[3, 11, 42])
    prog = compile_circuit(b.circuit, HW)
    sm = ShardedBatchedMachine(prog, images=b.images_batch(prog),
                               devices=["cpu"])
    assert (sm.D, sm.Bp) == (1, sm.B)
    bm = BatchedMachine(prog, images=b.images(prog), device="cpu")
    st = sm.run(sm.init_state(), b.n_cycles + 10)
    sb = bm.run(bm.init_state(), b.n_cycles + 10)
    for ls, lb in zip(sm.gather(st), sb):
        assert torch.equal(ls, lb)


def _freeze_program():
    """``tests/test_sharded.py::test_sharded_freeze_on_nonzero_device_8dev``'s
    circuit: 16 stimuli whose FINISH cycles spread over all 8 shards."""
    stops = [5 + 4 * i for i in range(16)]
    c = Circuit("freeze")
    planes = Planes(c, len(stops), live=True)
    ctr = make_counter(c, 16)
    stop = planes.hold(stops, 16, "stopc")
    acc = planes.reg(32, [0x1000 * (i + 1) for i in range(len(stops))],
                     "acc")
    c.set_next(acc, acc + (acc >> 3) + 1)
    c.finish_when(ctr.eq(stop), FINISH)
    prog = compile_circuit(c, HW)
    images = [prog.init_images(r, m)
              for r, m in zip(planes.regs, planes.mems)]
    return prog, images, stops


def test_sharded_freeze_on_a_later_shard():
    """Each element, the ones on shards past the first included, freezes
    at its own raising Vcycle, equal to the seed arm on that stimulus;
    the shards keep running until every element froze."""
    prog, images, stops = _freeze_program()
    sm = ShardedBatchedMachine(prog, images=images, devices=CPU8, chunk=8)
    st = sm.run(sm.init_state(), 100)
    seed = Machine(prog, device="cpu", specialize=False)
    for i, s in enumerate(stops):
        assert sm.perf(st, i)["vcycles"] == s + 1
        assert set(sm.exceptions(st, i).values()) == {FINISH}
        s1 = seed.run(seed.init_state(images[i]), 100)
        el = sm.element(st, i)
        assert torch.equal(el.regs, s1.regs)
        assert torch.equal(el.flags, s1.flags)
        assert torch.equal(el.counters, s1.counters)
    # element 15 lives on shard 7
    assert divmod(15, sm.Bl) == (7, 1)


@pytest.mark.parametrize("n_seeds", [3, 4])
def test_pipelined_program_over_two_shards(n_seeds):
    """bc/full on 5x5 is modulo-pipelined: each shard's elements carry the
    prologue of their own images (B=3: the padding a copy of element 0's)
    and run the gated tail; B over 2 shards equals the batched engine and
    FINISHes at the bench's cycle."""
    b = build("bc", "full", seeds=range(1, n_seeds + 1))
    prog = compile_circuit(b.circuit, HW)
    assert prog.pipe_prologue > 0
    images = b.images_batch(prog)
    sm = ShardedBatchedMachine(prog, images=images, devices=["cpu"] * 2)
    assert (sm.Bp, sm.Bl) == (4, 2)
    if n_seeds == 3:
        assert torch.equal(sm.sreg0[1][1], sm.sreg0[0][0])   # the padding
        assert sm._cyc0[1].tolist() == [0, PAD_FROZEN_CYC]
    st = sm.run(sm.init_state(), b.n_cycles + 10)
    bm = BatchedMachine(prog, images=images, device="cpu")
    sb = bm.run(bm.init_state(), b.n_cycles + 10)
    for ls, lb in zip(sm.gather(st), sb):
        assert torch.equal(ls[:n_seeds], lb)
    assert [sm.perf(st, i)["vcycles"] for i in range(n_seeds)] == \
        [b.n_cycles] * n_seeds
    assert all(set(x.values()) == {FINISH} for x in sm.exceptions(st))


def test_rebind_repads_the_new_images():
    """``rebind`` (the serving layer's hot engine) re-pads and re-splits:
    after it the engine equals a fresh one on the new stimuli."""
    a = build("mc", "small", seeds=[1, 2, 3, 4, 5])
    b = build("mc", "small", seeds=[6, 7, 8, 9, 10])
    prog = compile_circuit(a.circuit, HW)
    eng = ShardedBatchedEngine(prog, images=a.images_batch(prog),
                               devices=["cpu"] * 4)
    eng.run_batch(a.n_cycles + 10)
    eng.rebind(b.images_batch(prog))
    assert (eng.m.B, eng.m.Bp) == (5, 8)
    got = eng.run_batch(b.n_cycles + 10)
    fresh = BatchedEngine(prog, images=b.images_batch(prog), device="cpu")
    assert got == fresh.run_batch(b.n_cycles + 10)
    two = build("mc", "small", seeds=[1, 2]).images_batch(prog)
    with pytest.raises(ValueError, match="batch size changed"):
        eng.rebind(two)


def test_facade_auto_selection_with_device_lists():
    """``tests/test_sharded.py::test_facade_auto_selection_8dev`` with a
    list of 8 CPU devices: B=16 >= 2*D picks ``sharded``; ``shard_batch=
    False`` and B=4 stay on ``batched``; the results agree."""
    seeds = [100 + i for i in range(16)]
    s = tsim.compile("mc", HW, scale="small", seeds=seeds, device="cpu")
    e = s.engine("auto", devices=CPU8)
    assert isinstance(e, ShardedBatchedEngine) and e.m.D == 8
    res = s.run(devices=CPU8)
    assert len(res) == 16 and all(r.finished for r in res)

    eb = s.engine("auto", devices=CPU8, shard_batch=False)
    assert type(eb) is BatchedEngine
    resb = eb.run_batch(s.default_cycles())
    assert [r.registers for r in resb] == [r.registers for r in res]
    assert [r.exceptions for r in resb] == [r.exceptions for r in res]

    s4 = tsim.compile("mc", HW, scale="small", seeds=seeds[:4],
                      device="cpu")
    assert type(s4.engine("auto", devices=CPU8)) is BatchedEngine
    # no devices= on the CPU: one device, so auto stays batched, and an
    # explicit ``sharded`` runs one shard
    assert type(s.engine("auto")) is BatchedEngine
    one = s.engine("sharded")
    assert one.m.devices == [torch.device("cpu")]
    assert one.run_batch(s.default_cycles()) == res
