"""The port's core-sharded engine (``core.grid.GridMachine``, facade kind
``grid``) against the reference's, on the CPU.

Mirrors ``tests/test_multidevice.py::test_grid_machine_8dev_matches_oracle``
and ``tests/test_batched.py::test_batched_grid_machine_8dev``: the
reference runs with 8 forced host devices in a subprocess and saves its
final state as ``.npz``; the port runs the same Program on ``mesh=["cpu"]
* 8``, eight shards in one process, exchanging SEND values between them
every Vcycle. Every comparison is exact.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.circuits import build as jbuild
from repro.core import grid as jgrid
from repro.core.compile import compile_circuit as jcompile
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as tsim
from repro_torch.circuits import FINISH, build
from repro_torch.circuits.common import Planes, make_counter
from repro_torch.core import grid
from repro_torch.core.bsp import BatchedMachine, Machine
from repro_torch.core.compile import compile_circuit
from repro_torch.core.interpreter import NetlistSim
from repro_torch.core.isa import HardwareConfig
from repro_torch.core.netlist import Circuit

ROOT = Path(__file__).resolve().parents[1]
HW4 = dict(grid_width=4, grid_height=4)
HW5 = dict(grid_width=5, grid_height=5)
LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")
# (circuit, scale, grid): rv32r is the reference tests' grid program, bc
# on 5x5 is modulo-pipelined
EXCHANGE_CASES = {"mc": ("small", HW5), "bc": ("full", HW5),
                  "rv32r": ("small", HW4)}
SEEDS = [5, 6, 7]


def run_8dev(body: str) -> str:
    """``body`` in a subprocess with 8 forced host devices (the pattern of
    ``tests/test_multidevice.py::run_subprocess``)."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(EXCHANGE_CASES))
def test_build_exchange_matches_reference(name, D):
    """The copied ``_build_exchange`` gives the reference's tables, byte for
    byte, on each package's own compilation of the circuit."""
    assert inspect.getsource(grid._build_exchange) == \
        inspect.getsource(jgrid._build_exchange)
    scale, hw = EXCHANGE_CASES[name]
    jp = jcompile(jbuild(name, scale).circuit, JHW(**hw))
    tp = compile_circuit(build(name, scale).circuit, HardwareConfig(**hw))
    cl = max(1, -(-tp.used_cores // D))
    got = grid._build_exchange(tp, D, cl, cl * D)
    want = jgrid._build_exchange(jp, D, cl, cl * D)
    for g, w in zip(got[:5], want[:5]):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[5] == want[5]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX ``GridMachine`` on 8 devices, rv32r/small on 4x4, unbatched
    and on seeds [5, 6, 7]: its final state and accessors."""
    out = tmp_path_factory.mktemp("grid") / "ref.npz"
    run_8dev(f"""
        import json
        import numpy as np, jax
        from jax.sharding import Mesh
        from repro.circuits import build
        from repro.core.isa import HardwareConfig
        from repro.core.compile import compile_circuit
        from repro.core.grid import GridMachine

        assert len(jax.devices()) == 8
        mesh = Mesh(np.array(jax.devices()), ("cores",))
        arrays = {{}}
        for tag, seeds in (("unbatched", None), ("batched", {SEEDS!r})):
            b = build("rv32r", "small", seeds=seeds)
            prog = compile_circuit(b.circuit, HardwareConfig(**{HW4!r}))
            gm = GridMachine(prog, mesh, images=b.images(prog) if seeds
                             else None)
            st = gm.run(gm.init_state(), b.n_cycles + 10)
            for k, leaf in zip({LEAVES!r}, st):
                arrays[tag + "/" + k] = np.asarray(leaf)
            elems = [None] if seeds is None else range(len(seeds))
            acc = {{
                "perf": [gm.perf(st, i) for i in elems],
                "exceptions": [{{str(c): e for c, e in
                                 gm.exceptions(st, i).items()}}
                               for i in elems],
                "regs": [{{n: gm.read_reg(st, n, i)
                           for n in prog.state_regs}} for i in elems],
                "outputs": [{{n: gm.read_output(st, n, i)
                              for n in prog.outputs}} for i in elems]}}
            if seeds:
                acc["perf_all"] = gm.perf(st)
            arrays[tag + "/accessors"] = np.array(json.dumps(acc))
        np.savez("{out}", **arrays)
    """)
    return dict(np.load(out))


@pytest.mark.parametrize("batched", [False, True])
def test_grid_matches_reference_8dev(reference, batched):
    """rv32r/small on 4x4 over 8 shards of 2 cores: every state leaf
    (the reference's layout: ``regs [(B,) Cp, R]``, per-shard ``gmem``,
    tags and counters), ``perf``, ``exceptions`` and every probe equal the
    reference's, with SENDs that cross shards."""
    tag = "batched" if batched else "unbatched"
    seeds = SEEDS if batched else None
    b = build("rv32r", "small", seeds=seeds)
    prog = compile_circuit(b.circuit, HardwareConfig(**HW4))
    gm = grid.GridMachine(prog, ["cpu"] * 8,
                          images=b.images(prog) if batched else None)
    cross = (prog.xchg_src_core // gm.cl) != (prog.xchg_dst_core // gm.cl)
    assert cross.any(), "rv32r must exercise cross-shard SENDs"
    assert sum(gm.n_box) >= 1
    st = gm.run(gm.init_state(), b.n_cycles + 10)
    h = gm.gather(st)
    for k, leaf in zip(LEAVES, h):
        want = reference[f"{tag}/{k}"]
        assert leaf.shape == want.shape, k
        np.testing.assert_array_equal(leaf, want, err_msg=k)
    acc = json.loads(str(reference[f"{tag}/accessors"]))
    elems = range(len(SEEDS)) if batched else [None]
    assert [gm.perf(st, i) for i in elems] == acc["perf"]
    assert [{str(c): e for c, e in gm.exceptions(st, i).items()}
            for i in elems] == acc["exceptions"]
    assert [{n: gm.read_reg(st, n, i) for n in prog.state_regs}
            for i in elems] == acc["regs"]
    assert [{n: gm.read_output(st, n, i) for n in prog.outputs}
            for i in elems] == acc["outputs"]
    for p in acc["perf"]:
        assert p["vcycles"] == b.n_cycles
    for e in acc["exceptions"]:
        assert set(e.values()) == {FINISH}
    if batched:
        assert gm.perf(st) == acc["perf_all"]
        assert len(gm.exceptions(st)) == len(SEEDS)


def test_pipelined_program_on_four_shards_matches_netlist():
    """bc/full on 5x5 (a 20-slot prologue) runs unrotated on the grid, as
    the reference's does: at D=4 it FINISHes at cycle 66 with every state
    register equal to the netlist interpreter's, and equals ``Machine``,
    which rotates the prologue."""
    b = build("bc", "full")
    prog = compile_circuit(b.circuit, HardwareConfig(**HW5))
    assert prog.pipe_prologue == 20
    gm = grid.GridMachine(prog, ["cpu"] * 4)
    st = gm.run(gm.init_state(), b.n_cycles + 10)
    assert b.n_cycles == 66
    assert gm.perf(st)["vcycles"] == 66
    assert set(gm.exceptions(st).values()) == {FINISH}
    ref = NetlistSim(b.circuit)
    ref.run(b.n_cycles + 10)
    assert len(prog.state_regs) == 37
    for name in prog.state_regs:
        assert gm.read_reg(st, name) == ref.reg_value(name), name
    m = Machine(prog, device="cpu")
    sm = m.run(m.init_state(), b.n_cycles + 10)
    assert gm.exceptions(st) == m.exceptions(sm)
    assert gm.perf(st) == m.perf(sm)


def _freeze_program():
    """16 stimuli of one Program whose FINISH cycles are 5, 9, ..., 65
    (``tests/test_sharded.py``'s freeze circuit)."""
    stops = [5 + 4 * i for i in range(16)]
    c = Circuit("freeze")
    planes = Planes(c, len(stops), live=True)
    ctr = make_counter(c, 16)
    stop = planes.hold(stops, 16, "stopc")
    acc = planes.reg(32, [0x1000 * (i + 1) for i in range(len(stops))],
                     "acc")
    c.set_next(acc, acc + (acc >> 3) + 1)
    c.finish_when(ctr.eq(stop), FINISH)
    prog = compile_circuit(c, HardwareConfig(**HW5))
    images = [prog.init_images(r, m)
              for r, m in zip(planes.regs, planes.mems)]
    return prog, images, stops


def test_batched_grid_freezes_per_element_across_runs():
    """The global gate is per element: each stimulus stops at its own
    FINISH on every shard while the others run on, and a run split in two
    calls (the cycle budget restarting at each) equals ``BatchedMachine``
    split the same way."""
    prog, images, stops = _freeze_program()
    gm = grid.GridMachine(prog, ["cpu"] * 4, images=images, chunk=8)
    bm = BatchedMachine(prog, images=images, device="cpu", chunk=8)
    st, sb = gm.init_state(), bm.init_state()
    for n in (20, 100):
        st, sb = gm.run(st, n), bm.run(sb, n)
        h = gm.gather(st)
        C = prog.used_cores
        np.testing.assert_array_equal(h.regs[:, :C],
                                      sb.regs.numpy().view(np.uint32))
        np.testing.assert_array_equal(h.flags[:, :C],
                                      sb.flags.numpy().view(np.uint32))
        assert [gm.perf(st, i) for i in range(16)] == \
            [bm.perf(sb, i) for i in range(16)]
    assert [gm.perf(st, i)["vcycles"] for i in range(16)] == \
        [s + 1 for s in stops]


def test_grid_through_the_facade():
    """``run(engine="grid", mesh=[...])`` gives the single-stimulus
    engine's result; a batched Simulation gives one per seed; ``grid``
    without a mesh raises."""
    s = tsim.compile("rv32r", HardwareConfig(**HW4), scale="small",
                     device="cpu")
    want = s.run(engine="machine")
    assert s.run(engine="grid", mesh=["cpu"] * 8) == want
    assert s.select_engine_kind(mesh=["cpu"] * 8) == "grid"
    with pytest.raises(ValueError, match="mesh"):
        s.engine("grid")
    sb = tsim.compile("rv32r", HardwareConfig(**HW4), scale="small",
                      seeds=SEEDS, device="cpu")
    got = sb.run(mesh=["cpu"] * 3)
    assert got == sb.run(engine="batched")
    assert len(got) == 3 and all(r.finished for r in got)
