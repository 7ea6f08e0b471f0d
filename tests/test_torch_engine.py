"""The port's ``Machine``/``BatchedMachine`` against the reference's.

Both packages run the same compiled Program (the reference compiles it; it
reaches the port through ``repro_torch.convert``) and must end in the same
state bit for bit: registers, scratchpads, flags and counters. The port
runs on the CPU here, i.e. through the chunk kernel's plain version.
"""
import numpy as np
import pytest
import torch

from repro.circuits import CIRCUITS, FINISH, build
from repro.circuits.common import Planes, make_counter
from repro.core import bsp as jbsp
from repro.core.compile import compile_circuit
from repro.core.isa import HardwareConfig
from repro.core.isasim import IsaSim
from repro.core.netlist import Circuit

from repro_torch.convert import (program_from_arrays, program_to_arrays,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core import bsp as tbsp

HW = HardwareConfig(grid_width=5, grid_height=5)
NAMES = sorted(CIRCUITS)
SEEDS = [3, 11, 42]
LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")


def port(prog):
    return program_from_arrays(program_to_arrays(prog))


def assert_same_state(jstate, tstate):
    for name, a, b in zip(LEAVES, jstate, state_to_numpy(tstate)):
        a = np.asarray(a)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def small():
    out = {}
    for nm in NAMES:
        b = build(nm, "small")
        out[nm] = (b, compile_circuit(b.circuit, HW))
    return out


@pytest.fixture(scope="module")
def bc_full():
    b = build("bc", "full")
    prog = compile_circuit(b.circuit, HW)
    assert prog.pipe_prologue > 0
    return b, prog


@pytest.mark.parametrize("name", NAMES)
def test_machine_matches_reference(name, small):
    b, prog = small[name]
    jm = jbsp.Machine(prog)
    js = jm.run(jm.init_state(), b.n_cycles + 10)
    tm = tbsp.Machine(port(prog), device="cpu")
    ts = tm.run(tm.init_state(), b.n_cycles + 10)
    assert_same_state(js, ts)
    assert tm.perf(ts) == jm.perf(js)
    assert tm.perf(ts)["vcycles"] == b.n_cycles
    assert set(tm.exceptions(ts).values()) == {FINISH}
    for rname in prog.state_regs:
        assert tm.read_reg(ts, rname) == jm.read_reg(js, rname), rname


@pytest.mark.parametrize("chunk", [8, jbsp.DEFAULT_CHUNK])
def test_exception_freezes_within_chunk(chunk, small):
    """mm raises FINISH mid-chunk at both chunk sizes; the machine stops
    exactly there with the reference's frozen state."""
    b, prog = small["mm"]
    assert b.n_cycles % chunk != 0
    jm = jbsp.Machine(prog, chunk=chunk)
    js = jm.run(jm.init_state(), 1000)
    tm = tbsp.Machine(port(prog), device="cpu", chunk=chunk)
    ts = tm.run(tm.init_state(), 1000)
    assert tm.perf(ts)["vcycles"] == b.n_cycles
    assert_same_state(js, ts)


def test_pipelined_prologue_mid_chunk_freeze(bc_full):
    """bc/full ships a retimed prologue: iteration 0's prologue at init,
    the gated tail every Vcycle, and no in-flight prologue committed by
    the raising Vcycle (chunk 8 puts FINISH mid-chunk). The reference's
    rotated numpy ISA simulator applies the same gate independently."""
    b, prog = bc_full
    assert b.n_cycles % 8 != 0
    s = IsaSim(prog)                       # runs iteration 0's prologue
    tm = tbsp.Machine(port(prog), device="cpu", chunk=8)
    ts = tm.init_state()
    np.testing.assert_array_equal(state_to_numpy(ts)[0], s.regs)
    ts = tm.run(ts, 1000)
    assert s.run(b.n_cycles + 10) == b.n_cycles
    assert tm.perf(ts)["vcycles"] == b.n_cycles
    assert tm.exceptions(ts) == s.exceptions()
    assert set(s.exceptions().values()) == {FINISH}
    regs, spads, _, flags, _, _ = state_to_numpy(ts)
    np.testing.assert_array_equal(regs, s.regs)
    np.testing.assert_array_equal(spads, s.spads)
    np.testing.assert_array_equal(flags, s.flags)


def test_run_continues_from_a_carried_reference_state(small):
    """The same state fed to both packages: the reference runs 10 Vcycles,
    its state crosses over, and both finish from there identically."""
    b, prog = small["noc"]
    jm = jbsp.Machine(prog)
    js = jm.run(jm.init_state(), 10)
    tm = tbsp.Machine(port(prog), device="cpu")
    ts = state_from_numpy([np.asarray(x) for x in js], device="cpu")
    assert_same_state(js, ts)
    assert_same_state(jm.run(js, 1000), tm.run(ts, 1000))


@pytest.fixture(scope="module")
def bc_batch():
    """bc/full at three seeds through both packages' batched engines."""
    b = build("bc", "full", seeds=SEEDS)
    prog = compile_circuit(b.circuit, HW)
    images = b.images(prog)
    jm = jbsp.BatchedMachine(prog, images=images)
    js = jm.run(jm.init_state(), b.n_cycles + 10)
    tm = tbsp.BatchedMachine(port(prog), images=images, device="cpu")
    ts = tm.run(tm.init_state(), b.n_cycles + 10)
    return b, prog, images, (jm, js), (tm, ts)


def test_batched_matches_reference(bc_batch):
    b, prog, images, (jm, js), (tm, ts) = bc_batch
    assert_same_state(js, ts)
    assert tm.perf(ts) == jm.perf(js)
    for i in range(len(SEEDS)):
        assert tm.exceptions(ts, i) == jm.exceptions(js, i)
        assert tm.perf(ts, i) == jm.perf(js, i)
        assert tm.read_reg(ts, "ctr", i) == jm.read_reg(js, "ctr", i)


def test_stacked_images_and_rebind(bc_batch):
    """The stacked image form loads the same batch, and ``rebind_images``
    swaps stimuli at a fixed B: reversed images give the reversed batch."""
    b, prog, images, (jm, js), (tm, ts) = bc_batch
    sm = tbsp.BatchedMachine(port(prog), images=b.images_batch(prog),
                             device="cpu")
    st = sm.run(sm.init_state(), b.n_cycles + 10)
    assert_same_state(js, st)
    sm.rebind_images(images[::-1])
    st = sm.run(sm.init_state(), b.n_cycles + 10)
    assert_same_state([np.asarray(x)[::-1] for x in js], st)
    with pytest.raises(ValueError, match="batch size changed"):
        sm.rebind_images(images[:2])


def _freeze_bench(stops):
    """FINISH at a per-stimulus cycle (held in the init plane), so batch
    elements freeze at different Vcycles (test_batched.py's circuit)."""
    c = Circuit("freeze")
    planes = Planes(c, len(stops), live=True)
    ctr = make_counter(c, 16)
    stop = planes.hold(stops, 16, "stopc")
    acc = planes.reg(32, [0x1000 * (i + 1) for i in range(len(stops))],
                     "acc")
    c.set_next(acc, acc + (acc >> 3) + 1)
    c.finish_when(ctr.eq(stop), FINISH)
    return c, planes


def test_batched_exception_freeze_per_element():
    stops = [5, 17, 29]
    c, planes = _freeze_bench(stops)
    prog = compile_circuit(c, HW)
    images = [prog.init_images(r, m)
              for r, m in zip(planes.regs, planes.mems)]
    jm = jbsp.BatchedMachine(prog, images=images, chunk=8)
    js = jm.run(jm.init_state(), 100)
    tm = tbsp.BatchedMachine(port(prog), images=images, device="cpu",
                             chunk=8)
    ts = tm.run(tm.init_state(), 100)
    assert_same_state(js, ts)
    for i, stop in enumerate(stops):
        assert set(tm.exceptions(ts, i).values()) == {FINISH}
        assert tm.perf(ts, i)["vcycles"] == stop + 1


def test_entry_points_run_on_the_card_unless_asked(small):
    """No ``device`` means the card; without one the constructor raises
    rather than falling back to the CPU."""
    _, prog = small["mc"]
    if torch.cuda.is_available():
        assert tbsp.Machine(port(prog)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbsp.Machine(port(prog))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbsp.BatchedMachine(port(prog), batch=2)

