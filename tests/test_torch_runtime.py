"""The port's ``runtime.elastic`` (the RTL side) against the reference's:
a running simulation migrates between two compilations of one circuit by
RTL register and memory name, and finishes exactly where an uninterrupted
run does. The state carries across packages too: a dict extracted from a
JAX run is injected into the port's machine."""
import numpy as np
import pytest

from repro.circuits import build as jbuild
from repro.core.bsp import Machine as JMachine
from repro.core.compile import compile_circuit as jcompile
from repro.core.isa import HardwareConfig as JHW
from repro.core.netlist import Circuit as JCircuit
from repro.runtime import elastic as jelastic

from repro_torch.circuits import FINISH, build
from repro_torch.core.bsp import Machine, from_words
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.core.netlist import Circuit
from repro_torch.runtime import elastic


def test_rtl_elastic_migration():
    """``tests/test_runtime.py::test_rtl_elastic_migration`` on the port:
    re-scale a running simulation from a 3x3 grid to a 5x5 grid; the
    migrated machine continues and finishes at the exact same cycle with
    the same architectural state."""
    b = build("mc", "small")
    hw_a = HardwareConfig(grid_width=3, grid_height=3)
    hw_b = HardwareConfig(grid_width=5, grid_height=5)
    prog_a = compile_circuit(b.circuit, hw_a)
    prog_b = compile_circuit(b.circuit, hw_b)
    ma = Machine(prog_a, device="cpu")
    half = b.n_cycles // 2
    st_a = ma.run(ma.init_state(), half)
    assert ma.perf(st_a)["vcycles"] == half

    mb = Machine(prog_b, device="cpu")
    st_b = elastic.migrate(prog_a, st_a, prog_b, mb)
    st_b = mb.run(st_b, b.n_cycles)
    # continues to the exact finish cycle
    total = int(from_words(st_b.counters)[0]) + half
    assert total == b.n_cycles
    assert set(mb.exceptions(st_b).values()) == {FINISH}

    # reference: uninterrupted run on grid B
    ref = Machine(prog_b, device="cpu")
    st_r = ref.run(ref.init_state(), b.n_cycles + 10)
    for name in prog_b.state_regs:
        assert mb.read_reg(st_b, name) == ref.read_reg(st_r, name), name


def _memory_circuit(pkg_circuit, is_global: bool):
    """A counter walking a memory (scratchpad or global), reading,
    accumulating and writing back: state lives in memories too."""
    c = pkg_circuit("spadmem" if not is_global else "gmem")
    m = c.mem("big", 1 << 8 if not is_global else 1 << 12, 16,
              is_global=is_global)
    ctr = c.reg(16, init=0, name="ctr")
    c.set_next(ctr, ctr + 1)
    rd = c.mem_read(m, ctr)
    acc = c.reg(16, init=3, name="acc")
    c.set_next(acc, acc + rd + ctr)
    c.mem_write(m, ctr + 1, acc, c.const(1, 1))
    c.finish_when(ctr.eq(40), eid=FINISH)
    return c, 41          # the 41st Vcycle sees ctr == 40 and raises


def _case(name):
    """(reference circuit, port circuit, finish cycle, grid A, grid B)."""
    if name in ("spad", "global"):
        jc, n = _memory_circuit(JCircuit, name == "global")
        tc, _ = _memory_circuit(Circuit, name == "global")
        return jc, tc, n, 1, 2
    circ, scale, ga, gb = {"mc": ("mc", "small", 3, 5),
                           "rv32r": ("rv32r", "small", 3, 5),
                           "bc": ("bc", "full", 5, 15)}[name]
    jb, tb = jbuild(circ, scale), build(circ, scale)
    return jb.circuit, tb.circuit, jb.n_cycles, ga, gb


def _hw(pkg, g):
    return pkg(grid_width=g, grid_height=g)


def _same_state_dict(a, b):
    assert a["__regs__"] == b["__regs__"]
    assert a["__mems__"].keys() == b["__mems__"].keys()
    for k in a["__mems__"]:
        assert a["__mems__"][k].dtype == b["__mems__"][k].dtype, k
        assert np.array_equal(a["__mems__"][k], b["__mems__"][k]), k
    assert a["__counters__"].dtype == b["__counters__"].dtype
    assert np.array_equal(a["__counters__"], b["__counters__"])


# bc/full is modulo-pipelined on both grids (a 20-slot prologue): the
# prologue's hoisted values must come from the carried state, not from the
# base image.
@pytest.mark.parametrize("name", ["mc", "rv32r", "bc", "spad", "global"])
def test_state_crosses_packages(name):
    """At the same half-way cycle the port's ``extract_state`` equals the
    reference's. The reference's dict injected into the port's machine on
    the new grid gives, word for word, the reference's injected state
    started again from its own images (which runs a pipelined Program's
    prologue on the carried state); the run from there finishes at the
    bench's cycle with the reference's registers, memories, exceptions
    and count, and with an uninterrupted run's registers."""
    jc, tc, n, ga, gb = _case(name)
    jpa, jpb = jcompile(jc, _hw(JHW, ga)), jcompile(jc, _hw(JHW, gb))
    tpa = compile_circuit(tc, _hw(HardwareConfig, ga))
    tpb = compile_circuit(tc, _hw(HardwareConfig, gb))
    if name == "bc":
        assert tpa.pipe_prologue and tpb.pipe_prologue
    if name in ("spad", "global"):
        assert tpb.stats["mem_layout"]["big"][3] == (name == "global")
    half = n // 2

    jma = JMachine(jpa)
    jsa = jma.run(jma.init_state(), half)
    tma = Machine(tpa, device="cpu")
    tsa = tma.run(tma.init_state(), half)
    saved = jelastic.extract_state(jpa, jsa)
    _same_state_dict(elastic.extract_state(tpa, tsa), saved)
    assert int(saved["__counters__"][0]) == half

    jmb = JMachine(jpb)
    jinj = jelastic.inject_state(jpb, jmb, saved)
    jsb = jmb.init_state(images=tuple(
        np.asarray(getattr(jinj, leaf)) for leaf in ("regs", "spads",
                                                     "gmem")))
    tmb = Machine(tpb, device="cpu")
    tsb = elastic.inject_state(tpb, tmb, saved)
    for leaf in ("regs", "spads", "gmem", "flags", "counters"):
        assert np.array_equal(from_words(getattr(tsb, leaf)),
                              np.asarray(getattr(jsb, leaf))), leaf

    jsb = jmb.run(jsb, n)
    tsb = tmb.run(tsb, n)
    assert np.array_equal(from_words(tsb.counters),
                          np.asarray(jsb.counters))
    assert tmb.exceptions(tsb) == jmb.exceptions(jsb)
    assert int(from_words(tsb.counters)[0]) + half == n
    assert set(tmb.exceptions(tsb).values()) == {FINISH}
    jsr = jmb.run(jmb.init_state(), n + 10)          # uninterrupted
    for reg in tpb.state_regs:
        assert tmb.read_reg(tsb, reg) == jmb.read_reg(jsb, reg) == \
            jmb.read_reg(jsr, reg), reg
    _same_state_dict(elastic.extract_state(tpb, tsb),
                     jelastic.extract_state(jpb, jsb))
