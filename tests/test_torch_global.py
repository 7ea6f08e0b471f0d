"""Global memory (GLD/GST) and the privileged core's cache/stall model in
the port, against the reference.

The Fig 8 microbenchmarks (``circuits/fig8.py``) compile once through the
reference package and reach the port through ``repro_torch.convert``; every
port engine (the chunk kernel single and batched, and the seed arm) must
end with the reference jnp engine's global memory, registers and
``perf()`` counters, bit for bit. On the CPU the engines run their
kernels' plain versions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.circuits import FINISH
from repro.circuits.fig8 import build_membench
from repro.core import bsp as jbsp
from repro.core.compile import compile_circuit
from repro.core.isa import HardwareConfig, Op
from repro.core.netlist import Circuit

from repro_torch.circuits.fig8 import build_membench as t_build_membench
from repro_torch.convert import (program_from_arrays, program_to_arrays,
                                 state_to_numpy)
from repro_torch.core import bsp as tbsp
from repro_torch.kernels.randprog import random_vcycle
from repro_torch.kernels.ref import CacheModel, global_core, vcycle_seed_ref

# the Fig 8 benchmark's machine (benchmarks/fig8_global_stall.py)
FIG8_HW = HardwareConfig(grid_width=1, grid_height=1, spad_words=1 << 14,
                         num_regs=4096, imem_slots=1 << 16)
HW = HardwareConfig(grid_width=5, grid_height=5)
N_CYCLES = 128
SEEDS = [0, 5, 9]
LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")
# the reference jnp Machine's counters at n_cycles=128 (FINISH at 129)
COUNTS = {("fifo", 1): (0, 0, 0), ("ram", 1): (0, 0, 0),
          ("fifo", 64): (253, 5, 4142), ("fifo", 512): (253, 5, 4142),
          ("ram", 64): (138, 120, 16332), ("ram", 512): (129, 129, 17286)}
GLOBAL = [k for k, v in COUNTS.items() if v != (0, 0, 0)]


def key_id(key):
    return f"{key[0]}-{key[1]}k"


def port(prog):
    return program_from_arrays(program_to_arrays(prog))


def assert_same_state(jstate, tstate, what=""):
    for name, a, b in zip(LEAVES, jstate, state_to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{what} {name}")


def counts(perf):
    return perf["ghits"], perf["gmisses"], perf["stall_cycles"]


@pytest.fixture(scope="module")
def fig8():
    """Each config compiled once (unseeded and at three seeds), with the
    reference's jnp runs."""
    out = {}
    for key in COUNTS:
        b = build_membench(*key, n_cycles=N_CYCLES)
        prog = compile_circuit(b.circuit, FIG8_HW)
        jm = jbsp.Machine(prog)
        js = jm.run(jm.init_state(), b.n_cycles + 10)
        bb = build_membench(*key, n_cycles=N_CYCLES, seeds=SEEDS)
        bprog = compile_circuit(bb.circuit, FIG8_HW)
        images = bb.images(bprog)
        jb = jbsp.BatchedMachine(bprog, images=images)
        jbs = jb.run(jb.init_state(), bb.n_cycles + 10)
        out[key] = (b, prog, (jm, js), bprog, images, (jb, jbs))
    return out


def test_fig8_circuit_copy_compiles_the_same_program():
    """The port's copy of ``circuits/fig8.py`` builds the same circuit."""
    for key in (("ram", 512), ("fifo", 64)):
        a = build_membench(*key, n_cycles=16).circuit.fingerprint()
        b = t_build_membench(*key, n_cycles=16).circuit.fingerprint()
        assert a == b


@pytest.mark.parametrize("key", sorted(COUNTS), ids=key_id)
def test_fig8_counters(key, fig8):
    """The port's engine reproduces the reference's Fig 8 counts exactly:
    FINISH at Vcycle 129, and the cache hits, misses and stall cycles of
    the model (the 1 KiB memories live in the scratchpad: no access)."""
    b, prog, (jm, js), *_ = fig8[key]
    assert prog.has_global == (key in GLOBAL)
    tm = tbsp.Machine(port(prog), device="cpu")
    ts = tm.run(tm.init_state(), b.n_cycles + 10)
    assert jm.perf(js) == tm.perf(ts)
    assert tm.perf(ts)["vcycles"] == N_CYCLES + 1
    assert set(tm.exceptions(ts).values()) == {FINISH}
    assert counts(tm.perf(ts)) == COUNTS[key]


@pytest.mark.parametrize("engine", ["machine", "seed", "batched"])
@pytest.mark.parametrize("key", sorted(GLOBAL), ids=key_id)
def test_fig8_engines_match_reference(key, engine, fig8):
    """gmem, registers, cache tags and counters of every port engine equal
    the reference jnp engine's: single stimulus for ``machine`` and
    ``seed``, three seeds at once for ``batched``."""
    b, prog, (jm, js), bprog, images, (jb, jbs) = fig8[key]
    n = b.n_cycles + 10
    if engine == "batched":
        tm = tbsp.BatchedMachine(port(bprog), images=images, device="cpu")
        ts = tm.run(tm.init_state(), n)
        assert_same_state(jbs, ts, engine)
        assert tm.perf(ts) == jb.perf(jbs)
        for i in range(len(SEEDS)):
            assert tm.perf(ts, i) == jb.perf(jbs, i)
        return
    tm = tbsp.Machine(port(prog), device="cpu",
                      specialize=engine == "machine")
    ts = tm.run(tm.init_state(), n)
    assert_same_state(js, ts, engine)
    assert tm.perf(ts) == jm.perf(js)
    assert counts(tm.perf(ts)) == COUNTS[key]


def _stall_program():
    """``tests/test_circuits.py::test_global_stall_counters``'s circuit."""
    c = Circuit("gmem")
    m = c.mem("big", 1 << 12, 16, is_global=True)
    ctr = c.reg(16, init=0, name="ctr")
    c.set_next(ctr, ctr + 1)
    rd = c.mem_read(m, ctr)
    acc = c.reg(16, init=0, name="acc")
    c.set_next(acc, acc + rd)
    c.mem_write(m, ctr, acc, c.const(1, 1))
    c.finish_when(ctr.eq(64), eid=FINISH)
    return compile_circuit(c, HW)


@pytest.mark.parametrize("engine", ["machine", "seed", "batched"])
def test_global_stall_circuit_matches_reference(engine):
    prog = _stall_program()
    assert prog.has_global and prog.used_cores > 1
    jm = jbsp.Machine(prog)
    js = jm.run(jm.init_state(), 100)
    p = port(prog)
    if engine == "batched":
        tm = tbsp.BatchedMachine(p, batch=2, device="cpu")
        ts = tm.run(tm.init_state(), 100)
        for i in range(2):
            assert_same_state(js, tm.element(ts, i), engine)
    else:
        tm = tbsp.Machine(p, device="cpu", specialize=engine == "machine")
        ts = tm.run(tm.init_state(), 100)
        assert_same_state(js, ts, engine)
        perf = tm.perf(ts)
        assert perf == jm.perf(js)
        assert perf["stall_cycles"] > 0
        assert perf["machine_cycles"] > perf["vcycles"] * prog.vcpl


@pytest.mark.parametrize("C,gcore", [(1, 0), (5, 2)])
def test_seed_plain_global_matches_reference_slot_step(C, gcore):
    """Random programs with GLD/GST on one core over a small global memory
    (its cache both hits and misses) through the reference's unspecialized
    slot step, ``make_slot_step(op_set=None)``, slot by slot. Words are
    16-bit, where the masked and unmasked register writes agree."""
    rng = np.random.default_rng(C)
    T, R, S, L, G, lines = 40, 12, 6, 4, 200, 8
    cache = CacheModel(4, 14, 120)
    arrays = [a.view(np.uint32) if a.dtype == np.int32 and k in (1, 2, 3, 5)
              else a for k, a in enumerate(random_vcycle(
                  rng, C, T, R, S, L, G, lines, gcore))]
    code, luts, regs, spads, flags, gmem, tags, counters = arrays
    luts, regs, spads, gmem = (a & 0xFFFF for a in (luts, regs, spads, gmem))
    assert global_core(code, C) == gcore
    step = jbsp.make_slot_step(jnp.asarray(luts), S, G, lines,
                               cache.line_words, cache.hit_stall,
                               cache.miss_stall, op_set=None)
    carry = (jnp.asarray(regs), jnp.asarray(spads), jnp.asarray(gmem),
             jnp.asarray(flags.view(np.uint32)), jnp.asarray(tags),
             jnp.asarray(counters.view(np.uint32)),
             jnp.zeros((C + 1,), jnp.uint32))
    trace = []
    for t in range(T):
        carry, _ = step(carry, (jnp.asarray(code[t]),
                                jnp.arange(C, dtype=jnp.int32)))
        trace.append(np.asarray(carry[6][:C]))
    t32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.uint32)
                                     .view(np.int32))
    out = vcycle_seed_ref(torch.from_numpy(code), t32(luts), t32(regs),
                          t32(spads), torch.from_numpy(flags), t32(gmem),
                          torch.from_numpy(tags), torch.from_numpy(counters),
                          cache)
    ref = (carry[0], carry[1], carry[3], np.stack(trace), carry[2],
           carry[4], carry[5])
    for name, a, b in zip(("regs", "spads", "flags", "trace", "gmem", "tags",
                           "counters"), ref, out):
        want = np.asarray(a)
        got = b.numpy().view(want.dtype) if want.dtype == np.uint32 \
            else b.numpy()
        np.testing.assert_array_equal(want, got, err_msg=name)
    assert int(np.asarray(carry[5])[1]) > int(counters[1])      # hits
    assert int(np.asarray(carry[5])[2]) > int(counters[2])      # misses


def test_global_ops_on_two_cores_are_refused():
    """The kernels model one cache access per slot, on the privileged core;
    a program with GLD/GST on two cores is refused where it is bound."""
    prog = port(_stall_program())
    code = prog.code.copy()
    C = prog.used_cores
    src = int(global_core(code.transpose(1, 0, 2), C))
    other = (src + 1) % C
    code[other, 0] = (int(Op.GLD), 1, 0, 0, 0, 0, 0)
    prog.code = code
    for spec in (True, False):
        with pytest.raises(ValueError, match="more than one core"):
            tbsp.Machine(prog, device="cpu", specialize=spec)
