"""The port's seed arm against the reference's.

``vcycle_seed_ref`` — the plain version of the seed kernel, and what its
wrapper runs on CPU tensors — is held bit for bit against the reference's
``_vcycle_kernel`` (``vcycle_pallas`` in interpret mode), on the reference's
own random programs and on 32-bit words, where its 16-bit masked register
write shows. ``Machine(specialize=False)`` is held against both of the
reference's seed arms (jnp and Pallas) and against the port's specialized
engine on compiled circuits. Everything is integer: the tolerance is 0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.circuits import CIRCUITS, FINISH, build
from repro.core import bsp as jbsp
from repro.core.compile import compile_circuit
from repro.core.isa import HardwareConfig
from repro.kernels.vcycle import vcycle_pallas
from test_kernels import random_program

from repro_torch.convert import (program_from_arrays, program_to_arrays,
                                 state_to_numpy)
from repro_torch.core import bsp as tbsp
from repro_torch.kernels import vcycle as kv
from repro_torch.kernels.ref import vcycle_ref, vcycle_seed_ref

HW = HardwareConfig(grid_width=5, grid_height=5)
NAMES = sorted(CIRCUITS)
LEAVES = ("regs", "spads", "gmem", "flags", "cache_tags", "counters")


def t32(a):
    """numpy words -> the port's int32 tensor of their bit patterns."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32))


def u32(t):
    return t.numpy().view(np.uint32)


def pad_cores(code, luts, Cp):
    """The port's table layout: cores padded to Cp with all-NOP lanes."""
    T, C, _ = code.shape
    cp = np.zeros((T, Cp, 7), np.int32)
    cp[:, :C] = code
    lp = np.zeros((Cp,) + luts.shape[1:], np.uint32)
    lp[:C] = luts
    return cp, lp


def check_seed(code, luts, regs, spads, flags, tile):
    """``vcycle_pallas`` against the plain version and the CPU wrapper, on
    the reference's layout and on tables padded to a warp multiple."""
    ref = vcycle_pallas(jnp.asarray(code), jnp.asarray(luts),
                        jnp.asarray(regs), jnp.asarray(spads),
                        jnp.asarray(flags), tile=tile, interpret=True)
    C = code.shape[1]
    padded = pad_cores(code, luts, ((C + 31) // 32) * 32)
    state = (t32(regs), t32(spads), t32(flags))
    for tables in ((code, luts), padded):
        tables = (torch.from_numpy(tables[0]), t32(tables[1]))
        for fn in (vcycle_seed_ref, kv.vcycle_seed):
            out = fn(*tables, *state)
            assert len(out) == 4
            for a, b, name in zip(ref, out,
                                  ("regs", "spads", "flags", "trace")):
                np.testing.assert_array_equal(np.asarray(a), u32(b),
                                              err_msg=f"{fn.__name__} {name}")


@pytest.mark.parametrize("C,T,R,S,tile", [
    (1, 4, 8, 16, 1),
    (4, 16, 32, 64, 2),
    (8, 32, 64, 32, 8),
    (16, 8, 16, 16, 4),
    (6, 12, 24, 48, 3),
])
def test_seed_plain_matches_pallas_sweep(C, T, R, S, tile):
    rng = np.random.default_rng(C * 1000 + T)
    check_seed(*random_program(rng, C, T, R, S), tile)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([2, 4, 8]),
       st.sampled_from([4, 16, 48]))
def test_seed_plain_matches_pallas_property(seed, C, T):
    rng = np.random.default_rng(seed)
    check_seed(*random_program(rng, C, T, 32, 32), 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_masks_32_bit_words_like_the_tpu_kernel(seed):
    """Register, scratchpad and LUT words over all 32 bits and immediates
    over the whole int32 range. ``_vcycle_kernel`` masks each result to 16
    bits before the register write; the chunk engines' ``vcycle_ref``
    writes it unmasked, so the two plain versions must differ here."""
    rng = np.random.default_rng(seed)
    C, T, R, S = 8, 24, 16, 8
    code, luts, regs, spads, flags = random_program(rng, C, T, R, S)
    code[..., 6] = rng.integers(-2**31, 2**31, (T, C))
    luts = rng.integers(0, 2**32, luts.shape, dtype=np.uint64) \
        .astype(np.uint32)
    regs = rng.integers(0, 2**32, regs.shape, dtype=np.uint64) \
        .astype(np.uint32)
    regs[:, 0] = 0
    spads = rng.integers(0, 2**32, spads.shape, dtype=np.uint64) \
        .astype(np.uint32)
    check_seed(code, luts, regs, spads, flags, 4)
    masked = vcycle_seed_ref(torch.from_numpy(code), t32(luts), t32(regs),
                             t32(spads), t32(flags))[0]
    unmasked = vcycle_ref(torch.from_numpy(code), t32(luts), t32(regs),
                          t32(spads), t32(flags))[0]
    assert not torch.equal(masked, unmasked)


# ------------------------------------------------------------ seed arm ----
def port(prog):
    return program_from_arrays(program_to_arrays(prog))


def assert_same_state(jstate, tstate, what):
    for name, a, b in zip(LEAVES, jstate, state_to_numpy(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{what}: {name}")


def run_all_seed_arms(b, prog, chunk=jbsp.DEFAULT_CHUNK):
    """The reference's two seed arms, the port's seed arm and the port's
    specialized engine, each run to the bench budget."""
    n = b.n_cycles + 10
    out = {}
    for name, m in (
            ("jnp", jbsp.Machine(prog, specialize=False)),
            ("pallas", jbsp.Machine(prog, specialize=False,
                                    backend="pallas", interpret=True))):
        out[name] = (m, m.run(m.init_state(), n))
    p = port(prog)
    for name, spec in (("port_seed", False), ("port_machine", True)):
        m = tbsp.Machine(p, device="cpu", specialize=spec, chunk=chunk)
        out[name] = (m, m.run(m.init_state(), n))
    return out


def check_seed_arms(b, prog, chunk=jbsp.DEFAULT_CHUNK):
    runs = run_all_seed_arms(b, prog, chunk)
    tm, ts = runs["port_seed"]
    for name in ("jnp", "pallas"):
        assert_same_state(runs[name][1], ts, name)
    # the port's seed baseline equals its specialized engine
    # (test_engine_fastpath.py::test_seed_baseline_still_available)
    sm, ss = runs["port_machine"]
    for name, a, c in zip(LEAVES, state_to_numpy(ss), state_to_numpy(ts)):
        np.testing.assert_array_equal(a, c, err_msg=f"specialized {name}")
    assert tm.perf(ts) == runs["jnp"][0].perf(runs["jnp"][1])
    assert tm.perf(ts)["vcycles"] == b.n_cycles
    assert set(tm.exceptions(ts).values()) == {FINISH}


@pytest.mark.parametrize("name", NAMES)
def test_seed_arm_matches_reference_seed_arms(name):
    b = build(name, "small")
    check_seed_arms(b, compile_circuit(b.circuit, HW))


def test_seed_arm_runs_prologue_rows_in_the_stream():
    """bc/full carries a retimed prologue. The seed arm runs those rows at
    the head of every Vcycle and applies none at init; it still equals the
    specialized engine, whose rotated dispatch runs them after the
    exchange (chunk 8 puts FINISH mid-chunk there)."""
    b = build("bc", "full")
    prog = compile_circuit(b.circuit, HW)
    assert prog.pipe_prologue > 0
    m = tbsp.Machine(port(prog), device="cpu", specialize=False)
    assert m.Tpro == 0
    np.testing.assert_array_equal(state_to_numpy(m.init_state())[0],
                                  prog.reg_init[:m.C, :m.R])
    check_seed_arms(b, prog, chunk=8)


def test_seed_arm_stops_before_each_vcycle():
    """The budget and the flags are tested before every Vcycle, as the
    reference's ``_run_legacy`` does: a carried state continues exactly,
    and a raised state does not move."""
    b = build("mc", "small")
    prog = compile_circuit(b.circuit, HW)
    jm = jbsp.Machine(prog, specialize=False)
    tm = tbsp.Machine(port(prog), device="cpu", specialize=False)
    js, ts = jm.init_state(), tm.init_state()
    for n in (0, 1, 5, 100, 3):
        js, ts = jm.run(js, n), tm.run(ts, n)
        assert_same_state(js, ts, f"after {n}")
    assert tm.perf(ts)["vcycles"] == b.n_cycles
