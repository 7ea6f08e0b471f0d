"""The generators and the plain reference against the port's own builders."""
import numpy as np
import pytest

from rtlbench import reference
from rtlbench.stimuli import mc as gen_mc
from rtlbench.stimuli import module

SMALL = {"mc": {"n_walkers": 4}}


@pytest.mark.parametrize("design", sorted(SMALL))
def test_generator_gives_the_port_builders_netlist_planes_and_goldens(
        design):
    from repro_torch.circuits import build
    seeds = [11, 12, 13]
    want = build(design, "small", seeds=seeds)
    got = module(design).build(SMALL[design], 32, seeds, seeds[0])
    assert got.circuit.fingerprint() == want.circuit.fingerprint()
    assert got.finish == want.n_cycles
    # the planes hold each stimulus's initial state and its goldens
    assert got.planes(0, 3) == want.reg_planes


@pytest.mark.parametrize("design", sorted(SMALL))
def test_reference_steps_alike_in_numpy_and_torch(design):
    gen = module(design)
    a = gen.build(SMALL[design], 40, [1, 2, 3], 5)
    b = gen.build(SMALL[design], 40, [1, 2, 3], 5, device="cpu")
    for k in a.expected:
        np.testing.assert_array_equal(a.expected[k], b.expected[k])


def test_reference_cuts_the_product_to_32_bits_as_the_netlist_does():
    """Past some 400 cycles a price times its 8-bit draw passes 2**32:
    the netlist's multiply cuts it, and the reference with it."""
    from repro_torch.core.interpreter import NetlistSim
    n = 450
    s = gen_mc.build({"n_walkers": 1}, n, [7], 7)
    sim = NetlistSim(s.circuit)
    for _ in range(n + 2):
        sim.step()
    for name, want in s.expected.items():
        assert sim.reg_value(name) == int(want[0]), name
    # the port's builder keeps the whole product in its golden, so its
    # test of this length raises MISMATCH on a sound simulator
    from repro_torch.circuits import build
    port = build("mc", n_walkers=1, n_cycles=n, seeds=[7])
    assert port.reg_planes[0]["gold0"] != int(s.expected["gold0"][0])


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_control_arithmetic_drops_the_carry_between_halves(op):
    a = np.array([0x0000FFFF, 0x12345678], np.int64)
    b = 3 if op == "mul" else np.array([1, 0x0000FFFF], np.int64)
    exact = getattr(reference.Exact, op)(a, b)
    low = getattr(reference.NoCarry, op)(a, b)
    assert (exact != low).any()
    assert ((low & 0xFFFF) == (exact & 0xFFFF)).all()
