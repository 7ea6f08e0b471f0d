"""The port's ``sim`` facade against the reference's: same circuits, same
options, identical ``RunResult``s (the port runs on the CPU here)."""
import dataclasses

import pytest
import torch

import repro.sim as jsim
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as tsim
from repro_torch.core.isa import HardwareConfig as THW

HW = dict(grid_width=5, grid_height=5)


def same_results(a, b):
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    assert [dataclasses.asdict(r) for r in a] == \
        [dataclasses.asdict(r) for r in b]


@pytest.mark.parametrize("name", ["mm", "mc", "noc"])
def test_single_stimulus_run_matches_reference(name):
    ref = jsim.compile(name, JHW(**HW), scale="small").run()
    s = tsim.compile(name, THW(**HW), scale="small", device="cpu")
    assert s.engine_kind == "machine"
    out = s.run()
    assert out.finished
    same_results(ref, out)


def test_batched_run_matches_reference():
    seeds = [1, 2, 3]
    ref = jsim.compile("mc", JHW(**HW), scale="small", seeds=seeds).run()
    s = tsim.compile("mc", THW(**HW), scale="small", seeds=seeds,
                     device="cpu")
    assert s.engine_kind == "batched"
    out = s.run()
    assert len(out) == 3 and all(r.finished for r in out)
    assert out[0].registers != out[1].registers     # the seeds differ
    same_results(ref, out)
    # run() memoizes the engine and resets it: a second run is identical
    same_results(out, s.run())


@pytest.mark.parametrize("kind", ["isa", "oracle"])
def test_oracle_kinds_match_reference(kind):
    ref = jsim.compile("noc", JHW(**HW), scale="small").run(engine=kind)
    s = tsim.compile("noc", THW(**HW), scale="small", device="cpu")
    same_results(ref, s.run(engine=kind))


@pytest.mark.parametrize("kind", ["sharded", "grid", "seed", "pallas"])
def test_unported_engine_kinds_raise(kind):
    s = tsim.compile("mc", THW(**HW), scale="small", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.engine(kind)
    with pytest.raises(ValueError, match="unknown engine kind"):
        s.engine("verilator")


def test_default_device_is_the_card(tmp_path):
    s = tsim.compile("mc", THW(**HW), scale="small")
    if torch.cuda.is_available():
        assert s.run().finished
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.run()
    # the CPU is reached only when asked for, also after an artifact load
    path = s.save(tmp_path / "mc.npz")
    loaded = tsim.load(path, device="cpu")
    isa = s.run(engine="isa")
    out = loaded.run(s.default_cycles())
    assert out.finished
    assert (out.cycles, out.registers, out.exceptions) == \
        (isa.cycles, isa.registers, isa.exceptions)
