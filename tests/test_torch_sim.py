"""The port's ``sim`` facade against the reference's: same circuits, same
options, identical ``RunResult``s (the port runs on the CPU here)."""
import dataclasses

import pytest
import torch

import repro.sim as jsim
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as tsim
from repro_torch.circuits import FINISH
from repro_torch.core.isa import HardwareConfig as THW
from repro_torch.core.netlist import Circuit
from repro_torch.sim.engine import MachineEngine

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


@pytest.mark.parametrize("kind", ["sharded", "grid"])
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


def _global_circuit():
    """A circuit whose memory is global (GLD/GST on the privileged core)."""
    c = Circuit("gmem")
    m = c.mem("big", 1 << 12, 16, is_global=True)
    ctr = c.reg(16, init=0, name="ctr")
    c.set_next(ctr, ctr + 1)
    rd = c.mem_read(m, ctr)
    acc = c.reg(16, init=0, name="acc")
    c.set_next(acc, acc + rd)
    c.mem_write(m, ctr, acc, c.const(1, 1))
    c.finish_when(ctr.eq(40), eid=FINISH)
    return c


@pytest.mark.parametrize("name", ["mm", "mc", "noc", "global"])
def test_engine_adapter_parity(name):
    """The same compiled Program through every ported engine kind via the
    protocol: identical finish cycle, exceptions, registers and outputs
    (``tests/test_sim_api.py::test_engine_adapter_parity``, with ``pallas``
    also for a global-memory program: the port's kernel runs those), and
    the netlist oracle agrees on every probe it shares."""
    if name == "global":
        s = tsim.compile(_global_circuit(), THW(**HW), device="cpu")
        assert s.program.has_global
        n = 60
    else:
        s = tsim.compile(name, THW(**HW), scale="small", device="cpu")
        n = s.default_cycles()
    engines = {kind: s.engine(kind) for kind in
               ("machine", "seed", "pallas", "jnp", "isa")}
    engines["machine_seed"] = s.engine("machine", specialize=False)
    engines["batched"] = s.engine("batched", batch=2)
    results = {}
    for kind, eng in engines.items():
        assert isinstance(eng, tsim.Engine)
        results[kind] = eng.run(n)
    ref = results["machine"]
    assert ref.finished, ref.exceptions
    for kind, r in results.items():
        assert (r.cycles, r.exceptions, r.registers, r.outputs) == \
            (ref.cycles, ref.exceptions, ref.registers, ref.outputs), kind
    for kind in ("seed", "pallas", "jnp", "machine_seed"):
        assert results[kind].perf == ref.perf, kind
    oracle = s.engine("oracle").run(n)
    assert oracle.cycles == ref.cycles
    assert oracle.exception_ids == ref.exception_ids
    assert oracle.registers == ref.registers


@pytest.mark.parametrize("kind", ["pallas", "jnp", "seed"])
def test_reference_engine_kinds_resolve(kind):
    """``pallas`` and ``jnp`` are the reference's specialized
    single-stimulus engine (``repro/sim/facade.py``: the chunk kernel at
    B=1, and the jnp engine); the port once sent ``pallas`` to
    NotImplementedError as if it were the seed arm, and did not know
    ``jnp``. ``seed`` is the unspecialized arm. Each returns the
    reference's result."""
    ref = jsim.compile("mc", JHW(**HW), scale="small").run(engine=kind)
    s = tsim.compile("mc", THW(**HW), scale="small", device="cpu")
    eng = s.engine(kind)
    assert isinstance(eng, MachineEngine)
    assert eng.m.specialize == (kind != "seed")
    same_results(ref, s.run(engine=kind))
