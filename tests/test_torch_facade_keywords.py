"""The port's facade takes the reference's sharding keywords
(``shard_batch``, ``devices``, ``mesh``) and resolves them as
``repro.sim.facade`` does; the kinds they select (``sharded`` over a list
of devices, ``grid`` over a ``mesh`` of devices) run, here on lists of CPU
devices. Mirrors
``tests/test_serve.py::test_fingerprint_and_engine_kind_public``."""
import pytest

import repro.sim as jsim
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as tsim
from repro_torch.core.isa import HardwareConfig as THW

HW = dict(grid_width=5, grid_height=5)
FAKE8 = [object()] * 8


def test_fingerprint_and_engine_kind_public(tmp_path):
    s = tsim.compile("mc", THW(**HW), scale="small", device="cpu")
    assert s.fingerprint == s.circuit.fingerprint()
    assert s.engine_kind == "machine"

    s2 = tsim.compile("mc", THW(**HW), scale="small", seeds=[1, 2],
                      device="cpu")
    assert s2.fingerprint is not None
    assert s2.engine_kind == "batched"
    assert s2.select_engine_kind(64, devices=FAKE8) == "sharded"
    assert s2.select_engine_kind(8, devices=FAKE8) == "batched"  # B < 2*D
    assert s2.select_engine_kind(1) == "machine"
    assert s2.select_engine_kind(64, devices=FAKE8,
                                 shard_batch=False) == "batched"
    s3 = tsim.compile("mc", THW(**HW), scale="small", seeds=[1, 2],
                      shard_batch=True, device="cpu")
    assert s3.meta["shard_batch"] is True
    assert s3.select_engine_kind(2, devices=FAKE8) == "sharded"

    # the fingerprint is recorded in Program.stats, so it survives the
    # artifact round-trip (a loaded Simulation has no circuit to hash)
    p = tmp_path / "mc.npz"
    s.save(p)
    loaded = tsim.load(p, device="cpu")
    assert loaded.circuit is None
    assert loaded.fingerprint == s.fingerprint


@pytest.fixture(scope="module")
def both():
    return (jsim.compile("mc", JHW(**HW), scale="small", seeds=[1, 2]),
            tsim.compile("mc", THW(**HW), scale="small", seeds=[1, 2],
                         device="cpu"))


@pytest.mark.parametrize("batch", [1, 2, 15, 16])
@pytest.mark.parametrize("devices", [None, [object()], FAKE8])
@pytest.mark.parametrize("shard_batch", [None, True, False])
def test_select_engine_kind_matches_reference(both, batch, devices,
                                              shard_batch):
    """The same rule as the reference on the same inputs (``devices=None``
    counts the visible devices of each package's own platform: on the CPU
    one JAX device and no card)."""
    j, t = both
    want = j.select_engine_kind(batch, devices=devices,
                                shard_batch=shard_batch)
    assert t.select_engine_kind(batch, devices=devices,
                                shard_batch=shard_batch) == want
    assert t.select_engine_kind(batch, mesh=object(), devices=devices,
                                shard_batch=shard_batch) == "grid"


def test_compile_keeps_shard_batch_out_of_the_builder():
    """``shard_batch=False`` used to reach ``build_mc`` as a build override
    and raise ``TypeError``."""
    s = tsim.compile("mc", THW(**HW), scale="small", seeds=[1, 2],
                     shard_batch=False, device="cpu")
    assert s.meta["shard_batch"] is False
    assert s.engine_kind == "batched"
    ref = jsim.compile("mc", JHW(**HW), scale="small", seeds=[1, 2],
                       shard_batch=False)
    assert s.fingerprint == ref.fingerprint
    out = s.engine("auto", shard_batch=False, devices=FAKE8).run_batch(
        s.default_cycles())
    assert [r.registers for r in out] == \
        [r.registers for r in ref.run()]


@pytest.mark.parametrize("keywords,kind", [
    (dict(shard_batch=True), "sharded"),
    (dict(batch=64, devices=["cpu"] * 8), "sharded"),
    (dict(mesh=["cpu"] * 2), "grid"),
    (dict(kind="sharded", shard_batch=False), "sharded"),
    (dict(kind="grid", mesh=["cpu"] * 4), "grid")])
def test_sharded_and_grid_run_from_the_keyword_cases(keywords, kind):
    """The keyword cases that select ``sharded`` or ``grid`` build that
    engine on the CPU, and its results equal ``batched``'s."""
    s = tsim.compile("mc", THW(**HW), scale="small", seeds=[1, 2],
                     device="cpu")
    keywords = dict(keywords)
    eng = s.engine(keywords.pop("kind", "auto"), **keywords)
    assert eng.kind == kind
    want = s.engine("batched").run_batch(s.default_cycles())
    assert eng.run_batch(s.default_cycles()) == want


def test_several_cards_still_pick_batched(monkeypatch, tmp_path):
    """With no ``devices=``, a Simulation on the CPU counts one device to
    shard over, however many cards the host has: a batch runs as
    ``batched`` through ``run()`` and through the daemon. A Simulation on
    the card counts every card (``torch.cuda.device_count()``)."""
    import asyncio

    import torch

    from repro_torch.serve import BatchPolicy, SimRequest, SimServer

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    s = tsim.compile("mc", THW(**HW), scale="small", seeds=range(8),
                     device="cpu")
    assert s.engine_kind == "batched"
    assert s.select_engine_kind(64) == "batched"
    assert s.select_engine_kind(64, devices=[object()] * 4) == "sharded"
    out = s.run()
    assert len(out) == 8 and all(r.finished for r in out)
    on_card = tsim.compile("mc", THW(**HW), scale="small", seeds=range(8))
    assert on_card.select_engine_kind(64) == "sharded"
    assert on_card.select_engine_kind(7) == "batched"       # B < 2*D

    async def go():
        server = SimServer(cache=str(tmp_path), device="cpu",
                           policy=BatchPolicy(max_batch=8, max_wait_s=0.3))
        try:
            return await asyncio.gather(*(server.submit(SimRequest(
                "mc", scale="small", seed=seed, hw=HW))
                for seed in range(8)))
        finally:
            await server.close()

    resps = asyncio.run(go())
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert {(r.engine_kind, r.batch) for r in resps} == {("batched", 8)}
