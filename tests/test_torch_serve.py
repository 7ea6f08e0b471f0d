"""The port's serving layer (``repro_torch.serve``) on the CPU, held to
``repro.serve``: the reference's cases of ``tests/test_serve.py`` run on
the port (``device="cpu"``), and the two packages answer the same
requests with the same results over the same wire protocol.

Contracts under test (the reference's):

- coalescing is *semantics-free*: a batch of concurrent same-fingerprint
  requests produces per-request results bit-exact against independent
  ``sim.compile(name, seeds=[s]).run()`` runs (mc/bc — builders whose
  structure is seed-invariant);
- mixed-fingerprint traffic lands on separate queues and demuxes
  correctly (mc and bc riders never contaminate each other);
- admission policy: deadline-expired requests get TIMEOUT without
  occupying a batch slot; a full queue refuses admission (REJECTED);
  batches split at ``max_batch``;
- the session LRU evicts under ``max_sessions`` and re-admission
  recompiles *warm* through the on-disk compile cache;
- the compile cache survives concurrent writers of one entry
  (atomic-rename last-writer-wins: readers see a complete old or new
  artifact, never a torn one);
- ``BatchedEngine.rebind`` swaps stimuli onto a hot engine bit-exactly;
- the TCP front-end round-trips the JSON protocol and still coalesces.

``Simulation.fingerprint``/``select_engine_kind`` are held in
``tests/test_torch_facade_keywords.py``.
"""
import asyncio
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core.isa import HardwareConfig as JHW

import repro_torch.sim as sim
from repro_torch.circuits import build
from repro_torch.core.compile import compile_circuit
from repro_torch.core.isa import HardwareConfig
from repro_torch.serve import (BatchPolicy, Batcher, Pending, Rejected,
                               SessionManager, SimRequest, SimServer,
                               TIMEOUT, decode_response, encode_request)
from repro_torch.serve import protocol as tproto
from repro_torch.sim.cache import CompileCache

ROOT = Path(__file__).resolve().parents[1]

HWD = {"grid_width": 5, "grid_height": 5}
HW = HardwareConfig(**HWD)


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """One on-disk compile cache for the module: canonical designs
    compile once, later tests warm-start."""
    return str(tmp_path_factory.mktemp("serve_cache"))


def _req(name, seed, **kw):
    return SimRequest(name, scale="small", seed=seed, hw=HWD, **kw)


def _sessions(cache, **kw):
    return SessionManager(cache=cache, device="cpu", **kw)


def _assert_same_result(got, ref):
    assert got.cycles == ref.cycles
    assert got.exceptions == ref.exceptions
    assert got.registers == ref.registers
    assert got.outputs == ref.outputs


# ----------------------------------------------------------------------
# coalescing correctness
# ----------------------------------------------------------------------

def test_coalesced_bit_exact_vs_individual(cache_dir):
    """Five concurrent mc requests ride one batched launch, and every
    per-request result is bit-exact vs its own single-stimulus compile."""
    seeds = [11, 12, 13, 14, 15]

    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_batch=8, max_wait_s=0.3))
        try:
            resps = await asyncio.gather(
                *(server.submit(_req("mc", s)) for s in seeds))
            return resps, server.stats()["stages"]
        finally:
            await server.close()

    resps, stages = asyncio.run(go())
    assert all(r.ok for r in resps), [r.error for r in resps]
    assert len({r.fingerprint for r in resps}) == 1
    assert all(r.batch == len(seeds) for r in resps)     # one launch
    # the launch's stages: one engine built, and its seconds within run_s
    assert stages["launches"] == 1 and stages["engines_built"] == 1
    assert min(stages[k] for k in ("images_s", "engine_s", "chunks_s",
                                   "snapshots_s")) >= 0
    assert stages["engine_s"] + stages["chunks_s"] + \
        stages["snapshots_s"] <= resps[0].run_s
    assert all(r.engine_kind == "batched" for r in resps)
    for s, r in zip(seeds, resps):
        ref = sim.compile("mc", HW, scale="small", seeds=[s],
                          cache=cache_dir, device="cpu").run()
        assert r.result.finished and ref.finished
        _assert_same_result(r.result, ref)


def test_mixed_fingerprint_traffic_demuxes(cache_dir):
    """Interleaved mc/bc traffic: two queues, two launches, every rider
    gets its own circuit's (correct) result."""
    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_batch=8, max_wait_s=0.3))
        try:
            reqs = []
            for i in range(3):
                reqs.append(_req("mc", 21 + i))
                reqs.append(_req("bc", 31 + i))
            return await asyncio.gather(
                *(server.submit(r) for r in reqs))
        finally:
            await server.close()

    resps = asyncio.run(go())
    assert all(r.ok for r in resps), [r.error for r in resps]
    mc_r, bc_r = resps[0::2], resps[1::2]
    assert len({r.fingerprint for r in mc_r}) == 1
    assert len({r.fingerprint for r in bc_r}) == 1
    assert mc_r[0].fingerprint != bc_r[0].fingerprint
    assert all(r.batch == 3 for r in resps)              # per-queue batches
    for kind, group, seed0 in (("mc", mc_r, 21), ("bc", bc_r, 31)):
        for i, r in enumerate(group):
            ref = sim.compile(kind, HW, scale="small", seeds=[seed0 + i],
                              cache=cache_dir, device="cpu").run()
            assert r.result.finished and ref.finished
            _assert_same_result(r.result, ref)


def test_batched_engine_rebind_bit_exact(cache_dir):
    """A hot engine rebound onto new stimulus images matches a freshly
    built engine bit-exactly — the no-retrace residency contract."""
    s = sim.compile("mc", HW, scale="small", seeds=[101, 102, 103],
                    cache=cache_dir, device="cpu")
    eng = s.engine("batched")
    n = s.default_cycles()
    eng.run_batch(n)

    b2 = build("mc", "small", seeds=[201, 202, 203])
    imgs2 = b2.images_batch(s.program)
    fresh = s.engine("batched", images=imgs2).run_batch(n)
    machine_before = eng.m
    eng.rebind(imgs2)
    assert eng.m is machine_before          # no rebuild, no retrace
    rebound = eng.run_batch(n)
    for got, ref in zip(rebound, fresh):
        assert got.finished
        _assert_same_result(got, ref)
    with pytest.raises(ValueError):
        eng.rebind(build("mc", "small", seeds=[1, 2]).images_batch(s.program))


# ----------------------------------------------------------------------
# admission policy
# ----------------------------------------------------------------------

def test_request_timeout(cache_dir):
    """A request whose deadline passes before launch gets TIMEOUT and
    never occupies a batch slot."""
    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_batch=4, max_wait_s=0.2))
        try:
            ok = await server.submit(_req("mc", 1))
            late = await server.submit(_req("mc", 2, timeout=0.0))
            return ok, late, dict(server.batcher.stats)
        finally:
            await server.close()

    ok, late, stats = asyncio.run(go())
    assert ok.ok and ok.result.finished
    assert late.status == TIMEOUT and late.result is None
    assert late.wait_s >= 0.0
    assert stats["timed_out"] == 1


def test_batcher_backpressure_and_splitting():
    """Pure-batcher unit test (no engine): queue-full admission refusal,
    max_batch splitting, nothing lost."""
    async def go():
        launched = []
        gate = asyncio.Event()

        async def launch(key, batch):
            await gate.wait()
            launched.append([p.req.seed for p in batch])
            for p in batch:
                p.future.set_result(p.req.seed)

        b = Batcher(BatchPolicy(max_batch=3, max_wait_s=0.05, max_queue=4),
                    launch)
        loop = asyncio.get_running_loop()

        def pend(s):
            return Pending(req=SimRequest("x", seed=s),
                           future=loop.create_future())

        first = [pend(i) for i in range(4)]
        for p in first:
            b.submit("k", p)
        # let the drain task pull max_batch=3 into a forming batch (it
        # then blocks on the gate); the queue holds the 4th
        await asyncio.sleep(0.15)
        extra = [pend(10 + i) for i in range(3)]
        for p in extra:
            b.submit("k", p)                       # queue back at 4
        with pytest.raises(Rejected):
            b.submit("k", pend(99))                # admission refused
        gate.set()
        res = await asyncio.gather(*(p.future for p in first + extra))
        await b.close()
        return launched, res, dict(b.stats)

    launched, res, stats = asyncio.run(go())
    assert sorted(res) == [0, 1, 2, 3, 10, 11, 12]
    assert launched[0] == [0, 1, 2]                # split at max_batch
    assert all(len(x) <= 3 for x in launched)
    assert sum(len(x) for x in launched) == 7
    assert stats["rejected"] == 1
    assert stats["launches"] == len(launched)


# ----------------------------------------------------------------------
# session lifecycle
# ----------------------------------------------------------------------

def test_lru_eviction_recompiles_warm(tmp_path):
    """max_sessions=1: admitting bc evicts mc; re-admitting mc compiles
    *warm* from the on-disk cache and still simulates correctly."""
    async def go():
        sm = _sessions(str(tmp_path), max_sessions=1)
        server = SimServer(sessions=sm,
                           policy=BatchPolicy(max_batch=2, max_wait_s=0.05))
        try:
            r1 = await server.submit(_req("mc", 3))
            assert sm.counters["cache_hits"] == 0  # cold: fresh cache dir
            r2 = await server.submit(_req("bc", 3))
            assert sm.counters["evictions"] >= 1
            assert len(sm.resident()) == 1
            r3 = await server.submit(_req("mc", 4))
            return r1, r2, r3, dict(sm.counters)
        finally:
            await server.close()

    r1, r2, r3, stats = asyncio.run(go())
    for r in (r1, r2, r3):
        assert r.ok and r.result.finished, r.error
    assert r1.fingerprint == r3.fingerprint
    assert stats["compiles"] == 3
    assert stats["cache_hits"] == 1                # mc came back warm


def test_unknown_circuit_and_option_are_errors(cache_dir):
    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_wait_s=0.01))
        try:
            bad_name = await server.submit(SimRequest("nonesuch"))
            bad_opt = await server.submit(
                _req("mc", 1, options={"frobnicate": True}))
            return bad_name, bad_opt
        finally:
            await server.close()

    bad_name, bad_opt = asyncio.run(go())
    assert bad_name.status == "error" and "nonesuch" in bad_name.error
    assert bad_opt.status == "error" and "frobnicate" in bad_opt.error


# ----------------------------------------------------------------------
# compile-cache concurrency (atomic rename, last-writer-wins)
# ----------------------------------------------------------------------

def test_cache_concurrent_writers_last_writer_wins(tmp_path):
    """Writer threads hammer one cache key with two different (complete)
    programs while readers load continuously: every successful load is a
    bit-exact copy of one of the writers' programs — never a torn mix —
    and the final entry is valid."""
    prog_a = compile_circuit(build("mc", "small").circuit, HW)
    prog_b = compile_circuit(build("bc", "small").circuit, HW)
    cc = CompileCache(tmp_path)
    key = "f" * 64
    stop = threading.Event()
    bad = []

    def writer(prog):
        while not stop.is_set():
            cc.store(key, prog)

    def reader():
        while not stop.is_set():
            p = cc.load(key)
            if p is None:          # entry mid-replace reads as a miss
                continue
            ref = {"mc": prog_a, "bc": prog_b}.get(p.name)
            if ref is None:
                bad.append(f"unknown name {p.name!r}")
            elif not (np.array_equal(p.code, ref.code)
                      and np.array_equal(p.reg_init, ref.reg_init)
                      and np.array_equal(p.xchg_src_core,
                                         ref.xchg_src_core)):
                bad.append("torn artifact read")

    threads = [threading.Thread(target=writer, args=(prog_a,)),
               threading.Thread(target=writer, args=(prog_b,)),
               threading.Thread(target=reader),
               threading.Thread(target=reader)]
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not bad, bad[:3]
    final = cc.load(key)
    assert final is not None and final.name in ("mc", "bc")
    # no temp-file litter left behind in the cache directory
    assert not [f for f in tmp_path.iterdir() if f.name.endswith(".tmp")]


# ----------------------------------------------------------------------
# TCP front-end
# ----------------------------------------------------------------------

def test_tcp_roundtrip_coalesces(cache_dir):
    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_batch=4,
                                              max_wait_s=0.25))
        try:
            tcp = await server.serve_tcp("127.0.0.1", 0)
            port = tcp.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port)
            reqs = [_req("mc", 41 + i) for i in range(2)]
            for r in reqs:
                writer.write(encode_request(r))
            await writer.drain()
            resps = [decode_response(await reader.readline())
                     for _ in range(2)]
            writer.close()
            return reqs, resps
        finally:
            await server.close()

    reqs, resps = asyncio.run(go())
    by_rid = {r.rid: r for r in resps}
    assert set(by_rid) == {r.rid for r in reqs}
    for r in resps:
        assert r.ok and r.result.finished
        assert r.batch == 2                       # coalesced over TCP
        assert r.result.cycles > 0 and r.result.registers


# ----------------------------------------------------------------------
# the port against the reference
# ----------------------------------------------------------------------

def test_default_device_is_the_card(tmp_path):
    """``SessionManager()`` and ``SimServer()`` resolve their device when
    built: the card, or raise without one; the CPU only when asked."""
    if torch.cuda.is_available():
        assert SessionManager(cache=False).device.type == "cuda"
        assert SimServer(cache=False).sessions.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SessionManager(cache=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SimServer(cache=False)
    assert SimServer(cache=False, device="cpu").sessions.device == \
        torch.device("cpu")

    async def go():
        server = SimServer(cache=str(tmp_path), device="cpu",
                           policy=BatchPolicy(max_wait_s=0.01))
        try:
            resp = await server.submit(_req("mc", 5))
            sess = server.sessions._sessions[
                server.sessions.resident()[0]]
            return resp, sess
        finally:
            await server.close()

    resp, sess = asyncio.run(go())
    assert resp.ok and resp.result.finished
    assert sess.sim.device == torch.device("cpu")
    (eng,) = sess._engines.values()
    assert eng.m.device == torch.device("cpu")


MIXED = [("mc" if i % 2 == 0 else "bc", 600 + i) for i in range(16)]


async def _serve_mixed(server, make_req):
    try:
        return await asyncio.gather(
            *(server.submit(make_req(name, seed)) for name, seed in MIXED))
    finally:
        await server.close()


def test_same_requests_same_results_as_reference(tmp_path):
    """16 mixed mc+bc requests through ``repro.serve.SimServer`` and the
    port's on the CPU: the same statuses, batches and engine kinds, and
    the same results word for word (waits and run times may differ)."""
    policy = dict(max_batch=8, max_wait_s=0.3)
    ref = asyncio.run(_serve_mixed(
        jserve.SimServer(
            sessions=jserve.SessionManager(cache=str(tmp_path / "j")),
            policy=jserve.BatchPolicy(**policy)),
        lambda name, seed: jserve.SimRequest(name, scale="small",
                                             seed=seed, hw=HWD)))
    got = asyncio.run(_serve_mixed(
        SimServer(sessions=_sessions(str(tmp_path / "t")),
                  policy=BatchPolicy(**policy)),
        lambda name, seed: _req(name, seed)))
    assert all(r.ok for r in ref), [r.error for r in ref]
    for (name, seed), j, t in zip(MIXED, ref, got):
        assert (t.status, t.batch, t.engine_kind, t.fingerprint) == \
            (j.status, j.batch, j.engine_kind, j.fingerprint), (name, seed)
        assert t.batch == 8 and t.engine_kind == "batched"
        assert dataclasses.asdict(t.result) == \
            dataclasses.asdict(j.result), (name, seed)
        assert t.result.finished


def test_wire_protocol_is_shared_with_the_reference():
    """A request encoded by either package decodes in the other, and so
    does a response with a full RunResult and a failure's v2 fields."""
    ref = jserve.SimRequest("mc", scale="small", seed=7, hw=HWD,
                            cycles=40, timeout=1.5,
                            options={"pipeline": "off"}, rid="r1")
    req = tproto.decode_request(jserve.encode_request(ref))
    assert dataclasses.asdict(req) == dataclasses.asdict(ref)
    back = jserve.decode_request(tproto.encode_request(req))
    assert dataclasses.asdict(back) == dataclasses.asdict(ref)
    assert tproto.encode_request(req) == jserve.encode_request(ref)

    async def serve_one():
        server = SimServer(cache=False, device="cpu",
                           policy=BatchPolicy(max_wait_s=0.01))
        try:
            return await server.submit(_req("bc", 9))
        finally:
            await server.close()

    ok = asyncio.run(serve_one())
    assert ok.ok
    for resp in (ok, tproto.SimResponse(
            "r2", tproto.UNAVAILABLE, error="quarantined",
            error_code=tproto.ERR_UNAVAILABLE, retry_after_s=0.5)):
        line = tproto.encode_response(resp)
        j = jserve.decode_response(line)
        assert dataclasses.asdict(j) == dataclasses.asdict(resp)
        assert jserve.encode_response(j) == line
        t = tproto.decode_response(jserve.encode_response(j))
        assert dataclasses.asdict(t) == dataclasses.asdict(resp)


def test_reference_client_talks_to_the_port_over_tcp(cache_dir):
    """Requests written by the reference's ``encode_request`` to the port's
    TCP front-end come back as responses the reference decodes, equal to
    the reference's own in-process results."""
    seeds = [71, 72]

    async def go():
        server = SimServer(sessions=_sessions(cache_dir),
                           policy=BatchPolicy(max_batch=4, max_wait_s=0.25))
        try:
            tcp = await server.serve_tcp("127.0.0.1", 0)
            port = tcp.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port)
            reqs = [jserve.SimRequest("mc", scale="small", seed=s, hw=HWD)
                    for s in seeds]
            for r in reqs:
                writer.write(jserve.encode_request(r))
            await writer.drain()
            resps = [jserve.decode_response(await reader.readline())
                     for _ in reqs]
            writer.close()
            return reqs, resps
        finally:
            await server.close()

    reqs, resps = asyncio.run(go())
    by_rid = {r.rid: r for r in resps}
    assert set(by_rid) == {r.rid for r in reqs}

    async def reference():
        server = jserve.SimServer(
            sessions=jserve.SessionManager(cache=cache_dir),
            policy=jserve.BatchPolicy(max_batch=4, max_wait_s=0.25))
        try:
            return await asyncio.gather(*(server.submit(
                jserve.SimRequest("mc", scale="small", seed=s, hw=HWD))
                for s in seeds))
        finally:
            await server.close()

    for r, ref in zip(reqs, asyncio.run(reference())):
        got = by_rid[r.rid]
        assert got.ok and got.batch == 2 and got.result.finished
        assert dataclasses.asdict(got.result) == \
            dataclasses.asdict(ref.result)


def test_self_test_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.serve --self-test --device cpu`` serves its
    mixed requests and exits 0; without ``--device`` on a machine with no
    card it fails at start."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SIM_CACHE=str(tmp_path))
    cmd = [sys.executable, "-m", "repro_torch.serve", "--self-test",
           "--scale", "small"]
    out = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "self-test ok: 8 requests" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=300)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
