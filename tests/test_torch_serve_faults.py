"""Fault tolerance of the port's serving stack (``repro_torch.serve`` +
``faults``) on the CPU: the reference's cases of
``tests/test_serve_faults.py`` run on the port (``device="cpu"``), and the
chaos drill's command line runs in a subprocess.

Contracts under test (the reference's):

- the fault-injection harness is deterministic (same seed → same fire
  sequence), zero-armed by default, and honours its ``times`` caps;
- poison isolation: a batched launch containing a poisoned stimulus is
  bisected so every healthy rider still gets its bit-exact ``OK`` and
  only the culprit gets ``ERROR``/``POISONED``;
- transient launch faults are retried with backoff and never surface to
  riders; the per-batch launch budget bounds a pathological batch;
- the session circuit breaker opens after consecutive compile failures
  (fast-fail ``UNAVAILABLE`` + ``retry_after_s``, no compile attempted),
  half-opens after the cooldown, and closes on a successful probe;
- launch-failure convoys open the breaker too, and one healthy rider in
  a poisoned batch keeps it closed;
- ``close(drain=True)`` answers every queued rider before shutdown and
  admission during/after drain is answered ``DRAINING``; abrupt
  ``close()`` still terminates queued riders (no abandoned futures);
- a client disconnect mid-batch resolves all server-side futures and
  leaves the daemon healthy; per-connection in-flight is capped;
- the timeout-vs-launch race resolves every future exactly once;
- protocol v2 error codes round-trip the wire and legacy (v1) messages
  still decode.
"""
import asyncio
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro_torch.serve import (BatchPolicy, Batcher, CircuitBreaker, DRAINING,
                               ERR_COMPILE_FAILED, ERR_DRAINING,
                               ERR_POISONED, ERR_TIMEOUT, ERR_UNAVAILABLE,
                               ERROR, FaultPlan, FaultSpec, InjectedFault,
                               OK, Pending, RetryPolicy, SessionManager,
                               SimRequest, SimResponse, SimServer, TIMEOUT,
                               UNAVAILABLE, decode_response, encode_request,
                               encode_response)
from repro_torch.serve import faults as faultlib
from repro_torch.serve.__main__ import chaos_drill

ROOT = Path(__file__).resolve().parents[1]

HWD = {"grid_width": 5, "grid_height": 5}


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    """One on-disk compile cache for the module: canonical designs
    compile once, later tests warm-start."""
    return str(tmp_path_factory.mktemp("serve_faults_cache"))


def _req(name, seed, **kw):
    return SimRequest(name, scale="small", seed=seed, hw=HWD, **kw)


def _server(cache_dir, *, faults=None, policy=None, sessions_kw=None,
            retry=None):
    sm = SessionManager(cache=cache_dir, faults=faults, device="cpu",
                        **(sessions_kw or {}))
    return SimServer(
        sessions=sm,
        policy=policy or BatchPolicy(max_batch=8, max_wait_s=0.25),
        faults=faults,
        retry=retry or RetryPolicy(backoff_base_s=0.005))


# ----------------------------------------------------------------------
# the harness itself (no engine, no asyncio)
# ----------------------------------------------------------------------

def test_faultplan_deterministic_and_capped():
    def fires(seed, n=200, p=0.3, times=None):
        plan = FaultPlan(seed, launch=FaultSpec(p=p, times=times,
                                                transient=True))
        out = []
        for i in range(n):
            try:
                plan.check(faultlib.LAUNCH, seeds=[i])
                out.append(0)
            except InjectedFault as f:
                assert f.transient and f.site == faultlib.LAUNCH
                out.append(1)
        return out, plan

    a, plan_a = fires(7)
    b, _ = fires(7)
    c, _ = fires(8)
    assert a == b                       # same seed → same schedule
    assert a != c                       # (with overwhelming probability)
    assert plan_a.fired()["launch"] == sum(a)
    assert plan_a.checked()["launch"] == 200

    capped, plan_cap = fires(7, times=3)
    assert sum(capped) == 3             # times cap: storms dry up
    assert plan_cap.stats()["fired"]["launch"] == 3

    # disabled plan never fires and never draws
    quiet = FaultPlan(7)
    for i in range(50):
        quiet.check(faultlib.COMPILE)
        quiet.check(faultlib.LAUNCH, seeds=[i])
    assert sum(quiet.fired().values()) == 0


def test_faultplan_poison_is_stateless_and_deterministic():
    plan = FaultPlan(0, launch=FaultSpec(poison_seeds=frozenset({13})))
    for _ in range(3):
        with pytest.raises(InjectedFault) as ei:
            plan.check(faultlib.LAUNCH, seeds=[11, 13, 15])
        assert ei.value.poisoned == (13,)
        assert not ei.value.transient
    plan.check(faultlib.LAUNCH, seeds=[11, 15])     # poison-free: quiet
    assert plan.fired()["launch"] == 3


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(threshold=2, cooldown_s=0.05)
    assert br.allow() == (True, 0.0)
    br.record_failure()
    assert br.state == br.CLOSED and br.allow()[0]
    br.record_failure()                             # threshold hit
    assert br.state == br.OPEN
    ok, retry_after = br.allow()
    assert not ok and retry_after > 0.0
    time.sleep(0.06)
    ok, _ = br.allow()                              # half-open probe
    assert ok and br.state == br.HALF_OPEN
    assert not br.allow()[0]                        # only one probe
    br.record_failure()                             # probe failed
    assert br.state == br.OPEN
    assert br.snapshot()["opens"] == 2
    time.sleep(0.15)                                # doubled cooldown
    assert br.allow()[0]
    br.record_success()
    assert br.state == br.CLOSED and br.failures == 0
    assert br.snapshot() == {"state": "closed", "failures": 0, "opens": 0,
                             "retry_after_s": 0.0}


# ----------------------------------------------------------------------
# poison isolation + retries (full daemon, small circuits)
# ----------------------------------------------------------------------

def test_bisection_isolates_exactly_the_poison_seed(cache_dir):
    """Five coalesced riders, seed 13 poisoned: the four healthy riders
    get OK results bit-exact vs a fault-free server; only 13 errors, and
    the session breaker stays closed (the build is healthy)."""
    seeds = [11, 12, 13, 14, 15]
    plan = FaultPlan(0, launch=FaultSpec(poison_seeds=frozenset({13})))

    async def go(faults):
        server = _server(cache_dir, faults=faults)
        try:
            resps = await asyncio.gather(
                *(server.submit(_req("mc", s)) for s in seeds))
            return resps, server.stats()
        finally:
            await server.close()

    poisoned, stats = asyncio.run(go(plan))
    clean, _ = asyncio.run(go(None))
    assert all(r.ok for r in clean)
    by_seed = dict(zip(seeds, poisoned))
    assert by_seed[13].status == ERROR
    assert by_seed[13].error_code == ERR_POISONED
    for s, ref in zip(seeds, clean):
        if s == 13:
            continue
        got = by_seed[s]
        assert got.ok, (s, got.error)
        assert got.result.cycles == ref.result.cycles
        assert got.result.registers == ref.result.registers
        assert got.result.outputs == ref.result.outputs
    assert stats["launch"]["bisections"] >= 1
    assert stats["launch"]["poisoned"] == 1
    # healthy riders succeeded → the identity is not quarantined
    assert stats["sessions"]["breakers"]["mc/small"]["state"] == "closed"


def test_transient_launch_fault_retried_invisibly(cache_dir):
    """times-capped transient launch faults: riders never see them."""
    plan = FaultPlan(0, launch=FaultSpec(p=1.0, times=2, transient=True))

    async def go():
        server = _server(cache_dir, faults=plan)
        try:
            return (await asyncio.gather(
                *(server.submit(_req("mc", 30 + i)) for i in range(3))),
                dict(server.launch_stats))
        finally:
            await server.close()

    resps, launch_stats = asyncio.run(go())
    assert all(r.ok and r.result.finished for r in resps), \
        [r.error for r in resps]
    assert plan.fired()["launch"] == 2
    assert launch_stats["retries"] == 2
    assert launch_stats["bisections"] == 0


def test_launch_budget_bounds_pathological_batch(cache_dir):
    """Every stimulus poisoned: bisection cannot save anyone, the launch
    budget caps device occupancy, and all riders get terminal ERRORs."""
    seeds = list(range(60, 68))
    plan = FaultPlan(0, launch=FaultSpec(poison_seeds=frozenset(seeds)))

    async def go():
        server = _server(cache_dir, faults=plan,
                         retry=RetryPolicy(max_extra_launches=4,
                                           backoff_base_s=0.001))
        try:
            resps = await asyncio.gather(
                *(server.submit(_req("mc", s)) for s in seeds))
            return resps, dict(server.launch_stats)
        finally:
            await server.close()

    resps, launch_stats = asyncio.run(go())
    assert all(r.status == ERROR for r in resps)
    assert all(r.error_code in (ERR_POISONED, "LAUNCH_FAILED")
               for r in resps)
    assert launch_stats["attempts"] <= 5          # 1 + max_extra_launches
    assert launch_stats["budget_exhausted"] >= 1


# ----------------------------------------------------------------------
# circuit breaker through the daemon
# ----------------------------------------------------------------------

def test_breaker_quarantines_failing_compile_and_recovers(cache_dir):
    """3 persistent compile faults: two requests pay a compile attempt
    (ERROR/COMPILE_FAILED), the third fast-fails UNAVAILABLE with a
    retry-after, the half-open probe re-fails and re-opens, and once the
    fault dries up the next probe compiles and the breaker closes."""
    plan = FaultPlan(0, compile=FaultSpec(p=1.0, times=3))

    async def go():
        server = _server(
            cache_dir, faults=plan,
            sessions_kw=dict(breaker_threshold=2, breaker_cooldown_s=0.1,
                             compile_retries=0))
        sm = server.sessions
        out = {}
        try:
            out["r1"] = await server.submit(_req("bc", 1))
            out["r2"] = await server.submit(_req("bc", 2))
            lookups_before = sm.counters["lookups"]
            fails_before = sm.counters["compile_failures"]
            t0 = time.monotonic()
            out["r3"] = await server.submit(_req("bc", 3))
            out["r3_elapsed"] = time.monotonic() - t0
            # no compile was attempted for the fast-fail
            assert sm.counters["compile_failures"] == fails_before
            assert sm.counters["lookups"] == lookups_before + 1
            out["open_snap"] = sm.stats()["breakers"]["bc/small"]
            await asyncio.sleep(0.12)              # past cooldown
            out["r4"] = await server.submit(_req("bc", 4))   # probe: fault 3
            out["reopen_snap"] = sm.stats()["breakers"]["bc/small"]
            await asyncio.sleep(0.25)              # doubled cooldown
            out["r5"] = await server.submit(_req("bc", 5))   # probe: healthy
            out["closed_snap"] = sm.stats()["breakers"]["bc/small"]
            return out
        finally:
            await server.close()

    out = asyncio.run(go())
    for k in ("r1", "r2", "r4"):
        assert out[k].status == ERROR and \
            out[k].error_code == ERR_COMPILE_FAILED, (k, out[k])
    assert out["r3"].status == UNAVAILABLE
    assert out["r3"].error_code == ERR_UNAVAILABLE
    assert out["r3"].retry_after_s > 0.0
    assert out["r3_elapsed"] < 0.05                # fast-fail, no compile
    assert out["open_snap"]["state"] == "open"
    assert out["reopen_snap"]["state"] == "open"
    assert out["reopen_snap"]["opens"] == 2
    assert out["r5"].ok and out["r5"].result.finished
    assert out["closed_snap"]["state"] == "closed"
    assert plan.fired()["compile"] == 3


def test_breaker_opens_on_launch_convoy(cache_dir):
    """Consecutive all-fail launches quarantine a resident session too:
    the broken build stops convoying the daemon."""
    plan = FaultPlan(0, launch=FaultSpec(p=1.0))    # every launch dies

    async def go():
        server = _server(
            cache_dir, faults=plan,
            policy=BatchPolicy(max_batch=2, max_wait_s=0.02),
            sessions_kw=dict(breaker_threshold=2, breaker_cooldown_s=5.0),
            retry=RetryPolicy(max_attempts=1, max_extra_launches=2,
                              backoff_base_s=0.001))
        try:
            r1 = await server.submit(_req("mc", 70))
            r2 = await server.submit(_req("mc", 71))
            r3 = await server.submit(_req("mc", 72))
            return r1, r2, r3, server.sessions.stats()
        finally:
            await server.close()

    r1, r2, r3, sess_stats = asyncio.run(go())
    assert r1.status == ERROR and r2.status == ERROR
    assert r3.status == UNAVAILABLE and r3.retry_after_s > 0.0
    assert sess_stats["breakers"]["mc/small"]["state"] == "open"
    assert sess_stats["counters"]["unavailable"] == 1


# ----------------------------------------------------------------------
# drain / shutdown
# ----------------------------------------------------------------------

def test_drained_close_answers_queued_riders(cache_dir):
    """Riders queued inside an open admission window are flushed and
    answered OK by close(drain=True); admission during and after the
    drain answers DRAINING."""
    async def go():
        server = _server(cache_dir,
                         policy=BatchPolicy(max_batch=8, max_wait_s=0.3))
        riders = [asyncio.ensure_future(server.submit(_req("mc", 80 + i)))
                  for i in range(3)]
        await asyncio.sleep(0.05)       # admitted, window still open
        assert not any(r.done() for r in riders)
        await server.close(drain=True)
        assert server.state == "closed"
        resps = await asyncio.gather(*riders)
        late = await server.submit(_req("mc", 99))
        return resps, late

    resps, late = asyncio.run(go())
    assert all(r.ok and r.result.finished for r in resps), \
        [r.error for r in resps]
    assert all(r.batch == 3 for r in resps)        # flushed as one batch
    assert late.status == DRAINING
    assert late.error_code == ERR_DRAINING


def test_abrupt_close_still_terminates_queued_riders(cache_dir):
    """close() without drain: queued riders get a DRAINING response
    instead of a forever-pending future."""
    async def go():
        server = _server(cache_dir,
                         policy=BatchPolicy(max_batch=8, max_wait_s=5.0))
        # ensure the session is hot so riders reach the queue instantly
        first = await asyncio.wait_for(
            asyncio.ensure_future(server.submit(_req("bc", 90))), 60)
        assert first.ok
        riders = [asyncio.ensure_future(server.submit(_req("bc", 91 + i)))
                  for i in range(3)]
        await asyncio.sleep(0.05)       # inside the 5s admission window
        await server.close()            # abrupt
        return await asyncio.wait_for(asyncio.gather(*riders), 10)

    resps = asyncio.run(go())
    assert [r.status for r in resps] == [DRAINING] * 3
    assert all(r.error_code == ERR_DRAINING for r in resps)


def test_timeout_vs_launch_race_single_resolution():
    """A rider whose deadline expires while its batch is mid-launch is
    resolved exactly once (no InvalidStateError, no double-resolve) —
    pure-batcher test with a slow launch."""
    async def go():
        resolved = []

        async def launch(key, batch):
            await asyncio.sleep(0.1)    # deadline of p2 passes in here
            for p in batch:
                if not p.future.done():
                    p.future.set_result(("ok", p.req.seed))

        def on_timeout(key, expired):
            for p in expired:
                if not p.future.done():
                    p.future.set_result(("timeout", p.req.seed))

        b = Batcher(BatchPolicy(max_batch=4, max_wait_s=0.02),
                    launch, on_timeout)
        loop = asyncio.get_running_loop()
        pend = []
        for i, deadline in enumerate([None, 0.05, None]):
            p = Pending(req=SimRequest("x", seed=i),
                        future=loop.create_future(),
                        deadline=(time.monotonic() + deadline
                                  if deadline else None))
            p.future.add_done_callback(
                lambda f: resolved.append(f.result()))
            pend.append(p)
            b.submit("k", p)
        out = await asyncio.gather(*(p.future for p in pend))
        # a second resolution attempt would raise InvalidStateError and
        # surface through the drain task / gather
        await asyncio.sleep(0.15)
        await b.close()
        return out, resolved, b.outstanding

    out, resolved, outstanding = asyncio.run(go())
    assert sorted(resolved) == sorted(out)
    assert len(resolved) == 3                      # exactly once each
    assert [s for s, _ in out] == ["ok", "ok", "ok"] or \
        ("timeout", 1) in out                      # p2 raced; either side
    assert outstanding == 0


# ----------------------------------------------------------------------
# TCP hardening
# ----------------------------------------------------------------------

def test_tcp_disconnect_mid_batch_resolves_all(cache_dir):
    """A client that pipelines requests and vanishes mid-batch must not
    kill the handler or leak outstanding work; the daemon stays healthy
    for the next client."""
    async def go():
        server = _server(cache_dir,
                         policy=BatchPolicy(max_batch=8, max_wait_s=0.2))
        try:
            tcp = await server.serve_tcp("127.0.0.1", 0)
            port = tcp.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port)
            for i in range(4):
                writer.write(encode_request(_req("mc", 300 + i)))
            await writer.drain()
            writer.close()              # vanish before any response
            try:
                await writer.wait_closed()
            except Exception:
                pass
            # wait for the orphaned batch to finish server-side
            for _ in range(400):
                if server.batcher.outstanding == 0:
                    break
                await asyncio.sleep(0.05)
            assert server.batcher.outstanding == 0
            # the daemon is still healthy for the next client
            r2, w2 = await asyncio.open_connection("127.0.0.1", port)
            w2.write(encode_request(_req("mc", 310)))
            await w2.drain()
            resp = decode_response(
                await asyncio.wait_for(r2.readline(), 60))
            w2.close()
            return resp
        finally:
            await server.close()

    resp = asyncio.run(go())
    assert resp.ok and resp.result.finished


def test_tcp_write_fault_isolated_to_connection(cache_dir):
    """An injected TCP write fault (broken pipe) kills that connection's
    writes only — the server and other connections are unaffected."""
    plan = FaultPlan(0, tcp_write=FaultSpec(p=1.0, times=1))

    async def go():
        server = _server(cache_dir, faults=plan,
                         policy=BatchPolicy(max_batch=4, max_wait_s=0.05))
        try:
            tcp = await server.serve_tcp("127.0.0.1", 0)
            port = tcp.sockets[0].getsockname()[1]
            r1, w1 = await asyncio.open_connection("127.0.0.1", port)
            w1.write(encode_request(_req("bc", 400)))
            await w1.drain()
            # the write fault eats the response: readline sees EOF/hangs,
            # bounded by the connection staying open → use a timeout
            try:
                line = await asyncio.wait_for(r1.readline(), 2.0)
            except asyncio.TimeoutError:
                line = b""
            w1.close()
            # fresh connection works (times=1 exhausted the fault)
            r2, w2 = await asyncio.open_connection("127.0.0.1", port)
            w2.write(encode_request(_req("bc", 401)))
            await w2.drain()
            resp = decode_response(
                await asyncio.wait_for(r2.readline(), 60))
            w2.close()
            return line, resp
        finally:
            await server.close()

    line, resp = asyncio.run(go())
    assert line == b""                  # first response was eaten
    assert resp.ok and resp.result.finished
    assert plan.fired()["tcp_write"] == 1


def test_tcp_inflight_cap_still_answers_everything(cache_dir):
    """A pipelined burst far above the per-connection in-flight cap is
    served completely — the cap converts task-set growth into read
    backpressure, not loss."""
    async def go():
        server = _server(cache_dir,
                         policy=BatchPolicy(max_batch=8, max_wait_s=0.05))
        server.max_inflight_per_conn = 4
        try:
            tcp = await server.serve_tcp("127.0.0.1", 0)
            port = tcp.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", port)
            n = 12
            for i in range(n):
                writer.write(encode_request(_req("mc", 500 + i)))
            await writer.drain()
            resps = []
            for _ in range(n):
                resps.append(decode_response(
                    await asyncio.wait_for(reader.readline(), 120)))
            writer.close()
            return resps
        finally:
            await server.close()

    resps = asyncio.run(go())
    assert len(resps) == 12
    assert all(r.ok and r.result.finished for r in resps)


# ----------------------------------------------------------------------
# protocol v2
# ----------------------------------------------------------------------

def test_error_code_wire_roundtrip_and_legacy_decode():
    resp = SimResponse("r1", UNAVAILABLE, error="quarantined",
                       error_code=ERR_UNAVAILABLE, retry_after_s=1.5)
    line = encode_response(resp)
    back = decode_response(line)
    assert back.status == UNAVAILABLE
    assert back.error_code == ERR_UNAVAILABLE
    assert back.retry_after_s == 1.5

    # OK responses do not put the v2 failure fields on the wire at all
    ok_line = encode_response(SimResponse("r2", OK))
    assert b"error_code" not in ok_line and b"retry_after_s" not in ok_line

    # a legacy v1 message (no error_code) decodes with the fields absent
    legacy = b'{"v": 1, "rid": "r3", "status": "error", "error": "boom"}\n'
    old = decode_response(legacy)
    assert old.status == ERROR and old.error == "boom"
    assert old.error_code is None and old.retry_after_s is None

    with pytest.raises(ValueError):
        decode_response(b'{"v": 3, "rid": "r4", "status": "ok"}\n')

    # timeouts carry their code end-to-end too
    t = decode_response(encode_response(
        SimResponse("r5", TIMEOUT, error_code=ERR_TIMEOUT)))
    assert t.error_code == ERR_TIMEOUT


# ----------------------------------------------------------------------
# mini chaos drill (the CI gate runs the big one via __main__)
# ----------------------------------------------------------------------

def test_chaos_mini_drill(cache_dir):
    """40 requests under the aggressive plan: exactly one terminal
    response each, poison isolated, healthy traffic never ERRORs, then a
    drained close."""
    plan = FaultPlan.chaos(seed=1, p=0.15, poison_seeds={666, 667})

    async def go():
        server = _server(
            cache_dir, faults=plan,
            policy=BatchPolicy(max_batch=16, max_wait_s=0.05),
            sessions_kw=dict(breaker_cooldown_s=0.2, compile_retries=6),
            retry=RetryPolicy(max_attempts=8, backoff_base_s=0.005,
                              max_extra_launches=32))
        rc = await chaos_drill(server, ["mc", "bc"], "small", 40, plan)
        await server.close(drain=True)
        return rc, server.state

    rc, state = asyncio.run(go())
    assert rc == 0
    assert state == "closed"


def test_chaos_drill_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.serve --chaos-drill 40 --scale small
    --device cpu``: every request answered exactly once, poison isolated,
    drained SIGTERM shutdown, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SIM_CACHE=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve", "--chaos-drill", "40",
         "--scale", "small", "--device", "cpu"], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "chaos drill ok" in out.stdout
