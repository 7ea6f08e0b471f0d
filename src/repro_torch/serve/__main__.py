"""Run the simulation daemon.

Port of ``repro.serve.__main__``, with ``--device``: the engines run on
the card by default and on the CPU with ``--device cpu`` (the kernels'
plain versions); without a card and without ``--device cpu`` the daemon
fails at start.

TCP service (newline-delimited JSON; see ``repro_torch.serve.protocol``)::

  PYTHONPATH=src python -m repro_torch.serve --host 127.0.0.1 --port 8421

SIGTERM/SIGINT trigger a **drained** shutdown: admission stops (new
requests get ``DRAINING``), queued batches flush, in-flight launches
finish, then the process exits 0.

In-process self-test (submits a few mixed requests and exits non-zero on
any failure — a deployment smoke check, no sockets needed)::

  PYTHONPATH=src python -m repro_torch.serve --self-test --scale small \
      --device cpu

Chaos drill (the fault-tolerance CI gate): serve N mixed mc+bc requests
under an aggressive :class:`~repro_torch.serve.faults.FaultPlan` (default
p=0.2 at all four sites, plus deterministic poison seeds), assert that
every request receives **exactly one terminal response**, that no
poison-free request is answered ``ERROR``, that exactly the poisoned
stimuli are isolated as ``POISONED``, and that the daemon then exits
cleanly via a drained SIGTERM::

  PYTHONPATH=src python -m repro_torch.serve --chaos-drill 500 \
      --scale small --device cpu
"""
from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
from typing import List

from .batcher import BatchPolicy
from .daemon import RetryPolicy, SimServer
from .faults import FaultPlan
from .protocol import (DRAINING, ERR_POISONED, ERROR, OK, REJECTED,
                       TIMEOUT, UNAVAILABLE, SimRequest, decode_response,
                       encode_request)
from .sessions import SessionManager


def _args() -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Manticore simulation-as-a-service daemon")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8421)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--max-sessions", type=int, default=8)
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive failures before an identity is "
                         "quarantined")
    ap.add_argument("--breaker-cooldown-s", type=float, default=1.0,
                    help="quarantine cooldown before a half-open probe")
    ap.add_argument("--cache-dir", default=None,
                    help="compile-cache directory (default: REPRO_SIM_CACHE"
                         " or ~/.cache/repro-sim)")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the on-disk compile cache")
    ap.add_argument("--self-test", action="store_true",
                    help="serve a few in-process requests and exit")
    ap.add_argument("--chaos-drill", type=int, default=0, metavar="N",
                    help="serve N requests under an aggressive fault plan,"
                         " assert the exactly-one-terminal-response"
                         " invariant, drain via SIGTERM, exit")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-plan RNG seed (drill is deterministic)")
    ap.add_argument("--chaos-p", type=float, default=0.2,
                    help="per-site fault probability for the drill")
    ap.add_argument("--circuits", default="mc,bc",
                    help="self-test/drill circuits (comma-separated)")
    ap.add_argument("--scale", default="small",
                    help="self-test/drill scale")
    ap.add_argument("--device", default=None,
                    help="torch device the engines run on (default: the "
                         "card; 'cpu' runs the kernels' plain versions)")
    return ap.parse_args()


def _server(args: argparse.Namespace, faults=None,
            breaker_cooldown_s=None) -> SimServer:
    cache = False if args.no_cache else (args.cache_dir or True)
    return SimServer(
        sessions=SessionManager(
            cache=cache, max_sessions=args.max_sessions, faults=faults,
            breaker_threshold=args.breaker_threshold,
            breaker_cooldown_s=(breaker_cooldown_s
                                if breaker_cooldown_s is not None
                                else args.breaker_cooldown_s),
            device=args.device),
        policy=BatchPolicy(max_batch=args.max_batch,
                           max_wait_s=args.max_wait_ms / 1e3,
                           max_queue=args.max_queue),
        faults=faults)


async def _self_test(server: SimServer, circuits, scale: str) -> int:
    reqs = [SimRequest(name, scale=scale, seed=100 + i)
            for name in circuits for i in range(4)]
    resps = await asyncio.gather(*(server.submit(r) for r in reqs))
    bad = [r for r in resps if not (r.ok and r.result.finished)]
    for r in resps:
        print(f"  {r.rid}: {r.status} batch={r.batch} "
              f"engine={r.engine_kind} wait={r.wait_s * 1e3:.1f}ms")
    if bad:
        print(f"self-test FAILED: {len(bad)}/{len(resps)} requests bad")
        return 1
    print(f"self-test ok: {len(resps)} requests, "
          f"{server.batcher.stats['launches']} launches")
    return 0


# ----------------------------------------------------------------------
# chaos drill
# ----------------------------------------------------------------------

POISON_SEEDS = frozenset({666, 667})


async def chaos_drill(server: SimServer, circuits: List[str], scale: str,
                      n: int, plan: FaultPlan) -> int:
    """The drill body (importable for tests): N mixed requests in bursts,
    every one must terminate exactly once, poison must be isolated to
    exactly the poisoned stimuli, then drained SIGTERM shutdown."""
    poison = sorted(plan.spec("launch").poison_seeds)
    reqs: List[SimRequest] = []
    for i in range(n):
        name = circuits[i % len(circuits)]
        # sprinkle the deterministic poison seeds through the traffic
        seed = poison[i // 50 % len(poison)] if poison and i % 50 == 7 \
            else 1000 + i
        reqs.append(SimRequest(name, scale=scale, seed=seed))

    # submit in bursts so batches form, retry UNAVAILABLE (breaker
    # quarantine is *supposed* to fast-fail us while a build is sick)
    resps = {}

    async def drive(r: SimRequest):
        for _ in range(40):
            resp = await server.submit(r)
            assert r.rid not in resps, f"double response for {r.rid}"
            if resp.status == UNAVAILABLE:
                await asyncio.sleep(max(resp.retry_after_s or 0.05, 0.05))
                continue
            resps[r.rid] = resp
            return
        resps[r.rid] = resp     # give up retrying: still terminal

    burst = 64
    for at in range(0, len(reqs), burst):
        await asyncio.gather(*(drive(r) for r in reqs[at:at + burst]))

    # exercise the TCP front-end (incl. the tcp_write fault site): the
    # server must survive write faults; lost responses are expected there
    tcp = await server.serve_tcp("127.0.0.1", 0)
    port = tcp.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    n_tcp = min(32, max(n // 8, 4))
    for i in range(n_tcp):
        writer.write(encode_request(
            SimRequest(circuits[i % len(circuits)], scale=scale,
                       seed=5000 + i)))
    await writer.drain()
    got_tcp = 0
    try:
        while got_tcp < n_tcp:
            line = await asyncio.wait_for(reader.readline(), timeout=3.0)
            if not line:
                break
            decode_response(line)
            got_tcp += 1
    except asyncio.TimeoutError:
        # a tcp_write fault marks the connection dead server-side, so
        # everything after the first fault is (correctly) never written
        pass
    writer.close()

    # ---- invariants ---------------------------------------------------
    failures: List[str] = []
    if len(resps) != n:
        failures.append(f"{n - len(resps)} requests never terminated")
    poison_set = set(poison)
    poisoned_rids = {r.rid for r in reqs if r.seed in poison_set}
    statuses = {}
    for r in reqs:
        resp = resps.get(r.rid)
        if resp is None:
            continue
        statuses[resp.status] = statuses.get(resp.status, 0) + 1
        if r.rid in poisoned_rids:
            if resp.status == ERROR and resp.error_code != ERR_POISONED:
                failures.append(
                    f"poisoned {r.rid} errored with {resp.error_code}, "
                    f"expected {ERR_POISONED}")
        elif resp.status == ERROR:
            failures.append(
                f"poison-free {r.rid} (seed {r.seed}) answered ERROR "
                f"({resp.error_code}: {resp.error})")
        elif resp.status not in (OK, REJECTED, TIMEOUT, UNAVAILABLE,
                                 DRAINING):
            failures.append(f"{r.rid}: unknown status {resp.status}")
    n_poison_err = sum(
        1 for r in reqs if r.rid in poisoned_rids
        and resps.get(r.rid) is not None
        and resps[r.rid].status == ERROR)
    if poisoned_rids and n_poison_err == 0:
        failures.append("no poisoned request was isolated as ERROR")

    stats = server.stats()
    print(f"chaos drill: {n} requests -> {statuses}; "
          f"tcp {got_tcp}/{n_tcp} responses (write faults eat the rest)")
    print(f"  launch: {stats['launch']}")
    print(f"  faults: {stats['faults']['fired']}")
    print(f"  breakers: "
          f"{ {k: v['state'] for k, v in stats['sessions']['breakers'].items()} }")
    for f in failures[:10]:
        print(f"  INVARIANT VIOLATED: {f}")
    return 1 if failures else 0


async def _run_drill(args: argparse.Namespace) -> int:
    plan = FaultPlan.chaos(seed=args.chaos_seed, p=args.chaos_p,
                           poison_seeds=POISON_SEEDS)
    # short cooldown so quarantined identities recover within the drill;
    # generous retry budget so transient storms never surface as ERROR
    server = _server(args, faults=plan, breaker_cooldown_s=0.2)
    server.retry = RetryPolicy(max_attempts=8, backoff_base_s=0.01,
                               max_extra_launches=32)
    # deep transient-retry budget: a p=0.2 storm must dry up through
    # retries, never surface as a terminal ERROR on a healthy request
    server.sessions.compile_retries = 6

    drained = asyncio.Event()
    loop = asyncio.get_running_loop()
    loop.add_signal_handler(signal.SIGTERM, drained.set)
    rc = await chaos_drill(
        server, [c for c in args.circuits.split(",") if c], args.scale,
        args.chaos_drill, plan)
    # the drill ends the way a real deployment does: SIGTERM → drain
    os.kill(os.getpid(), signal.SIGTERM)
    await asyncio.wait_for(drained.wait(), timeout=10.0)
    await server.close(drain=True)
    assert server.state == "closed"
    late = await server.submit(SimRequest("mc", scale=args.scale))
    assert late.status == DRAINING     # admission stays stopped
    print(f"chaos drill {'FAILED' if rc else 'ok'}: drained SIGTERM "
          f"shutdown clean")
    return rc


# ----------------------------------------------------------------------

async def _main() -> int:
    args = _args()
    if args.chaos_drill > 0:
        return await _run_drill(args)
    server = _server(args)
    if args.self_test:
        try:
            return await _self_test(
                server, [c for c in args.circuits.split(",") if c],
                args.scale)
        finally:
            await server.close(drain=True)
    tcp = await server.serve_tcp(args.host, args.port)
    addr = tcp.sockets[0].getsockname()
    print(f"repro_torch.serve listening on {addr[0]}:{addr[1]} "
          f"(max_batch={args.max_batch}, "
          f"max_wait={args.max_wait_ms:.0f}ms)")
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:      # non-POSIX event loop
            pass
    try:
        await stop.wait()
        print("signal received: draining (queued batches flush, "
              "in-flight launches finish) ...")
    finally:
        await server.close(drain=True)
        print("drained; exiting")
    return 0


if __name__ == "__main__":
    sys.exit(asyncio.run(_main()))
