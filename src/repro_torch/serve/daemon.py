"""The simulation daemon: hot Simulations + dynamic batching + front-ends.

Port of ``repro.serve.daemon``. What changed is the device:
``SimServer(device=...)`` hands it to the :class:`SessionManager` it
builds (the card by default, raising at construction without one;
``device="cpu"`` runs the kernels' plain versions). Launches run on worker
threads under the device lock, one at a time, as in the reference. Each
successful launch also adds its stages' seconds to ``stats()["stages"]``.

:class:`SimServer` wires the lower layers together:

* :mod:`repro_torch.serve.sessions` keeps compiled ``Simulation``s resident
  (LRU, warm-started through the on-disk compile cache) and quarantines
  failing identities behind per-identity circuit breakers;
* :mod:`repro_torch.serve.batcher` coalesces concurrent requests that share a
  ``(session, cycle budget)`` key — i.e. one circuit fingerprint + hw +
  knobs — into one batched launch;
* :mod:`repro_torch.serve.protocol` is the request/response shape, in-process
  and over TCP (newline-delimited JSON);
* :mod:`repro_torch.serve.faults` injects deterministic failures at the four
  recovery sites so every path below is drillable (zero overhead when
  ``faults=None``).

A coalesced launch builds the per-seed init planes (host-side netlist
rebuild anchored on the canonical seed, memoized per seed), stacks them
host-parallel (``Program.init_images_batch``), picks the engine through
the facade's auto-selection (``Simulation.select_engine_kind``: the
sharded engine for B >= 2*D on a host with D > 1 cards, the batched one
otherwise), runs it on a worker thread under the device lock, and demuxes the
per-element :class:`~repro_torch.sim.result.RunResult`\\ s back to their
riders.

**Fault tolerance.** A failed batched launch no longer errors all its
riders. The daemon distinguishes:

* *transient* failures (``InjectedFault(transient=True)``, or anything a
  deployment marks as such): the identical group is retried under an
  exponential-backoff budget (:class:`RetryPolicy`);
* *persistent* failures of a multi-rider group: **bounded bisection** —
  split the seed list in half and launch each half independently, so
  healthy riders still get ``OK`` and only the isolated culprit gets
  ``ERROR``/``POISONED``. The total number of launches per original
  batch is capped (``max_extra_launches``), so a pathological batch
  cannot occupy the device unboundedly;
* launch outcomes feed the session's circuit breaker: a launch where at
  least one sub-group succeeded counts as a success (poison isolation
  must not quarantine a healthy build), an all-fail launch counts as a
  failure.

**Drain.** ``close(drain=True)`` stops admission (new submissions get a
``DRAINING`` response), flushes already-queued batches, waits for
in-flight launches, then tears down — every admitted request still gets
exactly one terminal response. ``close()`` without drain aborts queued
riders with ``DRAINING`` responses rather than abandoning their futures.

In-process use::

    server = SimServer(policy=BatchPolicy(max_batch=64, max_wait_s=0.02))
    resp = await server.submit(SimRequest("mc", scale="small", seed=7))
    assert resp.ok and resp.result.finished

TCP use: ``python -m repro_torch.serve --port 8421`` (see ``__main__.py``),
clients write one request JSON per line and read one response per line
(responses may interleave across a pipelined connection; match on
``rid``).
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Dict, Hashable, List, Optional, Tuple

from . import faults as faultlib
from .batcher import BatchPolicy, Batcher, Pending, Rejected
from .protocol import (DRAINING, ERR_BAD_REQUEST, ERR_COMPILE_FAILED,
                       ERR_DRAINING, ERR_IMAGE_BUILD_FAILED,
                       ERR_LAUNCH_FAILED, ERR_POISONED, ERR_QUEUE_FULL,
                       ERR_TIMEOUT, ERR_UNAVAILABLE, ERROR, OK, REJECTED,
                       TIMEOUT, UNAVAILABLE, SimRequest, SimResponse,
                       decode_request, encode_response)
from .sessions import CompileFailed, Session, SessionManager, Unavailable

# per-connection cap on in-flight pipelined requests: a client that
# floods one socket stalls (backpressure) instead of growing the task set
MAX_INFLIGHT_PER_CONN = 256


@dataclass(frozen=True)
class RetryPolicy:
    """Recovery budget for one coalesced batch.

    ``max_attempts`` bounds identical-group retries of *transient*
    failures (exponential backoff from ``backoff_base_s`` capped at
    ``backoff_max_s``); ``max_extra_launches`` bounds the total extra
    device launches (retries + bisection probes) one original batch may
    spend before its unresolved riders are failed outright.
    """
    max_attempts: int = 4
    backoff_base_s: float = 0.02
    backoff_max_s: float = 0.5
    max_extra_launches: int = 16


class _LaunchError(Exception):
    """Internal: one failed launch attempt, classified by stage."""

    def __init__(self, code: str, cause: BaseException):
        super().__init__(repr(cause))
        self.code = code
        self.cause = cause
        self.transient = bool(getattr(cause, "transient", False))


class SimServer:
    """Long-lived serving daemon over the ``repro_torch.sim`` facade.

    ``device`` is where the :class:`SessionManager` built here runs its
    engines (the card when None); a ``sessions`` passed in keeps its own."""

    def __init__(self, *, sessions: Optional[SessionManager] = None,
                 policy: Optional[BatchPolicy] = None, cache=True,
                 image_workers: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 faults: Optional[faultlib.FaultPlan] = None,
                 max_inflight_per_conn: int = MAX_INFLIGHT_PER_CONN,
                 device=None):
        self.faults = faults
        self.sessions = sessions if sessions is not None \
            else SessionManager(cache=cache, faults=faults, device=device)
        if faults is not None and self.sessions.faults is None:
            self.sessions.faults = faults
        self.policy = policy if policy is not None else BatchPolicy()
        self.retry = retry if retry is not None else RetryPolicy()
        self.batcher = Batcher(self.policy, self._launch, self._timeout,
                               self._abort)
        self.image_workers = image_workers
        self.max_inflight_per_conn = int(max_inflight_per_conn)
        # one launch on the device at a time: the engines are synchronous
        # and the device is a shared resource; admission keeps queueing
        # fair while a launch is in flight
        self._device_lock = asyncio.Lock()
        self._tcp_server: Optional[asyncio.base_events.Server] = None
        self._state = "serving"        # serving | draining | closed
        self.launch_stats: Dict[str, int] = {
            "attempts": 0, "retries": 0, "bisections": 0, "poisoned": 0,
            "failed_groups": 0, "budget_exhausted": 0}
        # where the successful launches' time went, summed: host images
        # (before ``run_s``), then within ``run_s`` the engine (a rebind
        # of the hot one, or a build for a new batch size), the chunks
        # and the per-element snapshots
        self.stage_stats: Dict[str, float] = {
            "launches": 0, "images_s": 0.0, "engine_s": 0.0,
            "engines_built": 0, "chunks_s": 0.0, "snapshots_s": 0.0}

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        return self._state

    def stats(self) -> Dict[str, Any]:
        """One snapshot across all layers (drill/dashboard surface)."""
        out: Dict[str, Any] = {
            "state": self._state,
            "batcher": dict(self.batcher.stats),
            "launch": dict(self.launch_stats),
            "stages": dict(self.stage_stats),
            "sessions": self.sessions.stats(),
        }
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        return out

    # ------------------------------------------------------------------
    # in-process front-end
    # ------------------------------------------------------------------
    async def submit(self, req: SimRequest) -> SimResponse:
        """Serve one request end-to-end: resolve (or compile) its
        session, enqueue it for coalescing, await its demuxed result.
        Exactly one terminal response per request, always."""
        if self._state != "serving":
            return SimResponse(
                req.rid, DRAINING, error="daemon is draining; resubmit "
                "to another instance", error_code=ERR_DRAINING)
        try:
            session = await self.sessions.get(req)
        except Unavailable as exc:
            return SimResponse(
                req.rid, UNAVAILABLE, error=str(exc),
                error_code=ERR_UNAVAILABLE,
                retry_after_s=exc.retry_after)
        except CompileFailed as exc:
            return SimResponse(req.rid, ERROR, error=str(exc),
                               error_code=ERR_COMPILE_FAILED)
        except (KeyError, ValueError, TypeError) as exc:
            return SimResponse(req.rid, ERROR, error=str(exc),
                               error_code=ERR_BAD_REQUEST)
        try:
            cycles = int(req.cycles) if req.cycles is not None \
                else session.default_cycles()
        except ValueError as exc:
            return SimResponse(req.rid, ERROR, error=str(exc),
                               error_code=ERR_BAD_REQUEST,
                               fingerprint=session.fingerprint)
        pending = Pending(
            req=req,
            future=asyncio.get_running_loop().create_future(),
            session=session,
            deadline=(time.monotonic() + req.timeout
                      if req.timeout is not None else None))
        key: Tuple[Hashable, int] = (session.key, cycles)
        try:
            self.batcher.submit(key, pending)
        except Rejected as exc:
            return SimResponse(req.rid, REJECTED, error=str(exc),
                               error_code=ERR_QUEUE_FULL,
                               fingerprint=session.fingerprint)
        return await pending.future

    # ------------------------------------------------------------------
    # batcher callbacks
    # ------------------------------------------------------------------
    def _timeout(self, key: Hashable, expired: List[Pending]) -> None:
        for p in expired:
            if not p.future.done():
                p.future.set_result(SimResponse(
                    p.req.rid, TIMEOUT,
                    error="deadline passed before launch",
                    error_code=ERR_TIMEOUT,
                    fingerprint=p.session.fingerprint,
                    wait_s=time.monotonic() - p.enqueued))

    def _abort(self, key: Hashable, pendings: List[Pending]) -> None:
        """Abrupt close: queued riders still get a terminal response."""
        for p in pendings:
            if not p.future.done():
                p.future.set_result(SimResponse(
                    p.req.rid, DRAINING,
                    error="daemon closed before launch",
                    error_code=ERR_DRAINING,
                    fingerprint=p.session.fingerprint))

    # ------------------------------------------------------------------
    # launch path: attempt → retry (transient) → bisect (persistent)
    # ------------------------------------------------------------------
    async def _launch(self, key: Hashable, batch: List[Pending]) -> None:
        """Execute one coalesced batch, isolating failures so healthy
        riders still get their results; feed the session breaker."""
        session: Session = batch[0].session
        cycles: int = key[1]
        # launches the whole original batch may still spend (first
        # attempt + retries + bisection probes)
        budget = [1 + self.retry.max_extra_launches]
        any_ok = await self._run_group(session, cycles, batch, budget,
                                       isolated=False)
        if session.breaker is not None:
            if any_ok:
                session.breaker.record_success()
            else:
                session.breaker.record_failure()

    async def _run_group(self, session: Session, cycles: int,
                         group: List[Pending], budget: List[int],
                         isolated: bool) -> bool:
        """Run ``group`` (retrying/bisecting as needed); resolve every
        unresolved rider in it; return True iff any launch succeeded."""
        delay = self.retry.backoff_base_s
        attempt = 0
        while True:
            live = [p for p in group if not p.future.done()]
            if not live:
                return True     # nothing left to prove (all timed out)
            if budget[0] <= 0:
                self.launch_stats["budget_exhausted"] += 1
                self._fail_group(live, ERR_LAUNCH_FAILED,
                                 "retry budget exhausted", session)
                return False
            budget[0] -= 1
            try:
                results, kind, run_s, launched = await self._attempt(
                    session, cycles, live)
            except _LaunchError as err:
                attempt += 1
                if err.transient and attempt < self.retry.max_attempts \
                        and budget[0] > 0:
                    self.launch_stats["retries"] += 1
                    await asyncio.sleep(delay)
                    delay = min(delay * 2, self.retry.backoff_max_s)
                    continue
                if len(live) > 1 and budget[0] > 0:
                    # persistent failure of a multi-rider group: bisect
                    # to isolate the culprit, healthy halves still serve
                    self.launch_stats["bisections"] += 1
                    mid = len(live) // 2
                    ok_lo = await self._run_group(
                        session, cycles, live[:mid], budget, True)
                    ok_hi = await self._run_group(
                        session, cycles, live[mid:], budget, True)
                    return ok_lo or ok_hi
                code = ERR_POISONED if (
                    (isolated and len(live) == 1)
                    or getattr(err.cause, "poisoned", ())) else err.code
                if code == ERR_POISONED:
                    self.launch_stats["poisoned"] += len(live)
                self._fail_group(live, code, str(err), session)
                return False
            else:
                for i, p in enumerate(live):
                    if not p.future.done():
                        p.future.set_result(SimResponse(
                            p.req.rid, OK, result=results[i],
                            fingerprint=session.fingerprint,
                            engine_kind=kind, batch=len(live),
                            wait_s=launched - p.enqueued, run_s=run_s))
                return True

    async def _attempt(self, session: Session, cycles: int,
                       group: List[Pending]):
        """One device launch of ``group``; raises :class:`_LaunchError`
        classified by stage (image build vs engine launch)."""
        self.launch_stats["attempts"] += 1
        seeds = [p.req.seed for p in group]
        t0 = time.monotonic()
        try:
            if self.faults is not None:
                self.faults.check(faultlib.IMAGE_BUILD, seeds=seeds)
            images = await asyncio.to_thread(
                session.images_for, seeds, self.image_workers)
        except Exception as exc:
            raise _LaunchError(ERR_IMAGE_BUILD_FAILED, exc) from exc
        images_s = time.monotonic() - t0
        kind = session.sim.select_engine_kind(len(group))
        if kind == "machine":
            kind = "batched"       # B=1 runs on the batched binding too
        async with self._device_lock:
            launched = time.monotonic()
            try:
                if self.faults is not None:
                    self.faults.check(faultlib.LAUNCH, seeds=seeds)
                built = session.engines_built
                engine = await asyncio.to_thread(
                    session.engine_for, kind, images)
                bound = time.monotonic()
                results = await asyncio.to_thread(
                    engine.run_batch, cycles)
            except Exception as exc:
                raise _LaunchError(ERR_LAUNCH_FAILED, exc) from exc
            done = time.monotonic()
            run_s = done - launched
        st = self.stage_stats
        st["launches"] += 1
        st["images_s"] += images_s
        st["engine_s"] += bound - launched
        st["engines_built"] += session.engines_built - built
        st["chunks_s"] += engine.chunks_s
        st["snapshots_s"] += done - bound - engine.chunks_s
        session.touch()
        session.launches += 1
        return results, kind, run_s, launched

    def _fail_group(self, group: List[Pending], code: str, msg: str,
                    session: Session) -> None:
        self.launch_stats["failed_groups"] += 1
        for p in group:
            if not p.future.done():
                p.future.set_result(SimResponse(
                    p.req.rid, ERROR, error=msg, error_code=code,
                    fingerprint=session.fingerprint))

    # ------------------------------------------------------------------
    # TCP front-end (newline-delimited JSON, pipelined per connection)
    # ------------------------------------------------------------------
    async def serve_tcp(self, host: str = "127.0.0.1",
                        port: int = 8421) -> asyncio.base_events.Server:
        self._tcp_server = await asyncio.start_server(
            self._client, host, port)
        return self._tcp_server

    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        wlock = asyncio.Lock()
        tasks: set = set()
        dead = False      # writer unusable (client gone / write fault)

        async def one(line: bytes) -> None:
            nonlocal dead
            try:
                req = decode_request(line)
            except Exception as exc:
                resp = SimResponse("?", ERROR,
                                   error=f"bad request: {exc!r}",
                                   error_code=ERR_BAD_REQUEST)
            else:
                resp = await self.submit(req)
            if dead:
                return
            async with wlock:
                if dead:
                    return
                try:
                    if self.faults is not None:
                        self.faults.check(faultlib.TCP_WRITE)
                    writer.write(encode_response(resp))
                    await writer.drain()
                except Exception:
                    # client disconnected mid-response (or injected
                    # broken pipe): the connection is dead; the server —
                    # and this handler's remaining tasks — must not be
                    dead = True

        try:
            while True:
                if len(tasks) >= self.max_inflight_per_conn:
                    await asyncio.wait(set(tasks),
                                       return_when=asyncio.FIRST_COMPLETED)
                line = await reader.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                t = asyncio.get_running_loop().create_task(one(line))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            if tasks:
                # client closed its write side (or vanished): finish the
                # in-flight requests so every admitted rider resolves
                await asyncio.gather(*list(tasks), return_exceptions=True)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------------
    async def close(self, drain: bool = False) -> None:
        """Shut down. ``drain=True``: stop admission (new submissions
        answered ``DRAINING``), flush queued batches and finish in-flight
        launches, then tear down — every admitted request gets its
        terminal response. ``drain=False``: abrupt, but queued riders
        are still answered ``DRAINING`` instead of abandoned."""
        if self._state == "closed":
            return
        self._state = "draining"
        if self._tcp_server is not None:
            self._tcp_server.close()
            try:
                # py>=3.12 wait_closed() also waits for open connection
                # handlers; an idle client must not wedge shutdown
                await asyncio.wait_for(self._tcp_server.wait_closed(),
                                       timeout=5.0)
            except asyncio.TimeoutError:
                pass
            self._tcp_server = None
        if drain:
            await self.batcher.drain()
        await self.batcher.close()
        self._state = "closed"
