# Copy of src/repro/serve/batcher.py (commit 066216e); imports may differ.
"""Fingerprint-keyed dynamic batching: many requests, one launch.

The inference-server shape (continuous/dynamic batching) applied to RTL
simulation: requests land on per-key queues — one key per ``(session,
cycle budget)``, i.e. per compiled Program that could execute them in one
batched launch — and a drain task per key assembles batches under a
**max-batch / max-wait admission policy**:

* the first request of a batch opens a window of ``max_wait_s``;
* the batch launches as soon as ``max_batch`` riders arrived, or when the
  window closes, whichever is first (``max_wait_s`` bounds the latency
  cost of coalescing; ``max_batch`` bounds device memory);
* a queue deeper than ``max_queue`` refuses admission
  (:class:`Rejected` → the daemon answers ``REJECTED``: explicit
  backpressure beats unbounded queueing);
* each request may carry a deadline; requests whose deadline passed by
  launch time are answered ``TIMEOUT`` and never occupy a batch slot.

``max_batch=1`` degenerates to sequential per-request launches — the
baseline :mod:`benchmarks.bench_serve` measures coalescing against.

**Shutdown contract.** Every admitted :class:`Pending` resolves exactly
once, even across shutdown: the batcher counts outstanding admitted
requests (decremented by a done-callback on each future, so the count is
correct no matter *who* resolves it — launch, timeout, or abort) and

* :meth:`Batcher.drain` (graceful): stop opening new admission windows,
  flush already-queued requests into launches, and return once every
  outstanding future has resolved — the daemon's ``close(drain=True)``
  path;
* :meth:`Batcher.close` (abrupt): cancel drain tasks and hand any
  still-unresolved requests — queued or mid-formation — to the
  ``on_abort`` callback so no rider ever hangs on an abandoned future.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Hashable, List, Optional

from .protocol import SimRequest


@dataclass
class BatchPolicy:
    """Admission policy knobs (see module docstring and docs/serving.md)."""
    max_batch: int = 64       # riders per coalesced launch
    max_wait_s: float = 0.02  # window the first rider holds open
    max_queue: int = 256      # per-key depth before admission refuses


class Rejected(Exception):
    """Admission refused: the key's queue is at ``max_queue``."""


@dataclass
class Pending:
    """One enqueued request: the future the submitter awaits plus the
    timing/admission metadata the drain loop needs."""
    req: SimRequest
    future: "asyncio.Future[Any]"
    session: Any = None
    enqueued: float = field(default_factory=time.monotonic)
    deadline: Optional[float] = None    # monotonic; None = wait forever

    @property
    def expired(self) -> bool:
        return self.deadline is not None \
            and time.monotonic() >= self.deadline


LaunchFn = Callable[[Hashable, List[Pending]], Awaitable[None]]
TimeoutFn = Callable[[Hashable, List[Pending]], None]
AbortFn = Callable[[Hashable, List[Pending]], None]


class Batcher:
    """Per-key queues + drain tasks feeding an async ``launch`` callable.

    ``launch(key, batch)`` receives only live (non-expired) requests and
    must resolve every ``Pending.future``; ``on_timeout(key, expired)``
    (if given) resolves the requests dropped at admission time;
    ``on_abort(key, pendings)`` (if given) resolves requests the batcher
    had to give up on at :meth:`close` time — otherwise their futures
    get a ``RuntimeError``.
    """

    def __init__(self, policy: BatchPolicy, launch: LaunchFn,
                 on_timeout: Optional[TimeoutFn] = None,
                 on_abort: Optional[AbortFn] = None):
        self.policy = policy
        self._launch = launch
        self._on_timeout = on_timeout
        self._on_abort = on_abort
        self._queues: Dict[Hashable, asyncio.Queue] = {}
        self._tasks: Dict[Hashable, asyncio.Task] = {}
        self._draining = False
        # admitted requests whose future has not resolved yet; the done
        # callback attached at submit() keeps it exact regardless of who
        # resolves the future (launch, timeout, abort)
        self._outstanding = 0
        self.stats: Dict[str, int] = {
            "submitted": 0, "rejected": 0, "timed_out": 0,
            "launches": 0, "launched_requests": 0, "max_seen_batch": 0,
            "aborted": 0}

    # ------------------------------------------------------------------
    @property
    def outstanding(self) -> int:
        return self._outstanding

    @property
    def draining(self) -> bool:
        return self._draining

    def submit(self, key: Hashable, pending: Pending) -> None:
        """Admit ``pending`` onto ``key``'s queue (creating its drain
        task on first use) or raise :class:`Rejected`."""
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = asyncio.Queue()
            self._tasks[key] = asyncio.get_running_loop().create_task(
                self._drain(key, q))
        if q.qsize() >= self.policy.max_queue:
            self.stats["rejected"] += 1
            raise Rejected(
                f"queue for {key!r} is full "
                f"({self.policy.max_queue} pending)")
        self.stats["submitted"] += 1
        self._outstanding += 1
        pending.future.add_done_callback(self._resolved)
        q.put_nowait(pending)

    def _resolved(self, _future) -> None:
        self._outstanding -= 1

    async def _drain(self, key: Hashable, q: asyncio.Queue) -> None:
        pol = self.policy
        batch: List[Pending] = []
        try:
            while True:
                batch = [await q.get()]
                if not self._draining:
                    window_ends = time.monotonic() + pol.max_wait_s
                    while len(batch) < pol.max_batch:
                        remaining = window_ends - time.monotonic()
                        if self._draining or remaining <= 0:
                            # window closed (or flushing): take whatever
                            # already queued, no wait
                            try:
                                batch.append(q.get_nowait())
                                continue
                            except asyncio.QueueEmpty:
                                break
                        try:
                            batch.append(
                                await asyncio.wait_for(q.get(), remaining))
                        except asyncio.TimeoutError:
                            break
                else:
                    # draining: no admission window, flush what's queued
                    while len(batch) < pol.max_batch:
                        try:
                            batch.append(q.get_nowait())
                        except asyncio.QueueEmpty:
                            break
                live = [p for p in batch if not p.expired]
                dead = [p for p in batch if p.expired]
                if dead:
                    self.stats["timed_out"] += len(dead)
                    if self._on_timeout is not None:
                        self._on_timeout(key, dead)
                if not live:
                    batch = []
                    continue
                self.stats["launches"] += 1
                self.stats["launched_requests"] += len(live)
                self.stats["max_seen_batch"] = max(
                    self.stats["max_seen_batch"], len(live))
                try:
                    await self._launch(key, live)
                except Exception as exc:   # launch() should not raise, but
                    for p in live:         # a rider must never hang on it
                        if not p.future.done():
                            p.future.set_exception(
                                RuntimeError(f"launch failed: {exc!r}"))
                batch = []
        except asyncio.CancelledError:
            # abrupt close mid-formation or mid-launch: the current
            # batch's unresolved riders must still terminate
            self._abort(key, batch)
            raise

    # ------------------------------------------------------------------
    def _abort(self, key: Hashable, pendings: List[Pending]) -> None:
        undone = [p for p in pendings if not p.future.done()]
        if not undone:
            return
        self.stats["aborted"] += len(undone)
        if self._on_abort is not None:
            self._on_abort(key, undone)
        for p in undone:
            if not p.future.done():
                p.future.set_exception(
                    RuntimeError("batcher closed before launch"))

    def depth(self, key: Hashable) -> int:
        q = self._queues.get(key)
        return q.qsize() if q is not None else 0

    async def drain(self, poll_s: float = 0.005) -> None:
        """Graceful flush: stop opening admission windows (queued
        requests launch immediately in max_batch groups) and return once
        every admitted request has resolved. New submissions remain
        possible — the daemon stops admission at its layer first."""
        self._draining = True
        while self._outstanding > 0:
            await asyncio.sleep(poll_s)

    async def close(self) -> None:
        """Cancel every drain task; unresolved requests (queued or in a
        forming batch) are aborted via ``on_abort`` — nothing hangs."""
        for t in self._tasks.values():
            t.cancel()
        for t in self._tasks.values():
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        for key, q in self._queues.items():
            leftovers: List[Pending] = []
            while not q.empty():
                leftovers.append(q.get_nowait())
            self._abort(key, leftovers)
        self._tasks.clear()
        self._queues.clear()
