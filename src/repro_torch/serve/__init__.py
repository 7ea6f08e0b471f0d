"""Simulation-as-a-service: a long-lived daemon with dynamic batching.

Port of ``repro.serve``, with the same exports. ``protocol``, ``batcher``
and ``faults`` are copies; ``sessions``, ``daemon`` and ``__main__`` take
a ``device`` (the card by default, ``"cpu"`` for the kernels' plain
versions). The wire protocol is the reference's, so a client of either
package talks to a daemon of the other.

Five cooperating layers turn the one-shot ``repro_torch.sim`` facade into
a serving system (the ROADMAP's "millions of users" item — the inference-
server shape applied to RTL simulation):

* :mod:`~repro_torch.serve.protocol` — :class:`SimRequest`/
  :class:`SimResponse` dataclasses plus their newline-delimited-JSON wire
  form, including the machine-readable failure taxonomy
  (``SimResponse.error_code``);
* :mod:`~repro_torch.serve.batcher` — per-fingerprint queues with a
  max-batch/max-wait admission policy, deadline timeouts, queue-depth
  backpressure, and a drain/abort shutdown contract (every admitted
  request resolves exactly once);
* :mod:`~repro_torch.serve.sessions` — an LRU of hot compiled
  ``Simulation``s keyed by ``Circuit.fingerprint()`` + hardware +
  compiler knobs, warm-started through the on-disk compile cache, with
  per-identity :class:`CircuitBreaker` quarantine of failing builds;
* :mod:`~repro_torch.serve.faults` — a deterministic, seedable
  fault-injection harness (:class:`FaultPlan`) armed at the four
  recovery sites (compile, image build, engine launch, TCP write) so
  every failure path is testable and CI-drillable;
* :mod:`~repro_torch.serve.daemon` — :class:`SimServer`, coalescing
  concurrent same-fingerprint requests into one batched launch and
  demuxing per-request results, with poison-isolating bisection retry
  (:class:`RetryPolicy`) and graceful drain; in-process
  ``await server.submit(req)`` and a TCP front-end
  (``python -m repro_torch.serve``; ``--chaos-drill N`` runs the fault
  drill).

See ``docs/serving.md`` for the architecture, failure model, and tuning
guide, and ``benchmarks/bench_serve.py`` for the load benchmark
(coalesced dynamic batching vs sequential B=1, plus the hardened-but-
fault-free arm showing the recovery machinery costs ~nothing when idle).
"""
from .batcher import BatchPolicy, Batcher, Pending, Rejected
from .daemon import RetryPolicy, SimServer
from .faults import (COMPILE, IMAGE_BUILD, LAUNCH, SITES, TCP_WRITE,
                     FaultPlan, FaultSpec, InjectedFault)
from .protocol import (DRAINING, ERR_BAD_REQUEST, ERR_COMPILE_FAILED,
                       ERR_DRAINING, ERR_IMAGE_BUILD_FAILED,
                       ERR_LAUNCH_FAILED, ERR_POISONED, ERR_QUEUE_FULL,
                       ERR_TIMEOUT, ERR_UNAVAILABLE, ERROR, ERROR_CODES,
                       OK, REJECTED, TIMEOUT, UNAVAILABLE, SimRequest,
                       SimResponse, decode_request, decode_response,
                       encode_request, encode_response)
from .sessions import (CANONICAL_SEED, CircuitBreaker, CompileFailed,
                       Session, SessionKey, SessionManager, Unavailable)

__all__ = [
    "BatchPolicy", "Batcher", "Pending", "Rejected", "SimServer",
    "RetryPolicy", "SimRequest", "SimResponse",
    "OK", "REJECTED", "TIMEOUT", "ERROR", "UNAVAILABLE", "DRAINING",
    "ERROR_CODES", "ERR_BAD_REQUEST", "ERR_COMPILE_FAILED",
    "ERR_IMAGE_BUILD_FAILED", "ERR_LAUNCH_FAILED", "ERR_POISONED",
    "ERR_UNAVAILABLE", "ERR_DRAINING", "ERR_TIMEOUT", "ERR_QUEUE_FULL",
    "encode_request", "decode_request", "encode_response",
    "decode_response", "CANONICAL_SEED", "Session", "SessionKey",
    "SessionManager", "CircuitBreaker", "Unavailable", "CompileFailed",
    "FaultPlan", "FaultSpec", "InjectedFault",
    "COMPILE", "IMAGE_BUILD", "LAUNCH", "TCP_WRITE", "SITES",
]
