# Copy of src/repro/serve/protocol.py (commit 066216e); imports may differ.
"""Request/response protocol for the simulation service.

One :class:`SimRequest` asks for one *stimulus* of one circuit: "simulate
the canonical ``(circuit, scale)`` design with seed ``seed`` for ``cycles``
Vcycles under this hardware config and these compiler knobs". The daemon
answers with a :class:`SimResponse` wrapping the per-element
:class:`~repro.sim.result.RunResult` the batched/sharded engines already
demux, plus the serving metadata a client needs to reason about latency
(which fingerprint queue it rode, how large the coalesced launch was, how
long it waited for admission).

The dataclasses are the in-process API; ``encode_*``/``decode_*`` give the
TCP front-end a newline-delimited JSON wire form of the same objects
(``{"v": 2, ...}\\n`` per message). Unknown JSON keys are ignored on
decode and ``None``-valued fields are omitted on encode, so clients and
servers can skew by small protocol additions: a v1 client never sees the
v2 fields (``error_code``, ``retry_after_s``) unless they are set, and a
v2 server still accepts v1 requests (``SUPPORTED_VERSIONS``).

Failures are machine-readable: terminal non-OK responses carry an
``error_code`` from ``ERROR_CODES`` alongside the human ``error`` string,
so clients can branch (retry later on ``UNAVAILABLE``/``DRAINING``,
resubmit elsewhere on ``QUEUE_FULL``, give up on ``POISONED``) without
parsing ``repr(exc)`` prose. Absent ``error_code`` ⇒ a legacy (v1)
server — clients must treat it as optional.
"""
from __future__ import annotations

import json
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional, Union

from ..sim.result import RunResult

PROTOCOL_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

# response statuses
OK = "ok"                  # result carries the RunResult
REJECTED = "rejected"      # admission refused (queue full) — retry later
TIMEOUT = "timeout"        # deadline passed before the request was launched
ERROR = "error"            # request invalid or the launch raised
UNAVAILABLE = "unavailable"  # session circuit breaker open — retry after
DRAINING = "draining"      # daemon shutting down — resubmit elsewhere

# machine-readable error codes (SimResponse.error_code, protocol v2)
ERR_BAD_REQUEST = "BAD_REQUEST"          # malformed request / unknown knobs
ERR_COMPILE_FAILED = "COMPILE_FAILED"    # session compile raised
ERR_IMAGE_BUILD_FAILED = "IMAGE_BUILD_FAILED"  # stimulus image build raised
ERR_LAUNCH_FAILED = "LAUNCH_FAILED"      # engine launch raised (not isolated)
ERR_POISONED = "POISONED"                # bisection isolated this stimulus
ERR_UNAVAILABLE = "UNAVAILABLE"          # breaker open; see retry_after_s
ERR_DRAINING = "DRAINING"                # admission stopped for shutdown
ERR_TIMEOUT = "TIMEOUT"                  # deadline passed before launch
ERR_QUEUE_FULL = "QUEUE_FULL"            # backpressure rejection

ERROR_CODES = frozenset((
    ERR_BAD_REQUEST, ERR_COMPILE_FAILED, ERR_IMAGE_BUILD_FAILED,
    ERR_LAUNCH_FAILED, ERR_POISONED, ERR_UNAVAILABLE, ERR_DRAINING,
    ERR_TIMEOUT, ERR_QUEUE_FULL))


def _rid() -> str:
    return uuid.uuid4().hex[:12]


@dataclass(frozen=True)
class SimRequest:
    """One simulation stimulus.

    ``circuit``/``scale`` name the design (``repro.circuits.build``);
    ``seed`` selects the stimulus (per-seed init planes on the canonical
    structural netlist — see :mod:`repro.serve.sessions`). ``cycles`` is
    the Vcycle budget (None = the bench's self-checking budget plus
    slack). ``hw`` overrides :class:`~repro.core.isa.HardwareConfig`
    fields; ``options`` passes compiler knobs (``optimize``, ``use_luts``,
    ``strategy``, ``sched_strategy``, ``placement``, ``pipeline``).
    ``timeout`` is the admission deadline in seconds: if the request has
    not been launched by then it is answered ``TIMEOUT`` instead of
    holding the client forever.
    """

    circuit: str
    scale: str = "full"
    seed: int = 0
    cycles: Optional[int] = None
    hw: Optional[Dict[str, int]] = None
    options: Dict[str, Any] = field(default_factory=dict)
    timeout: Optional[float] = None
    rid: str = field(default_factory=_rid)


@dataclass
class SimResponse:
    """The daemon's answer to one :class:`SimRequest`.

    ``batch`` is the size of the coalesced launch this request rode in
    (the whole point of the service: many concurrent requests, one
    launch); ``wait_s`` the time from admission to launch, ``run_s`` the
    device occupancy of that launch (shared by all ``batch`` riders).

    ``error_code`` (v2) is the machine-readable failure class (one of
    ``ERROR_CODES``; None on OK and on responses from legacy servers);
    ``retry_after_s`` (v2) accompanies ``UNAVAILABLE``/``DRAINING`` —
    the earliest time a retry of this identity can be admitted.
    """

    rid: str
    status: str
    result: Optional[RunResult] = None
    error: Optional[str] = None
    error_code: Optional[str] = None
    retry_after_s: Optional[float] = None
    fingerprint: Optional[str] = None
    engine_kind: Optional[str] = None
    batch: int = 0
    wait_s: float = 0.0
    run_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == OK

    @property
    def terminal(self) -> bool:
        """Every response the daemon emits is terminal — exactly one per
        request; the property exists so drill/assert code reads clearly."""
        return self.status in (OK, REJECTED, TIMEOUT, ERROR, UNAVAILABLE,
                               DRAINING)


# ----------------------------------------------------------------------
# wire form (newline-delimited JSON)
# ----------------------------------------------------------------------

def result_to_json(r: RunResult) -> Dict[str, Any]:
    return {
        "cycles": int(r.cycles),
        # JSON object keys are strings; exception cores are ints
        "exceptions": {str(k): int(v) for k, v in r.exceptions.items()},
        "perf": {k: float(v) for k, v in r.perf.items()},
        "registers": {k: int(v) for k, v in r.registers.items()},
        "outputs": {k: int(v) for k, v in r.outputs.items()},
        "batch_index": int(r.batch_index),
    }


def result_from_json(d: Dict[str, Any]) -> RunResult:
    return RunResult(
        cycles=int(d["cycles"]),
        exceptions={int(k): int(v)
                    for k, v in d.get("exceptions", {}).items()},
        perf=dict(d.get("perf", {})),
        registers={k: int(v) for k, v in d.get("registers", {}).items()},
        outputs={k: int(v) for k, v in d.get("outputs", {}).items()},
        batch_index=int(d.get("batch_index", 0)),
    )


def _fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the keys ``cls`` knows — forward-compatible decode."""
    names = cls.__dataclass_fields__.keys()
    return {k: v for k, v in d.items() if k in names}


def _strip_none(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Omit None-valued keys on the wire: decoders default them, and a
    legacy (v1) peer never sees fields it does not know about."""
    return {k: v for k, v in doc.items() if v is not None}


def _check_version(d: Dict[str, Any]) -> None:
    v = d.pop("v", PROTOCOL_VERSION)
    if v not in SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported protocol version {v!r}")


def encode_request(req: SimRequest) -> bytes:
    doc = {"v": PROTOCOL_VERSION, **_strip_none(asdict(req))}
    return (json.dumps(doc) + "\n").encode("utf-8")


def decode_request(line: Union[str, bytes]) -> SimRequest:
    d = json.loads(line)
    _check_version(d)
    return SimRequest(**_fields(SimRequest, d))


def encode_response(resp: SimResponse) -> bytes:
    doc = {"v": PROTOCOL_VERSION, **_strip_none(asdict(resp))}
    if resp.result is not None:
        doc["result"] = result_to_json(resp.result)
    return (json.dumps(doc) + "\n").encode("utf-8")


def decode_response(line: Union[str, bytes]) -> SimResponse:
    d = json.loads(line)
    _check_version(d)
    result = d.pop("result", None)
    resp = SimResponse(**_fields(SimResponse, d))
    if result is not None:
        resp.result = result_from_json(result)
    return resp
