"""The traced run: the card's activity from ``torch.profiler``, reduced.

Only CUDA activity is recorded (kernels, copies, fills); the host's side
is the harness's own spans (``images``, ``rebind``, ``run_batch``), kept
by the driver on the host clock and moved onto the profiler's clock.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

import numpy as np

CHUNK_KERNEL = "vcycle_chunk"
SPANS = ("images", "rebind", "run_batch")
TOP = 10


def start(devices):
    """A profiler recording the cards' activity, started (None on the
    CPU, where there is no card to trace)."""
    from torch.profiler import ProfilerActivity, profile
    if not devices[0].startswith("cuda"):
        return None
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof, run) -> "Trace":
    import torch
    from torch.autograd import DeviceType
    for d in dict.fromkeys(run.devices):
        torch.cuda.synchronize(d)
    prof.stop()
    w0, w1 = (t + run.epoch_ns for t in run.window)
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        if t > w0 and s < w1:
            events.append((e.device_index(), e.name(), max(s, w0),
                           min(t, w1)))
    return Trace(events, w0, w1, len(dict.fromkeys(run.devices)),
                 {k: [(a + run.epoch_ns, b + run.epoch_ns)
                      for a, b in run.spans(k)] for k in SPANS})


class Trace:
    """Device intervals ``(device, name, start_ns, end_ns)`` inside the
    window ``[w0, w1]``, and the host's spans on the same clock."""

    def __init__(self, events, w0: int, w1: int, n_devices: int,
                 spans: Dict[str, list]):
        self.events, self.w0, self.w1 = events, w0, w1
        self.n_devices, self.spans = n_devices, spans

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def _busy(self, dev) -> np.ndarray:
        """The union of device ``dev``'s activity: ``[k, 2]`` intervals."""
        iv = sorted((s, t) for d, _, s, t in self.events if d == dev)
        out: List[list] = []
        for s, t in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return np.asarray(out, np.int64).reshape(-1, 2)

    def devices(self):
        return sorted({d for d, *_ in self.events})

    def busy_s(self) -> float:
        """Seconds with an operation on the device, the mean over the
        run's devices (one with no activity counts 0)."""
        tot = sum(float((b[:, 1] - b[:, 0]).sum())
                  for b in map(self._busy, self.devices()))
        return tot / 1e9 / self.n_devices

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def chunks(self, dev) -> np.ndarray:
        """Device ``dev``'s chunk kernels, ``[k, 2]`` in start order."""
        iv = sorted((s, t) for d, n, s, t in self.events
                    if d == dev and CHUNK_KERNEL in n)
        return np.asarray(iv, np.int64).reshape(-1, 2)

    def chunk_s(self) -> float:
        """Device seconds of the chunk kernels, summed over devices."""
        return sum(float((c[:, 1] - c[:, 0]).sum())
                   for c in map(self.chunks, self.devices())) / 1e9

    def chunk_launches(self) -> int:
        return sum(len(self.chunks(d)) for d in self.devices())

    def chunk_gaps_ns(self) -> np.ndarray:
        """Idle gaps between consecutive chunk kernels of one device that
        start inside the same ``run_batch`` span."""
        runs = np.asarray(self.spans["run_batch"], np.int64).reshape(-1, 2)
        out = []
        for d in self.devices():
            c = self.chunks(d)
            if len(c) < 2 or not len(runs):
                continue
            i = np.searchsorted(runs[:, 0], c[:, 0], side="right") - 1
            inside = (i >= 0) & (c[:, 0] < runs[np.maximum(i, 0), 1])
            same = inside[1:] & inside[:-1] & (i[1:] == i[:-1])
            out.append((c[1:, 0] - c[:-1, 1])[same])
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def idle_by_span(self) -> Dict[str, float]:
        """Seconds the device was idle, by the span the host was in
        (``other`` outside them), summed over devices."""
        out: Dict[str, float] = defaultdict(float)
        for d in range(self.n_devices):
            b = self._busy(d) if d in self.devices() \
                else np.zeros((0, 2), np.int64)
            edges = np.concatenate([[self.w0], b.reshape(-1), [self.w1]])
            gaps = edges.reshape(-1, 2)
            gaps = gaps[gaps[:, 1] > gaps[:, 0]]
            total = float((gaps[:, 1] - gaps[:, 0]).sum())
            covered = 0.0
            for name, spans in self.spans.items():
                for s, t in spans:
                    ov = np.minimum(gaps[:, 1], t) - np.maximum(gaps[:, 0], s)
                    v = float(ov[ov > 0].sum())
                    out[name] += v / 1e9
                    covered += v
            out["other"] += (total - covered) / 1e9
        return dict(out)

    def top_ops(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for _, n, s, t in self.events:
            out[n] += (t - s) / 1e9
        return dict(out)

    def breakdown(self, run) -> dict:
        def top(d):
            items = sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
            return [[_short(k), v] for k, v in items]
        return {"device_ops": top(self.top_ops()),
                "idle_gaps": top(self.idle_by_span())}


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.-]", "_", name)[:64]
