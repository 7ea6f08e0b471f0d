# Copy of src/repro/runtime/health.py (commit 5b8f1d0); imports may differ.
"""Host-side health monitoring: heartbeats, straggler detection, restart
policy.

At 1000+ nodes the failure model is: a host stops heartbeating (hardware
loss) or its step time drifts (straggler — thermal throttle, flaky ICI
link). Both stacks here are *statically balanced* (equal shards / equal
VCPL), so any persistent per-host step-time skew is a hardware signal, not
load imbalance — which makes a simple robust-z-score detector reliable.

The monitor is pure host code (no device state); the coordinator reads
`decide()` each step and triggers checkpoint-restart (runtime/checkpoint)
with elastic resharding (runtime/elastic) when a host is evicted.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple


@dataclass
class HostHealth:
    last_beat: float
    step_times: Deque[float] = field(default_factory=lambda: deque(maxlen=64))


class HealthMonitor:
    def __init__(self, n_hosts: int, heartbeat_timeout_s: float = 60.0,
                 straggler_factor: float = 1.5, min_samples: int = 8):
        self.timeout = heartbeat_timeout_s
        self.factor = straggler_factor
        self.min_samples = min_samples
        now = time.monotonic()
        self.hosts: Dict[int, HostHealth] = {
            h: HostHealth(last_beat=now) for h in range(n_hosts)}

    def heartbeat(self, host: int, step_time_s: Optional[float] = None,
                  now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        h = self.hosts[host]
        h.last_beat = now
        if step_time_s is not None:
            h.step_times.append(step_time_s)

    # ------------------------------------------------------------------
    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout]

    def stragglers(self) -> List[Tuple[int, float]]:
        """Hosts whose median step time exceeds factor x fleet median."""
        meds = {}
        for h, st in self.hosts.items():
            if len(st.step_times) >= self.min_samples:
                s = sorted(st.step_times)
                meds[h] = s[len(s) // 2]
        if len(meds) < 2:
            return []
        fleet = sorted(meds.values())[len(meds) // 2]
        return [(h, m / fleet) for h, m in sorted(meds.items())
                if m > self.factor * fleet]

    def decide(self, now: Optional[float] = None) -> Dict:
        """Coordinator policy: evict dead hosts immediately; flag stragglers
        for drain-at-next-checkpoint (cheaper than an instant restart)."""
        dead = self.dead_hosts(now)
        strag = self.stragglers()
        return {
            "evict_now": dead,
            "drain_at_checkpoint": [h for h, _ in strag],
            "action": ("restart_elastic" if dead else
                       "drain" if strag else "healthy"),
        }
