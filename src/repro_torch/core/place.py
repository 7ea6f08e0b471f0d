# Copy of src/repro/core/place.py (commit aa57dc1); imports may differ.
"""Communication-aware process placement: chatty processes on adjacent cores.

The partitioner assigns processes to grid cores in identity order, so every
SEND route is an accident of construction order. On the uni-directional 2D
torus that is expensive twice over: long dimension-ordered routes occupy
more link slots (more collision retries for the earliest-slot reservation
in ``core.schedule``), and messages arrive later (``t_compute`` stretches to
cover the last arrival). This pass runs between
:func:`~repro.core.partition.partition` and
:func:`~repro.core.remat.rematerialize` and chooses *which* core each
process occupies:

  * **traffic graph** — for every surviving :class:`SendEdge`, one directed
    (src_proc, dst_proc) edge weighted by the sender value's criticality:
    ``1 + (1 - slack/horizon)`` where slack is the ALAP−ASAP mobility of the
    value's defining instruction inside its process DAG. A message on its
    producer's critical path counts double; a fully slack one counts once.
  * **region** — processes are packed into a near-square block of the grid
    (``ceil(sqrt(n))`` wide) instead of identity's row-major prefix: a
    square block has a smaller forward diameter and spreads traffic over
    both link dimensions. Identity placement stays available (and frozen)
    as ``"identity"``.
  * **seeding** — greedy recursive bisection: split the region along its
    longer axis, split the processes to match capacity by greedily growing
    the half with the strongest internal traffic, recurse.
  * **refinement** — simulated annealing under a fixed move budget with
    swap and relocate moves, geometric cooling, incremental (incident-edge)
    cost deltas, and a deterministic seed so compiles are reproducible and
    cacheable. The best placement ever seen is returned, and identity is
    kept instead when it scores better in the weighted-hop objective.

The objective is slack-weighted hop count — a proxy for the scheduler's
real figure of merit (VCPL). ``compile_circuit`` therefore schedules *both*
the annealed and the identity geometry and ships whichever lands the lower
VCPL (``stats["place_pick"]``): placement can only ever improve the
schedule, never regress it.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .isa import HardwareConfig
from .lower import Lowered
from .partition import Partition, SendEdge

PLACEMENTS = ("identity", "anneal")
DEFAULT_SEED = 0
# SA move budget: scales with process count, bounded so full-grid circuits
# stay well under the scheduler's own wall time share
MOVES_PER_PROC = 220
MAX_MOVES = 45000


@dataclass
class Placement:
    """A core assignment plus the pass's accounting.

    ``stats`` carries ``total_hops`` / ``weighted_hops`` for the chosen
    mapping, the identity baseline (``identity_hops`` /
    ``identity_weighted_hops``), and the SA accounting
    (``place_moves`` attempted, ``place_accepted``, ``place_seconds``).
    """
    core_of_proc: List[int]
    stats: Dict[str, float] = field(default_factory=dict)


# ----------------------------------------------------------------------
# traffic graph
# ----------------------------------------------------------------------

def traffic_graph(low: Lowered, part: Partition,
                  hw: HardwareConfig) -> Dict[Tuple[int, int], float]:
    """Slack-weighted inter-process traffic: (src, dst) -> weight.

    Each :class:`SendEdge` contributes ``1 + crit`` where ``crit`` is how
    critical the sent value's defining instruction is inside its producer
    process (1 on the critical path, 0 at maximal slack) — so the annealer
    shortens the routes whose flight time the schedule cannot hide.
    """
    L = hw.raw_latency
    defs = low.defs()

    # per-process ALAP - ASAP slack of every member instruction
    slack: List[Dict[int, int]] = []
    horizon = 1
    for p in part.procs:
        idx = {i: k for k, i in enumerate(p)}   # sorted == topo order
        n = len(p)
        asap = [0] * n
        succs: List[List[int]] = [[] for _ in range(n)]
        for k, i in enumerate(p):
            for s in low.instrs[i].reads():
                d = defs.get(s)
                if d is None:
                    continue
                kd = idx.get(d)
                if kd is not None and kd < k:
                    succs[kd].append(k)
                    if asap[kd] + L > asap[k]:
                        asap[k] = asap[kd] + L
        height = [1] * n
        for k in range(n - 1, -1, -1):
            for j in succs[k]:
                if height[j] + L > height[k]:
                    height[k] = height[j] + L
        T = max((asap[k] + height[k] for k in range(n)), default=1)
        horizon = max(horizon, T)
        slack.append({i: (T - height[k]) - asap[k] for k, i in enumerate(p)})

    g: Dict[Tuple[int, int], float] = {}
    for e in part.sends:
        d = defs.get(e.nxt_vreg)
        sl = slack[e.src_proc].get(d, horizon)
        crit = 1.0 - min(sl, horizon) / horizon
        k = (e.src_proc, e.dst_proc)
        g[k] = g.get(k, 0.0) + 1.0 + crit
    return g


# ----------------------------------------------------------------------
# cost helpers (shared with compile stats / benchmarks / tests)
# ----------------------------------------------------------------------

def hop_cost(core_of_proc: Sequence[int], sends: Sequence[SendEdge],
             hw: HardwareConfig) -> int:
    """Unweighted total hop count of ``sends`` under a placement."""
    return sum(hw.route_hops(core_of_proc[e.src_proc],
                             core_of_proc[e.dst_proc]) for e in sends)


def weighted_cost(core_of_proc: Sequence[int],
                  traffic: Dict[Tuple[int, int], float],
                  hw: HardwareConfig) -> float:
    """Slack-weighted hop count of a traffic graph under a placement."""
    return sum(w * hw.route_hops(core_of_proc[a], core_of_proc[b])
               for (a, b), w in traffic.items())


# ----------------------------------------------------------------------
# region + bisection seed
# ----------------------------------------------------------------------

def _region_cells(hw: HardwareConfig, n: int) -> List[int]:
    """A near-square block of core ids holding at least ``n`` cells.

    Identity fills row-major core ids 0..n-1 — a 15-wide strip whose
    forward x-diameter is the whole grid. A ``ceil(sqrt(n))``-wide block
    halves the typical forward distance and gives every process +x *and*
    +y neighbours to trade traffic over.
    """
    w = min(hw.grid_width, max(1, math.ceil(math.sqrt(n))))
    h = min(hw.grid_height, math.ceil(n / w))
    if w * h < n:                      # height capped: widen instead
        w = min(hw.grid_width, math.ceil(n / h))
    assert w * h >= n, (n, w, h)
    return [hw.xy_core(x, y) for y in range(h) for x in range(w)]


def _bisect_seed(procs: Sequence[int], cells: List[int], hw: HardwareConfig,
                 sym: Dict[int, Dict[int, float]]) -> Dict[int, int]:
    """Greedy recursive bisection: strongest-coupled processes end up in
    the same half of the region. Deterministic (ties break on proc id)."""
    out: Dict[int, int] = {}

    def rec(ps: List[int], cs: List[int]) -> None:
        if len(ps) <= 2 or len(cs) <= 3:
            for p, c in zip(ps, cs):
                out[p] = c
            return
        xs = [hw.core_xy(c)[0] for c in cs]
        ys = [hw.core_xy(c)[1] for c in cs]
        if max(xs) - min(xs) >= max(ys) - min(ys):
            cs_sorted = sorted(cs, key=lambda c: hw.core_xy(c))
        else:
            cs_sorted = sorted(cs, key=lambda c: hw.core_xy(c)[::-1])
        half = (len(cs_sorted) + 1) // 2
        cs_a, cs_b = cs_sorted[:half], cs_sorted[half:]
        lo = max(0, len(ps) - len(cs_b))
        hi = min(len(ps), len(cs_a))
        target = max(lo, min(hi, (len(ps) * len(cs_a)
                                  + len(cs) // 2) // len(cs)))
        rest = set(ps)
        in_rest = {p: sum(w for q, w in sym.get(p, {}).items()
                          if q in rest) for p in ps}
        conn = {p: 0.0 for p in ps}
        a: List[int] = []
        while len(a) < target:
            if a:
                # gain = attraction to A minus attraction to what remains
                p = max(rest, key=lambda p: (2 * conn[p] - in_rest[p], -p))
            else:
                p = max(rest, key=lambda p: (in_rest[p], -p))
            a.append(p)
            rest.remove(p)
            for q, w in sym.get(p, {}).items():
                if q in rest:
                    conn[q] += w
        rec(sorted(a), cs_a)
        rec(sorted(rest), cs_b)

    rec(sorted(procs), cells)
    return out


# ----------------------------------------------------------------------
# simulated annealing
# ----------------------------------------------------------------------

def _anneal(pos: Dict[int, int], cells: List[int],
            traffic: Dict[Tuple[int, int], float], hw: HardwareConfig,
            seed: int, moves: int) -> Tuple[Dict[int, int], Dict[str, float]]:
    W, H = hw.grid_width, hw.grid_height
    ncores = hw.num_cores
    X = [c % W for c in range(ncores)]
    Y = [c // W for c in range(ncores)]

    def hop(a: int, b: int) -> int:
        return (X[b] - X[a]) % W + (Y[b] - Y[a]) % H

    # per-pair directed weights, indexed from both endpoints
    pairs: Dict[Tuple[int, int], List[float]] = {}
    for (a, b), w in traffic.items():
        key, fwd = ((a, b), 0) if a < b else ((b, a), 1)
        pairs.setdefault(key, [0.0, 0.0])[fwd] += w
    und: Dict[int, List[Tuple[int, float, float]]] = {p: [] for p in pos}
    for (a, b), (wab, wba) in sorted(pairs.items()):
        und[a].append((b, wab, wba))      # (other, w out, w in)
        und[b].append((a, wba, wab))

    def local(s: frozenset) -> float:
        t = 0.0
        for p in s:
            pc = pos[p]
            for (q, wo, wi) in und[p]:
                if q in s and q < p:      # internal pair counted once
                    continue
                qc = pos[q]
                t += wo * hop(pc, qc) + wi * hop(qc, pc)
        return t

    def total() -> float:
        return sum(wab * hop(pos[a], pos[b]) + wba * hop(pos[b], pos[a])
                   for (a, b), (wab, wba) in pairs.items())

    procs = sorted(pos)
    occ = {c: p for p, c in pos.items()}
    free = [c for c in cells if c not in occ]
    rnd = random.Random(seed)
    cur = total()
    best = cur
    best_pos = dict(pos)
    t0 = 0.25 * (W + H)
    t_end = 0.05
    accepted = 0
    for m in range(moves):
        temp = t0 * (t_end / t0) ** (m / max(moves - 1, 1))
        p = procs[rnd.randrange(len(procs))]
        if free and rnd.random() < 0.3:           # relocate to a free cell
            j = rnd.randrange(len(free))
            c_new, c_old = free[j], pos[p]
            s = frozenset((p,))
            old = local(s)
            pos[p] = c_new
            d = local(s) - old
            if d <= 0 or rnd.random() < math.exp(-d / temp):
                del occ[c_old]
                occ[c_new] = p
                free[j] = c_old
                cur += d
                accepted += 1
            else:
                pos[p] = c_old
        else:                                     # swap two occupants
            q = procs[rnd.randrange(len(procs))]
            if q == p:
                continue
            s = frozenset((p, q))
            old = local(s)
            pos[p], pos[q] = pos[q], pos[p]
            d = local(s) - old
            if d <= 0 or rnd.random() < math.exp(-d / temp):
                occ[pos[p]], occ[pos[q]] = p, q
                cur += d
                accepted += 1
            else:
                pos[p], pos[q] = pos[q], pos[p]
        if cur < best:
            best = cur
            best_pos = dict(pos)
    return best_pos, {"place_moves": float(moves),
                      "place_accepted": float(accepted)}


# ----------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------

def place(low: Lowered, part: Partition, hw: HardwareConfig,
          strategy: str = "anneal", seed: int = DEFAULT_SEED,
          moves: Optional[int] = None) -> Placement:
    """Map processes onto grid cores.

    ``"identity"`` is the frozen default-for-CI mapping (process p on core
    p, bit-identical to the pre-placement compiler). ``"anneal"`` builds
    the slack-weighted traffic graph, seeds with recursive bisection over
    a near-square region and refines with simulated annealing; when the
    result does not beat identity in the weighted objective, identity is
    returned (the scheduler-level best-of-two in ``compile_circuit`` is
    the final arbiter either way).
    """
    if strategy not in PLACEMENTS:
        raise ValueError(
            f"unknown placement {strategy!r}; choose from {PLACEMENTS}")
    n = part.num_procs
    ident = list(range(n))
    t0 = time.perf_counter()
    if strategy == "identity" or n <= 1 or not part.sends:
        hops = hop_cost(ident, part.sends, hw)
        return Placement(ident, {
            "total_hops": float(hops), "weighted_hops": 0.0,
            "identity_hops": float(hops), "identity_weighted_hops": 0.0,
            "place_moves": 0.0, "place_accepted": 0.0,
            "place_seconds": round(time.perf_counter() - t0, 6)})

    traffic = traffic_graph(low, part, hw)
    sym: Dict[int, Dict[int, float]] = {}
    for (a, b), w in traffic.items():
        sym.setdefault(a, {})[b] = sym.setdefault(a, {}).get(b, 0.0) + w
        sym.setdefault(b, {})[a] = sym.setdefault(b, {}).get(a, 0.0) + w

    cells = _region_cells(hw, n)
    pos = _bisect_seed(range(n), cells, hw, sym)
    if moves is None:
        moves = min(MAX_MOVES, max(4000, MOVES_PER_PROC * n))
    pos, sa = _anneal(pos, cells, traffic, hw, seed, moves)

    cop = [pos[p] for p in range(n)]
    w_ident = weighted_cost(ident, traffic, hw)
    w_final = weighted_cost(cop, traffic, hw)
    if w_ident <= w_final:      # objective says identity is no worse: keep it
        cop, w_final = ident, w_ident
    stats = {
        "total_hops": float(hop_cost(cop, part.sends, hw)),
        "weighted_hops": round(w_final, 3),
        "identity_hops": float(hop_cost(ident, part.sends, hw)),
        "identity_weighted_hops": round(w_ident, 3),
        "place_seconds": round(time.perf_counter() - t0, 6),
        **sa,
    }
    return Placement(cop, stats)
