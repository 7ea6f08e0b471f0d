# Copy of src/repro/core/schedule.py (commit aa57dc1); imports may differ.
"""List scheduling + static NoC routing (paper §6.3).

Performs an abstract cycle-accurate simulation of one Vcycle over a model of
the core pipeline and the uni-directional 2D torus NoC:

  * an instruction issues when its RAW predecessors issued >= ``raw_latency``
    slots earlier (the compiler resolves hazards with NOps — there are no
    interlocks in hardware);
  * memory-order edges keep full-cycle semantics (all loads of a memory issue
    before its stores; stores keep program order);
  * WAR edges protect current-register values until their commit (either an
    explicit MOV or the Wimmer-Franz register-sharing optimization that lands
    the next value directly in the current register);
  * a SEND issues only when every link of its dimension-ordered route is free
    at the corresponding future slot and its arrival slot at the destination
    is unique (the paper's switches drop colliding messages — the schedule
    must be collision-free *by construction*);
  * received messages cost one epilogue slot each at the destination
    (they are replayed from instruction memory, §5.2).

Two strategies share this machine model:

  * ``"greedy"`` — the original scheduler, kept bit-identical for
    differential testing: priority is the longest latency path to a leaf,
    computed once; candidates are re-sorted every slot; a SEND that cannot
    claim its route simply retries next cycle.
  * ``"slack"`` (default) — a slack-driven list scheduler: per-instruction
    ASAP/ALAP times give mobility (ALAP - ASAP), the dynamic priority
    (tie-broken by successor fanout), maintained in per-process ready heaps
    so each instruction is examined O(log n) times instead of once per
    slot.  A SEND searches its route for the *earliest* collision-free slot
    and reserves links + arrival ahead of time rather than retrying, and
    its priority is biased by downstream receiver slack so cross-core
    critical paths drain first.  The pass runs under two priority
    functions (mobility-biased and pure critical-path height) and keeps
    whichever schedule lands the lower VCPL.

A SEND whose source and destination core coincide is a *local move*: it
claims no NoC link and no arrival slot and costs no epilogue replay.

The scheduler reports **VCPL** — machine slots per simulated RTL cycle — the
paper's exact performance model for a deterministic machine.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .isa import HardwareConfig, Instr, Op, PURE_OPS

RAW = 0
ORDER = 1  # issue-order edge (memory order, WAR): latency 1

STRATEGIES = ("greedy", "slack")
PIPELINES = ("modulo", "off")
MEM_OPS = (Op.LD, Op.ST, Op.GLD, Op.GST)


@dataclass
class CoreProgram:
    """One core's scheduled stream: slot -> instr (None = NOp)."""
    slots: List[Optional[Instr]]
    recv_count: int = 0
    # (slot, dst_core, dst_machine_reg placeholder vreg) for SENDs, filled in
    sends: List[Tuple[int, Instr]] = field(default_factory=list)


@dataclass
class ScheduleResult:
    cores: List[CoreProgram]
    t_compute: int            # executed slots per Vcycle
    vcpl: int                 # full virtual critical path (incl. epilogue)
    stats: Dict[str, float] = field(default_factory=dict)


def _route(hw: HardwareConfig, src: int, dst: int) -> List[Tuple[str, int, int]]:
    """Dimension-ordered route on the uni-directional torus: +x then +y.
    Returns a list of directed links ('x'|'y', x, y) traversed in order.
    A src == dst route is empty: a self-send is a local move that never
    touches the NoC."""
    sx, sy = hw.core_xy(src)
    dx, dy = hw.core_xy(dst)
    links: List[Tuple[str, int, int]] = []
    x, y = sx, sy
    while x != dx:
        links.append(("x", x, y))
        x = (x + 1) % hw.grid_width
    while y != dy:
        links.append(("y", x, y))
        y = (y + 1) % hw.grid_height
    return links


def _build_deps(core_instrs: List[List[Instr]],
                war_edges: List[List[Tuple[int, int]]],
                order_edges: List[List[Tuple[int, int]]]):
    """Per-process dependence graph: preds[p][i] / succs[p][i] = [(j, kind)]."""
    preds: List[List[List[Tuple[int, int]]]] = []
    succs: List[List[List[Tuple[int, int]]]] = []
    for p, instrs in enumerate(core_instrs):
        defs: Dict[int, int] = {}
        pr: List[List[Tuple[int, int]]] = [[] for _ in instrs]
        su: List[List[Tuple[int, int]]] = [[] for _ in instrs]
        for i, ins in enumerate(instrs):
            for s in ins.srcs:
                d = defs.get(s)
                if d is not None:
                    pr[i].append((d, RAW))
                    su[d].append((i, RAW))
            w = ins.writes()
            if w is not None and w != 0:   # vreg 0 is the constant zero
                defs[w] = i
        for (a, b) in war_edges[p] + order_edges[p]:
            pr[b].append((a, ORDER))
            su[a].append((b, ORDER))
        preds.append(pr)
        succs.append(su)
    return preds, succs


def schedule(core_instrs: List[List[Instr]],
             core_of_proc: List[int],
             hw: HardwareConfig,
             send_dst_core: Dict[int, int],
             war_edges: List[List[Tuple[int, int]]],
             order_edges: List[List[Tuple[int, int]]],
             strategy: str = "slack",
             min_ready: Optional[List[Dict[int, int]]] = None
             ) -> ScheduleResult:
    """Schedule every process's instruction list onto its core.

    ``core_instrs[p]`` is process p's topo-ordered instruction list (SENDs
    included). ``war_edges[p]`` / ``order_edges[p]`` are (src_idx, dst_idx)
    issue-order constraints. ``send_dst_core`` maps id(instr) -> dst core.
    ``strategy`` selects the scheduling policy (see module docstring).
    ``min_ready[p]`` maps instruction index -> earliest issue slot — the
    modulo pipeliner uses it to keep body consumers of prologue-hoisted
    values ``raw_latency`` slots downstream of their (rotated) producers.
    """
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown sched strategy {strategy!r}; choose from {STRATEGIES}")
    ncores = hw.num_cores
    L = hw.raw_latency

    preds, succs = _build_deps(core_instrs, war_edges, order_edges)

    # priority = longest latency path to any leaf (critical path first)
    prio: List[List[int]] = []
    for p, instrs in enumerate(core_instrs):
        n = len(instrs)
        pv = [0] * n
        for i in range(n - 1, -1, -1):
            best = 0
            for (j, kind) in succs[p][i]:
                lat = L if kind == RAW else 1
                best = max(best, pv[j] + lat)
            pv[i] = best
        prio.append(pv)

    # lower bound on t_compute: the longest latency path through any
    # process's dependence graph, and each core's instruction load. A
    # schedule hitting this bound is provably minimal *for this partition*
    # (the middle-end's job is to shrink the bound itself — fewer, simpler
    # instructions per cone; see core.opt).
    core_load: Dict[int, int] = {}
    crit_lb = 0
    for p, instrs in enumerate(core_instrs):
        c = core_of_proc[p]
        core_load[c] = core_load.get(c, 0) + len(instrs)
        if instrs:
            crit_lb = max(crit_lb, max(prio[p]) + 1)
    crit_path_lb = max([crit_lb] + list(core_load.values()))

    sched_prio = None
    if strategy == "greedy":
        passres = _greedy_pass(core_instrs, core_of_proc, hw, send_dst_core,
                               preds, succs, prio, ncores,
                               min_ready=min_ready)
    else:
        # Two cheap list-scheduling passes over the same machine model:
        # mobility priority wins on communication-heavy graphs (it drains
        # low-slack cross-core chains first), pure height priority on
        # compute-dense ones. Keep whichever lands the lower VCPL
        # (mobility on ties — it is the primary policy).
        best = None
        for pr in ("mobility", "height"):
            pres = _slack_pass(core_instrs, core_of_proc, hw, send_dst_core,
                               preds, succs, ncores, core_load, pr,
                               min_ready=min_ready)
            if best is None or _pass_vcpl(pres) < _pass_vcpl(best[0]):
                best = (pres, pr)
        passres, sched_prio = best
    core_slots, core_sends, recv_count, last_arrival = passres

    total = sum(len(ci) for ci in core_instrs)
    res = _finish(core_slots, core_sends, recv_count, last_arrival, ncores,
                  total, crit_path_lb, hw, strategy)
    if sched_prio is not None:
        res.stats["sched_prio"] = sched_prio
    return res


def _pass_vcpl(passres) -> int:
    """VCPL of a raw scheduling pass result, before padding/stats."""
    core_slots, _sends, recv_count, last_arrival = passres
    t_comp = max([len(s) for s in core_slots] + [last_arrival], default=0)
    return t_comp + (max(recv_count) if recv_count else 0)


# ----------------------------------------------------------------------
# greedy pass — the original scheduler, frozen for differential testing
# ----------------------------------------------------------------------

def _greedy_pass(core_instrs, core_of_proc, hw, send_dst_core,
                 preds, succs, prio, ncores, min_ready=None):
    L = hw.raw_latency

    n_sched: List[int] = [0] * len(core_instrs)
    sched_slot: List[List[int]] = [[-1] * len(ci) for ci in core_instrs]
    npreds_left = [[len(pp) for pp in preds[p]] for p in range(len(preds))]
    ready: List[List[int]] = [[] for _ in core_instrs]   # instr idxs
    ready_time: List[Dict[int, int]] = [
        dict(min_ready[p]) if min_ready else dict()
        for p in range(len(core_instrs))]
    for p, instrs in enumerate(core_instrs):
        for i in range(len(instrs)):
            if npreds_left[p][i] == 0:
                ready[p].append(i)
                ready_time[p].setdefault(i, 0)

    link_busy: Dict[Tuple[str, int, int], Set[int]] = {}
    arrival_busy: Dict[int, Set[int]] = {}
    recv_count = [0] * ncores
    core_slots: List[List[Optional[Instr]]] = [[] for _ in range(ncores)]
    core_sends: List[List[Tuple[int, Instr]]] = [[] for _ in range(ncores)]
    last_arrival = 0

    total = sum(len(ci) for ci in core_instrs)
    done = 0
    t = 0
    max_slots = 4 * total + 64 + sum(len(ci) == 0 for ci in core_instrs)
    proc_list = list(range(len(core_instrs)))
    while done < total:
        if t > max_slots:
            raise RuntimeError("scheduler failed to converge")
        for p in proc_list:
            c = core_of_proc[p]
            instrs = core_instrs[p]
            # pick highest-priority ready instr that can issue now
            cand = sorted((i for i in ready[p] if ready_time[p][i] <= t),
                          key=lambda i: (-prio[p][i], i))
            issued = None
            for i in cand:
                ins = instrs[i]
                if ins.op == Op.SEND:
                    dst = send_dst_core[id(ins)]
                    links = _route(hw, c, dst)
                    if links:
                        slots_needed = [t + 1 + k * hw.send_latency
                                        for k in range(len(links))]
                        arrive = t + 1 + len(links) * hw.send_latency
                        if any(s in link_busy.get(lk, set())
                               for lk, s in zip(links, slots_needed)):
                            continue
                        if arrive in arrival_busy.get(dst, set()):
                            continue
                        for lk, s in zip(links, slots_needed):
                            link_busy.setdefault(lk, set()).add(s)
                        arrival_busy.setdefault(dst, set()).add(arrive)
                        recv_count[dst] += 1
                        last_arrival = max(last_arrival, arrive)
                    else:
                        # self-send: local move, no NoC claims, no epilogue
                        last_arrival = max(last_arrival, t + 1)
                    core_sends[c].append((t, ins))
                issued = i
                break
            # pad with NOps up to slot t
            while len(core_slots[c]) < t:
                core_slots[c].append(None)
            if issued is not None:
                ins = instrs[issued]
                core_slots[c].append(ins)
                sched_slot[p][issued] = t
                ready[p].remove(issued)
                done += 1
                for (j, kind) in succs[p][issued]:
                    npreds_left[p][j] -= 1
                    lat = L if kind == RAW else 1
                    rt = max(ready_time[p].get(j, 0), t + lat)
                    ready_time[p][j] = rt
                    if npreds_left[p][j] == 0:
                        ready[p].append(j)
        t += 1

    return core_slots, core_sends, recv_count, last_arrival


# ----------------------------------------------------------------------
# slack pass — ASAP/ALAP mobility heaps + earliest-slot SEND reservation
# ----------------------------------------------------------------------

def _slack_pass(core_instrs, core_of_proc, hw, send_dst_core,
                preds, succs, ncores, core_load, prio_mode="mobility",
                min_ready=None):
    L = hw.raw_latency
    nproc = len(core_instrs)

    # Route (and receiver pressure) per SEND, computed once.
    routes: Dict[int, List[Tuple[str, int, int]]] = {}
    route_dst: Dict[int, int] = {}
    inbound = [0] * ncores
    for p, instrs in enumerate(core_instrs):
        c = core_of_proc[p]
        for ins in instrs:
            if ins.op == Op.SEND:
                dst = send_dst_core[id(ins)]
                routes[id(ins)] = _route(hw, c, dst)
                route_dst[id(ins)] = dst
                if dst != c:
                    inbound[dst] += 1

    # ASAP (earliest data-ready slot) and height (latency-weighted distance
    # to schedule exit, where a SEND's exit includes its route flight time).
    asap_all: List[List[int]] = []
    height_all: List[List[int]] = []
    T_est = max(core_load.values(), default=0)
    for p, instrs in enumerate(core_instrs):
        n = len(instrs)
        floor = min_ready[p] if min_ready else {}
        asap = [0] * n
        for i in range(n):
            best = floor.get(i, 0)
            for (j, kind) in preds[p][i]:
                lat = L if kind == RAW else 1
                if asap[j] + lat > best:
                    best = asap[j] + lat
            asap[i] = best
        hgt = [1] * n
        for i in range(n - 1, -1, -1):
            ins = instrs[i]
            best = 1
            if ins.op == Op.SEND:
                best = 1 + len(routes[id(ins)]) * hw.send_latency
            for (j, kind) in succs[p][i]:
                lat = L if kind == RAW else 1
                if lat + hgt[j] > best:
                    best = lat + hgt[j]
            hgt[i] = best
        if n:
            T_est = max(T_est, max(asap[i] + hgt[i] for i in range(n)))
        asap_all.append(asap)
        height_all.append(hgt)

    # "mobility" priority: mobility = ALAP - ASAP = (T_est - height) - ASAP,
    # least-slack first, tie-broken by successor fanout; a SEND's mobility
    # is additionally capped by its receiver's slack (how much room the
    # destination core has before its stream + epilogue reach T_est), so
    # messages into hot receivers drain first. "height" priority: plain
    # critical-path (longest latency-weighted distance to exit) first.
    def _prio_key(p: int, i: int):
        if prio_mode == "height":
            return (-height_all[p][i], -len(succs[p][i]), i)
        ins = core_instrs[p][i]
        mob = (T_est - height_all[p][i]) - asap_all[p][i]
        if ins.op == Op.SEND:
            dst = route_dst[id(ins)]
            recv_slack = T_est - core_load.get(dst, 0) - inbound[dst]
            mob = min(mob, max(0, recv_slack))
        return (mob, -len(succs[p][i]), i)

    npreds_left = [[len(pp) for pp in preds[p]] for p in range(nproc)]
    # pend[p]: (data-ready slot, i) — promoted into ready[p] at that slot;
    # ready[p]: (mobility, -fanout, i) min-heaps.
    pend: List[List[Tuple[int, int]]] = [[] for _ in range(nproc)]
    ready: List[List[Tuple[int, int, int]]] = [[] for _ in range(nproc)]
    sched_rt: List[Dict[int, int]] = [
        dict(min_ready[p]) if min_ready else dict() for p in range(nproc)]
    for p, instrs in enumerate(core_instrs):
        for i in range(len(instrs)):
            if npreds_left[p][i] == 0:
                heapq.heappush(pend[p], (sched_rt[p].get(i, 0), i))

    link_busy: Dict[Tuple[str, int, int], Set[int]] = {}
    arrival_busy: Dict[int, Set[int]] = {}
    recv_count = [0] * ncores
    core_slots: List[List[Optional[Instr]]] = [[] for _ in range(ncores)]
    core_sends: List[List[Tuple[int, Instr]]] = [[] for _ in range(ncores)]
    # reserved[c][slot] = SEND committed to a future slot on core c
    reserved: List[Dict[int, Instr]] = [dict() for _ in range(ncores)]
    last_arrival = 0

    total = sum(len(ci) for ci in core_instrs)
    max_slots = 4 * total + 64 + sum(len(ci) == 0 for ci in core_instrs)

    def _mark_scheduled(p: int, i: int, slot: int) -> None:
        for (j, kind) in succs[p][i]:
            npreds_left[p][j] -= 1
            lat = L if kind == RAW else 1
            rt = slot + lat
            prev = sched_rt[p].get(j, 0)
            if rt > prev:
                sched_rt[p][j] = rt
            if npreds_left[p][j] == 0:
                heapq.heappush(pend[p], (sched_rt[p].get(j, 0), j))

    def _reserve_send(p: int, i: int, ins: Instr, c: int, t: int) -> int:
        """Earliest collision-free slot >= t for this SEND: core slot free,
        every route link free at its flight slot, arrival unique at dst.
        Claims everything immediately and returns the chosen slot."""
        nonlocal last_arrival
        links = routes[id(ins)]
        dst = route_dst[id(ins)]
        nhops = len(links)
        ts = t
        while True:
            if ts > max_slots:
                raise RuntimeError("scheduler failed to converge")
            if ts in reserved[c]:
                ts += 1
                continue
            if not links:          # self-send: local move, always placeable
                last_arrival = max(last_arrival, ts + 1)
                return ts
            slots_needed = [ts + 1 + k * hw.send_latency
                            for k in range(nhops)]
            arrive = ts + 1 + nhops * hw.send_latency
            if (any(s in link_busy.get(lk, set())
                    for lk, s in zip(links, slots_needed))
                    or arrive in arrival_busy.get(dst, set())):
                ts += 1
                continue
            for lk, s in zip(links, slots_needed):
                link_busy.setdefault(lk, set()).add(s)
            arrival_busy.setdefault(dst, set()).add(arrive)
            recv_count[dst] += 1
            last_arrival = max(last_arrival, arrive)
            return ts

    emitted = 0
    t = 0
    proc_list = list(range(nproc))
    while emitted < total:
        if t > max_slots:
            raise RuntimeError("scheduler failed to converge")
        for p in proc_list:
            c = core_of_proc[p]
            instrs = core_instrs[p]
            res = reserved[c].pop(t, None)
            if res is not None:
                while len(core_slots[c]) < t:
                    core_slots[c].append(None)
                core_slots[c].append(res)
                emitted += 1
                continue
            pp, rp = pend[p], ready[p]
            while pp and pp[0][0] <= t:
                _, i = heapq.heappop(pp)
                heapq.heappush(rp, _prio_key(p, i))
            issued: Optional[Instr] = None
            while rp:
                _, _, i = heapq.heappop(rp)
                ins = instrs[i]
                if ins.op == Op.SEND:
                    ts = _reserve_send(p, i, ins, c, t)
                    core_sends[c].append((ts, ins))
                    _mark_scheduled(p, i, ts)
                    if ts == t:
                        issued = ins
                        emitted += 1
                        break
                    reserved[c][ts] = ins
                    continue   # send parked in the future; keep looking
                _mark_scheduled(p, i, t)
                issued = ins
                emitted += 1
                break
            if issued is not None:
                while len(core_slots[c]) < t:
                    core_slots[c].append(None)
                core_slots[c].append(issued)
        t += 1

    return core_slots, core_sends, recv_count, last_arrival


# ----------------------------------------------------------------------
# shared epilogue: padding, VCPL, stats
# ----------------------------------------------------------------------

def _finish(core_slots, core_sends, recv_count, last_arrival, ncores, total,
            crit_path_lb, hw, strategy) -> ScheduleResult:
    t_compute = max((len(s) for s in core_slots), default=0)
    t_compute = max(t_compute, last_arrival)
    for s in core_slots:
        while len(s) < t_compute:
            s.append(None)

    epilogue = max(recv_count) if recv_count else 0
    vcpl = t_compute + epilogue

    nops = sum(1 for s in core_slots for x in s if x is None)
    for sends in core_sends:
        sends.sort(key=lambda e: e[0])
    sends_n = sum(len(s) for s in core_sends)
    cores = [CoreProgram(core_slots[c], recv_count[c], core_sends[c])
             for c in range(ncores)]

    # per-core utilization over *used* cores (any instr or any receive)
    used = [c for c in range(ncores)
            if recv_count[c] or any(x is not None for x in core_slots[c])]
    loads = [sum(x is not None for x in core_slots[c]) for c in used]
    hist = [0] * 10
    if t_compute:
        for ld in loads:
            dens = 1.0 - ld / t_compute
            hist[min(9, int(dens * 10))] += 1

    res = ScheduleResult(cores, t_compute, vcpl, stats={
        "t_compute": t_compute,
        "epilogue": epilogue,
        "vcpl": vcpl,
        "nops": nops,
        "sends": sends_n,
        "instrs": total,
        "crit_path_lb": crit_path_lb,
        "sched_minimal": t_compute == crit_path_lb,
        "imem_overflow": max(0, vcpl - hw.imem_slots),
        "sched_strategy": strategy,
        "cores_used": len(used),
        "core_load_max": max(loads, default=0),
        "core_load_mean": round(sum(loads) / len(loads), 3) if loads else 0.0,
        "nop_density_hist": hist,
        "epilogue_share": round(epilogue / vcpl, 4) if vcpl else 0.0,
    })
    return res


# ----------------------------------------------------------------------
# cross-Vcycle modulo pipelining
# ----------------------------------------------------------------------

@dataclass
class PipelineInfo:
    """Modulo-pipelining overlay for a combined prologue+body schedule.

    The combined stream (``span`` slots: prologue ``[0, P)``, body compute,
    epilogue replays) is launched every ``ii`` slots in steady state.  All
    legality is expressed through per-commit *visibility slots* sigma — the
    slot at which a committed current-register value becomes readable:

      * local commit (shared next-value def or commit MOV) issued at slot
        ``d``: sigma = d + raw_latency (the write traverses the exec
        pipeline);
      * local move (self-send): applied with the exchange, sigma =
        t_compute + 1;
      * NoC message replayed with 1-based epilogue rank ``r``: sigma =
        t_compute + r, occupying destination-core slot t_compute + r - 1.

    A reader of current register ``v`` at slot ``s``: if ``s < sigma`` it
    reads the *previous* iteration's commit, so the next launch must wait
    for visibility — ``ii >= sigma - s``; if ``s >= sigma`` it reads this
    iteration's value, so the *next* commit must not overtake it —
    ``ii >= s - sigma + 1`` (commit-order safety).  Register WAR inside the
    body is assumed away by modulo variable expansion (see docs); only
    architectural state carries constraints: current registers (above),
    prologue carries (``ii >= last_read - def + 1``), and scratchpad
    ordering (iteration n+1's first memory op waits for iteration n's last
    store: ``ii >= max_store_slot - min_mem_slot + 1`` per process/memory).
    Resources repeat modulo ii: core issue slots (incl. replay slots), link
    claims, and arrival slots must each be collision-free mod ii.
    """
    ii: int
    prologue_len: int
    span: int
    hoist: List[Set[int]]                 # per-process hoisted instr idxs
    share: List[Dict[int, int]]           # per-process nxt -> cur shares
    commit_def: List[Dict[int, int]]      # per-process cur -> commit idx
    replay_rank: Dict[int, int]           # id(SEND) -> 1-based replay rank
    stats: Dict[str, float] = field(default_factory=dict)


def _commit_sigma(core_instrs: List[List[Instr]],
                  core_of_proc: List[int],
                  hw: HardwareConfig,
                  send_dst_core: Dict[int, int],
                  commit_def: List[Dict[int, int]],
                  slot_of: List[List[int]],
                  t_comp: int,
                  replay_rank: Optional[Dict[int, int]] = None):
    """Visibility slot per (proc, current vreg); assigns replay ranks.

    When ``replay_rank`` is None, ranks are chosen per destination core by
    ascending earliest-reader slot (unread messages last) — the replay
    order is free (the engine exchange is an atomic scatter), and this
    choice minimizes ``max(sigma - s_min)`` over inbound messages.  When
    given, the supplied ranks are used (validator mode).
    """
    L = hw.raw_latency
    nproc = len(core_instrs)
    big = 1 << 30
    sigma: List[Dict[int, int]] = [{} for _ in range(nproc)]
    for p, cd in enumerate(commit_def):
        for cur, di in cd.items():
            sigma[p][cur] = slot_of[p][di] + L

    # earliest read slot per (proc, vreg) — drives the replay order
    reader_min: Dict[Tuple[int, int], int] = {}
    for q, qinstrs in enumerate(core_instrs):
        for i, ins in enumerate(qinstrs):
            s = slot_of[q][i]
            for src in ins.srcs:
                k = (q, src)
                if s < reader_min.get(k, big):
                    reader_min[k] = s

    inbound: Dict[int, List[Tuple[int, int, int, int, Instr]]] = {}
    for p, instrs in enumerate(core_instrs):
        c = core_of_proc[p]
        for i, ins in enumerate(instrs):
            if ins.op != Op.SEND:
                continue
            q, v = ins.send_dst_proc, ins.send_dst_vreg
            dst = send_dst_core[id(ins)]
            ts = slot_of[p][i]
            if dst == c:
                if q is not None and v:
                    sigma[q][v] = t_comp + 1
                continue
            smin = reader_min.get((q, v), big) if q is not None else big
            inbound.setdefault(dst, []).append((smin, ts, p, i, ins))

    ranks: Dict[int, int] = {}
    for dst, lst in inbound.items():
        if replay_rank is None:
            lst.sort(key=lambda e: (e[0], e[1], e[2], e[3]))
            order = list(enumerate(lst, start=1))
        else:
            order = []
            for e in lst:
                r = replay_rank.get(id(e[4]))
                if r is None:
                    raise ValueError(
                        f"inbound SEND to core {dst} has no replay rank")
                order.append((r, e))
            if sorted(r for r, _ in order) != list(range(1, len(lst) + 1)):
                raise ValueError(
                    f"replay ranks at core {dst} are not a permutation of "
                    f"1..{len(lst)}")
        for r, (_smin, _ts, _p, _i, ins) in order:
            ranks[id(ins)] = r
            q, v = ins.send_dst_proc, ins.send_dst_vreg
            if q is not None and v:
                sigma[q][v] = t_comp + r
    return sigma, ranks


def _pipeline_floors(core_instrs: List[List[Instr]],
                     hoist: List[Set[int]],
                     sigma: List[Dict[int, int]],
                     slot_of: List[List[int]]) -> int:
    """Largest data-hazard lower bound on the initiation interval."""
    ii = 1
    for p, instrs in enumerate(core_instrs):
        mem_lo: Dict[str, int] = {}
        mem_st: Dict[str, int] = {}
        for i, ins in enumerate(instrs):
            s = slot_of[p][i]
            for src in set(ins.srcs):
                sg = sigma[p].get(src)
                if sg is None:
                    continue
                if s < sg:
                    ii = max(ii, sg - s)          # cross-iteration RAW
                else:
                    ii = max(ii, s - sg + 1)      # commit-order safety
            if ins.op in MEM_OPS:
                m = ins.mem or "?"
                if m not in mem_lo or s < mem_lo[m]:
                    mem_lo[m] = s
                if ins.op in (Op.ST, Op.GST):
                    if m not in mem_st or s > mem_st[m]:
                        mem_st[m] = s
        for m, st in mem_st.items():
            ii = max(ii, st - mem_lo[m] + 1)      # stores drain before reuse
        for i in hoist[p]:
            w = instrs[i].writes()
            d = slot_of[p][i]
            for j, jins in enumerate(instrs):
                if j != i and w in jins.srcs:
                    ii = max(ii, slot_of[p][j] - d + 1)   # carry WAR
    return ii


def _modulo_conflict(ii: int,
                     busy: List[Set[int]],
                     link_busy: Dict[Tuple[str, int, int], Set[int]],
                     arrival_busy: Dict[int, Set[int]]) -> bool:
    for grp in busy:
        if len({s % ii for s in grp}) != len(grp):
            return True
    for grp in link_busy.values():
        if len({s % ii for s in grp}) != len(grp):
            return True
    for grp in arrival_busy.values():
        if len({s % ii for s in grp}) != len(grp):
            return True
    return False


def _repair_modulo(comb: ScheduleResult,
                   core_instrs: List[List[Instr]],
                   core_of_proc: List[int],
                   hw: HardwareConfig,
                   preds, succs,
                   P: int, ii: int,
                   slot_of: List[List[int]]):
    """Try to make every core's issue/replay slots distinct modulo ``ii``
    by relocating instructions into free slots.

    Steady-state collisions are almost always the epilogue replay tail of
    iteration n wrapping onto the stream head of iteration n+1 — and the
    head instructions usually have slack.  A colliding instruction may move
    to any free slot of its core inside its dependence window (RAW
    distance ``raw_latency``, order edges distance 1, body region
    ``[P, t_compute)``) whose residue mod ii is unclaimed.  Replay slots
    and SENDs (whose link/arrival claims are frozen) never move.  Returns
    ``(per-core slot lists, per-proc slot positions)`` or ``None`` when
    some collision is unresolvable at this ii.  The caller re-verifies the
    repaired placement from scratch (moves shift commit visibility and
    reader slots, so the data-hazard floor must be recomputed).
    """
    L = hw.raw_latency
    t_comp = comb.t_compute
    ncores = len(comb.cores)
    slots_c = [list(cp.slots) for cp in comb.cores]
    pos = [list(sl) for sl in slot_of]
    owner: List[Dict[int, Tuple[int, int]]] = [{} for _ in range(ncores)]
    for p in range(len(core_instrs)):
        c = core_of_proc[p]
        for i, s in enumerate(pos[p]):
            owner[c][s] = (p, i)

    for c in range(ncores):
        busy = {s for s, x in enumerate(slots_c[c]) if x is not None}
        busy |= {t_comp + r for r in range(comb.cores[c].recv_count)}
        if len(busy) > ii:
            return None
        res_used: Dict[int, List[int]] = {}
        for s in sorted(busy):
            res_used.setdefault(s % ii, []).append(s)
        for r in sorted(res_used):
            group = res_used[r]
            if len(group) <= 1:
                continue
            movable = [s for s in group
                       if s < t_comp and slots_c[c][s] is not None
                       and slots_c[c][s].op != Op.SEND]
            if len(group) - len(movable) > 1:
                return None        # two immovable occupants share a residue
            need_move = movable if len(movable) < len(group) \
                else movable[1:]   # all movable: keep the earliest
            for s in need_move:
                p, i = owner[c][s]
                # an instruction never crosses the prologue/body boundary
                # during repair: hoisted carries stay in [0, P), body work
                # stays in [P, t_compute)
                lo, hi = (0, P - 1) if s < P else (P, t_comp - 1)
                for (j, kind) in preds[p][i]:
                    lo = max(lo, pos[p][j] + (L if kind == RAW else 1))
                for (j, kind) in succs[p][i]:
                    hi = min(hi, pos[p][j] - (L if kind == RAW else 1))
                s2 = None
                for cand in range(lo, hi + 1):
                    if slots_c[c][cand] is None and cand % ii not in res_used:
                        s2 = cand
                        break
                if s2 is None:
                    return None
                slots_c[c][s2] = slots_c[c][s]
                slots_c[c][s] = None
                del owner[c][s]
                owner[c][s2] = (p, i)
                pos[p][i] = s2
                group.remove(s)
                res_used[s2 % ii] = [s2]
    return slots_c, pos


def _resource_sets(res: ScheduleResult, hw: HardwareConfig,
                   send_dst_core: Dict[int, int]):
    """Core-busy / link / arrival claim sets of a combined schedule."""
    busy: List[Set[int]] = []
    for cp in res.cores:
        b = {s for s, x in enumerate(cp.slots) if x is not None}
        b |= {res.t_compute + r for r in range(cp.recv_count)}
        busy.append(b)
    link_busy: Dict[Tuple[str, int, int], Set[int]] = {}
    arrival_busy: Dict[int, Set[int]] = {}
    for c, cp in enumerate(res.cores):
        for (ts, ins) in cp.sends:
            dst = send_dst_core[id(ins)]
            links = _route(hw, c, dst)
            for k, lk in enumerate(links):
                link_busy.setdefault(lk, set()).add(
                    ts + 1 + k * hw.send_latency)
            if links:
                arrival_busy.setdefault(dst, set()).add(
                    ts + 1 + len(links) * hw.send_latency)
    return busy, link_busy, arrival_busy


def pipeline_schedule(core_instrs: List[List[Instr]],
                      core_of_proc: List[int],
                      hw: HardwareConfig,
                      send_dst_core: Dict[int, int],
                      war_edges: List[List[Tuple[int, int]]],
                      order_edges: List[List[Tuple[int, int]]],
                      share: List[Dict[int, int]],
                      commit_def: List[Dict[int, int]],
                      hoist: List[Set[int]],
                      strategy: str = "slack",
                      crit_path_lb: int = 0,
                      base: Optional[ScheduleResult] = None
                      ) -> Optional[Tuple[ScheduleResult, PipelineInfo]]:
    """Modulo-pipeline one Vcycle: hoist ``hoist[p]`` into a prologue,
    reschedule the body, and compute the steady-state initiation interval.

    Returns ``(combined, info)`` — the combined prologue+body schedule
    (``info.span == combined.vcpl`` slots) and the pipelining overlay — or
    ``None`` when no II strictly below the combined span is legal (then
    pipelining cannot beat the barrier machine and the caller ships the
    baseline).  With an empty hoist and ``base`` given, the body schedule
    is reused verbatim, so the emitted program is bit-identical to the
    unpipelined one and the pass is pure overlap accounting.
    """
    L = hw.raw_latency
    ncores = hw.num_cores
    nproc = len(core_instrs)
    total = sum(len(ci) for ci in core_instrs)
    empty = all(not h for h in hoist)
    preds_all, succs_all = _build_deps(core_instrs, war_edges, order_edges)

    # ---- prologue placement (once; independent of body rescheduling):
    # hoisted instrs in topo order, earliest slot >= every hoisted RAW
    # predecessor + raw_latency, first free slot on the core (the hoist
    # set is ancestor-closed, so all RAW preds of a hoisted instr are
    # hoisted)
    pro_slot: List[Dict[int, int]] = [{} for _ in range(nproc)]
    occupied: List[Set[int]] = [set() for _ in range(ncores)]
    for p, instrs in enumerate(core_instrs):
        c = core_of_proc[p]
        for i in sorted(hoist[p]):
            lo = 0
            for (j, kind) in preds_all[p][i]:
                if kind == RAW and j in hoist[p]:
                    lo = max(lo, pro_slot[p][j] + L)
            while lo in occupied[c]:
                lo += 1
            occupied[c].add(lo)
            pro_slot[p][i] = lo
    P = 1 + max((max(o) for o in occupied if o), default=-1)

    # body = everything not hoisted; WAR edges whose reader is hoisted drop
    # (the rotated reader consumes the *committed* value — the sigma
    # constraints take over); memory-order endpoints are never hoistable
    body_instrs: List[List[Instr]] = []
    body_war: List[List[Tuple[int, int]]] = []
    body_order: List[List[Tuple[int, int]]] = []
    raw_floors: List[Dict[int, int]] = []
    for p, instrs in enumerate(core_instrs):
        h = hoist[p]
        newidx: Dict[int, int] = {}
        bl: List[Instr] = []
        for i, ins in enumerate(instrs):
            if i in h:
                continue
            newidx[i] = len(bl)
            bl.append(ins)
        body_instrs.append(bl)
        body_war.append([(newidx[a], newidx[b]) for (a, b) in
                         war_edges[p] if a not in h and b not in h])
        body_order.append([(newidx[a], newidx[b]) for (a, b) in
                           order_edges[p] if a not in h and b not in h])
        fl: Dict[int, int] = {}
        for i in newidx:
            for (j, kind) in preds_all[p][i]:
                if kind == RAW and j in h:
                    lo = max(0, pro_slot[p][j] + L - P)
                    if lo > fl.get(newidx[i], 0):
                        fl[newidx[i]] = lo
        raw_floors.append(fl)

    def _assemble(extra: Optional[List[int]]) -> ScheduleResult:
        """Combined prologue+body schedule; ``extra[p]`` is a head-clearance
        floor (earliest body slot) for every instruction of process p."""
        if empty and extra is None and base is not None:
            return ScheduleResult(
                [CoreProgram(list(cp.slots), cp.recv_count, list(cp.sends))
                 for cp in base.cores],
                base.t_compute, base.vcpl, dict(base.stats))
        mr: Optional[List[Dict[int, int]]] = None
        if extra is not None and any(extra):
            mr = []
            for p, bl in enumerate(body_instrs):
                fl = dict(raw_floors[p])
                if extra[p]:
                    for i in range(len(bl)):
                        if fl.get(i, 0) < extra[p]:
                            fl[i] = extra[p]
                mr.append(fl)
        elif not empty:
            mr = raw_floors
        body = schedule(body_instrs, core_of_proc, hw, send_dst_core,
                        body_war, body_order, strategy, min_ready=mr)
        if empty and P == 0:
            return body
        comb_slots: List[List[Optional[Instr]]] = []
        for c in range(ncores):
            sl: List[Optional[Instr]] = [None] * P
            sl.extend(body.cores[c].slots)
            comb_slots.append(sl)
        for p in range(nproc):
            c = core_of_proc[p]
            for i, s in pro_slot[p].items():
                comb_slots[c][s] = core_instrs[p][i]
        comb_sends = [[(ts + P, ins) for (ts, ins) in body.cores[c].sends]
                      for c in range(ncores)]
        recv = [cp.recv_count for cp in body.cores]
        comb = _finish(comb_slots, comb_sends, recv, 0, ncores, total,
                       crit_path_lb, hw, strategy)
        if "sched_prio" in body.stats:
            comb.stats["sched_prio"] = body.stats["sched_prio"]
        return comb

    def _floor_of(comb: ScheduleResult):
        placed: List[Dict[int, int]] = [{} for _ in comb.cores]
        for c, cp in enumerate(comb.cores):
            for s, ins in enumerate(cp.slots):
                if ins is not None:
                    placed[c][id(ins)] = s
        slot_of = [[placed[core_of_proc[p]][id(ins)] for ins in instrs]
                   for p, instrs in enumerate(core_instrs)]
        sigma, _ = _commit_sigma(core_instrs, core_of_proc, hw,
                                 send_dst_core, commit_def, slot_of,
                                 comb.t_compute)
        floor = _pipeline_floors(core_instrs, hoist, sigma, slot_of)
        busy, _lb, _ab = _resource_sets(comb, hw, send_dst_core)
        return slot_of, max(floor, max((len(b) for b in busy), default=1))

    def _attempt(comb: ScheduleResult, slot_of, floor: int, stop: int):
        """Search II upward from the data/occupancy floor; at each
        candidate repair modulo collisions by relocating slack
        instructions, then re-verify the repaired placement from
        scratch."""
        span = comb.vcpl
        t_comp = comb.t_compute
        for ii in range(floor, min(span, stop)):
            rep = _repair_modulo(comb, core_instrs, core_of_proc, hw,
                                 preds_all, succs_all, P, ii, slot_of)
            if rep is None:
                continue
            slots_c, pos = rep
            cand = ScheduleResult(
                [CoreProgram(slots_c[c], comb.cores[c].recv_count,
                             comb.cores[c].sends)
                 for c in range(ncores)],
                t_comp, span, dict(comb.stats))
            sigma2, ranks2 = _commit_sigma(core_instrs, core_of_proc, hw,
                                           send_dst_core, commit_def, pos,
                                           t_comp)
            if _pipeline_floors(core_instrs, hoist, sigma2, pos) > ii:
                continue
            busy2, lb2, ab2 = _resource_sets(cand, hw, send_dst_core)
            if _modulo_conflict(ii, busy2, lb2, ab2):
                continue
            info = PipelineInfo(
                ii=ii, prologue_len=P, span=span, hoist=hoist, share=share,
                commit_def=commit_def, replay_rank=ranks2,
                stats={"ii": ii, "prologue_len": P, "span": span,
                       "hoisted": sum(len(h) for h in hoist)})
            return cand, info
        return None

    stop = base.vcpl if base is not None else (1 << 30)
    comb = _assemble(None)
    slot_of, floor = _floor_of(comb)
    best = _attempt(comb, slot_of, floor, stop)
    if best is not None:
        stop = best[1].ii

    # head-clearance rounds: the dominant steady-state collision is the
    # epilogue replay tail of iteration n wrapping onto the stream head of
    # iteration n+1 on the receiving cores.  Reschedule with a per-core
    # min_ready floor that keeps each receiving core's head clear of its
    # own wrapped replay residues, then search again; iterate while the
    # data floor keeps moving (the delayed heads also delay replay-fed
    # readers, which lowers the floor's sigma - s demand).
    t_comp, target = comb.t_compute, floor
    recv_of = [cp.recv_count for cp in comb.cores]
    for _round in range(3):
        extra = [max(0, t_comp + recv_of[core_of_proc[p]] - target)
                 if recv_of[core_of_proc[p]] else 0 for p in range(nproc)]
        if not any(extra):
            break
        comb = _assemble(extra)
        slot_of, floor = _floor_of(comb)
        got = _attempt(comb, slot_of, floor, stop)
        if got is not None:
            best, stop = got, got[1].ii
        t_comp, target = comb.t_compute, floor
        recv_of = [cp.recv_count for cp in comb.cores]
    return best


# ----------------------------------------------------------------------
# independent validator
# ----------------------------------------------------------------------

def validate_schedule(res: ScheduleResult,
                      core_instrs: List[List[Instr]],
                      core_of_proc: List[int],
                      hw: HardwareConfig,
                      send_dst_core: Dict[int, int],
                      war_edges: List[List[Tuple[int, int]]],
                      order_edges: List[List[Tuple[int, int]]],
                      pipeline: Optional[PipelineInfo] = None
                      ) -> Dict[str, int]:
    """Independently re-check a :class:`ScheduleResult` against the machine
    model: every instruction placed exactly once on its process's core, RAW
    def->use distance >= ``hw.raw_latency``, WAR/memory-order edges strictly
    respected, NoC link slots collision-free, arrival slots unique per
    destination and within ``t_compute``, receive counts and VCPL
    consistent. Raises :class:`ValueError` on the first violation; returns
    summary counts when the schedule is valid.

    With ``pipeline`` given the modulo overlay is checked too: prologue
    region purity, commit visibility recomputation, cross-iteration RAW
    distances and commit-order safety, prologue-carry WAR, cross-iteration
    memory ordering, and core/link/arrival claims collision-free modulo the
    initiation interval (see :class:`PipelineInfo`)."""
    L = hw.raw_latency
    # the partitioner duplicates instruction *objects* across processes
    # (cone duplication), so placement is keyed per core, where each object
    # occupies exactly one slot
    placed: List[Dict[int, int]] = [{} for _ in res.cores]
    for c, cp in enumerate(res.cores):
        if len(cp.slots) != res.t_compute:
            raise ValueError(
                f"core {c}: stream length {len(cp.slots)} != t_compute "
                f"{res.t_compute}")
        for s, ins in enumerate(cp.slots):
            if ins is None:
                continue
            if id(ins) in placed[c]:
                raise ValueError(
                    f"instruction placed twice on core {c}: {ins!r}")
            placed[c][id(ins)] = s

    send_ids: Set[int] = set()
    n_placed = sum(len(m) for m in placed)
    for p, instrs in enumerate(core_instrs):
        c = core_of_proc[p]
        defs: Dict[int, int] = {}
        slots: List[int] = []
        for i, ins in enumerate(instrs):
            slot = placed[c].get(id(ins))
            if slot is None:
                raise ValueError(f"proc {p} instr {i} missing from core {c}")
            slots.append(slot)
            for src in ins.srcs:
                d = defs.get(src)
                if d is not None and slot - slots[d] < L:
                    raise ValueError(
                        f"RAW violation proc {p}: {d}->{i} distance "
                        f"{slot - slots[d]} < {L}")
            w = ins.writes()
            if w is not None and w != 0:
                defs[w] = i
            if ins.op == Op.SEND:
                send_ids.add(id(ins))
        for (a, b) in war_edges[p] + order_edges[p]:
            if slots[b] <= slots[a]:
                raise ValueError(
                    f"order violation proc {p}: {a}(slot {slots[a]}) !< "
                    f"{b}(slot {slots[b]})")

    link_busy: Dict[Tuple[str, int, int], Set[int]] = {}
    arrival_busy: Dict[int, Set[int]] = {}
    recv = [0] * hw.num_cores
    listed: Set[int] = set()
    for c, cp in enumerate(res.cores):
        for (ts, ins) in cp.sends:
            if placed[c].get(id(ins)) != ts:
                raise ValueError(
                    f"send list slot ({c},{ts}) disagrees with placement "
                    f"{placed[c].get(id(ins))}")
            listed.add(id(ins))
            dst = send_dst_core[id(ins)]
            links = _route(hw, c, dst)
            if not links:
                continue           # local move: no NoC claims, no replay
            for k, lk in enumerate(links):
                sl = ts + 1 + k * hw.send_latency
                if sl in link_busy.setdefault(lk, set()):
                    raise ValueError(f"link collision on {lk} at slot {sl}")
                link_busy[lk].add(sl)
            arrive = ts + 1 + len(links) * hw.send_latency
            if arrive in arrival_busy.setdefault(dst, set()):
                raise ValueError(
                    f"arrival collision at core {dst} slot {arrive}")
            arrival_busy[dst].add(arrive)
            if arrive > res.t_compute:
                raise ValueError(
                    f"arrival {arrive} past t_compute {res.t_compute}")
            recv[dst] += 1
    if listed != send_ids:
        raise ValueError("send lists do not cover exactly the SEND instrs")
    for c, cp in enumerate(res.cores):
        if cp.recv_count != recv[c]:
            raise ValueError(
                f"core {c} recv_count {cp.recv_count} != derived {recv[c]}")
    epilogue = max(recv) if recv else 0
    if res.vcpl != res.t_compute + epilogue:
        raise ValueError(
            f"vcpl {res.vcpl} != t_compute {res.t_compute} + epilogue "
            f"{epilogue}")

    if pipeline is not None:
        _validate_pipeline(res, core_instrs, core_of_proc, hw,
                           send_dst_core, placed, pipeline)
    return {"instrs": n_placed, "sends": len(send_ids)}


def _validate_pipeline(res: ScheduleResult,
                       core_instrs: List[List[Instr]],
                       core_of_proc: List[int],
                       hw: HardwareConfig,
                       send_dst_core: Dict[int, int],
                       placed: List[Dict[int, int]],
                       info: PipelineInfo) -> None:
    """Modulo-overlay legality (see :class:`PipelineInfo` for the model)."""
    L = hw.raw_latency
    ii, P, span = info.ii, info.prologue_len, info.span
    t_comp = res.t_compute
    if span != res.vcpl:
        raise ValueError(f"pipeline span {span} != schedule vcpl {res.vcpl}")
    if not 1 <= ii < span:
        raise ValueError(f"initiation interval {ii} outside [1, {span})")

    slot_of = [[placed[core_of_proc[p]][id(ins)] for ins in instrs]
               for p, instrs in enumerate(core_instrs)]

    # prologue region purity: slots [0, P) hold exactly the hoisted instrs,
    # every hoisted op is a pure register op, and no SEND issues there
    hoistable = PURE_OPS | {Op.LUT}
    hoist_ids: Set[int] = set()
    for p, h in enumerate(info.hoist):
        for i in h:
            ins = core_instrs[p][i]
            hoist_ids.add(id(ins))
            if ins.op not in hoistable or ins.writes() is None:
                raise ValueError(
                    f"hoisted instr proc {p} idx {i} is not a pure "
                    f"register op: {ins!r}")
            if slot_of[p][i] >= P:
                raise ValueError(
                    f"hoisted instr proc {p} idx {i} at slot "
                    f"{slot_of[p][i]} outside prologue [0, {P})")
    for c, cp in enumerate(res.cores):
        for s in range(min(P, len(cp.slots))):
            ins = cp.slots[s]
            if ins is not None and id(ins) not in hoist_ids:
                raise ValueError(
                    f"non-hoisted instr in prologue region: core {c} "
                    f"slot {s}: {ins!r}")
        for (ts, _ins) in cp.sends:
            if ts < P:
                raise ValueError(
                    f"SEND in prologue region: core {c} slot {ts}")

    # recompute commit visibility under the recorded replay ranks (raises
    # if the ranks are not a per-core permutation of the inbound messages)
    for p, cd in enumerate(info.commit_def):
        for cur, di in cd.items():
            ins = core_instrs[p][di]
            w = ins.writes()
            shared = w is not None and info.share[p].get(w) == cur
            moved = ins.op == Op.MOV and ins.dst == cur
            if not (shared or moved):
                raise ValueError(
                    f"commit_def proc {p} vreg {cur}: instr {di} is "
                    f"neither a shared def nor a commit MOV: {ins!r}")
    sigma, _ranks = _commit_sigma(core_instrs, core_of_proc, hw,
                                  send_dst_core, info.commit_def, slot_of,
                                  t_comp, replay_rank=info.replay_rank)

    # cross-iteration RAW / commit-order, carry WAR, memory ordering
    need = _pipeline_floors(core_instrs, info.hoist, sigma, slot_of)
    if ii < need:
        raise ValueError(
            f"initiation interval {ii} below data-hazard floor {need} "
            f"(cross-iteration RAW / commit order / carry WAR / memory)")

    # resource claims must repeat collision-free modulo ii
    busy, link_busy, arrival_busy = _resource_sets(res, hw, send_dst_core)
    for c, grp in enumerate(busy):
        if len({s % ii for s in grp}) != len(grp):
            raise ValueError(
                f"core {c} issue/replay slots collide modulo {ii}")
    for lk, grp in link_busy.items():
        if len({s % ii for s in grp}) != len(grp):
            raise ValueError(f"link {lk} claims collide modulo {ii}")
    for dst, grp in arrival_busy.items():
        if len({s % ii for s in grp}) != len(grp):
            raise ValueError(
                f"arrival slots at core {dst} collide modulo {ii}")
