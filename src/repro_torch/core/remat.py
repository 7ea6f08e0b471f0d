# Copy of src/repro/core/remat.py (commit aa57dc1); imports may differ.
"""Partition-aware rematerialization: trade SENDs for local recompute.

After partitioning, every remote reader of a register receives its next
value over the NoC — one SEND issue slot at the producer, ``hops`` link
slots in flight, a unique arrival slot, and one epilogue replay slot at
the receiver (paper §5.2). When the next value is a *cheap pure cone*
(a constant, a MOV, a one-or-two-instruction expression) whose state
inputs the receiver already holds, recomputing it locally is strictly
cheaper than shipping it: the SEND disappears from the schedule and the
receiver pays a few compute slots it usually hides under its existing
stream.

The pass runs between :func:`~repro.core.partition.partition` and
:func:`~repro.core.schedule.schedule`, mutating the
:class:`~repro.core.partition.Partition` in place:

  * for each inbound :class:`~repro.core.partition.SendEdge` whose next
    value has a pure backward cone of at most ``max_cone`` instructions
    (``core.opt.pure_backward_cone`` over ``isa.PURE_OPS``), and whose
    current-register inputs are all already *available* on the consumer
    (owned, received over a surviving edge, or themselves rematerialized),
  * accept when the duplicated instruction count does not exceed the
    route cost (``1 + hops * send_latency + 1``: issue + flight + replay)
    and does not push the consumer's load past the pre-pass global
    maximum (rematerialization must never create a new straggler core),
  * on accept: union the cone into the consumer's instruction list,
    delete the edge, and append a local commit so the consumer updates
    its copy of the register every Vcycle — induction keeps
    self-recurrent cones (``nxt`` reading its own ``cur``) correct.

The pass only ever *removes* communication; it never adds a send. It is
run for the ``"slack"`` scheduling strategy only, keeping the
``"greedy"`` differential path bit-identical to the frozen baseline.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .isa import HardwareConfig
from .lower import Lowered
from .partition import Partition, SendEdge
from .opt import pure_backward_cone

DEFAULT_MAX_CONE = 4


def rematerialize(low: Lowered, part: Partition, hw: HardwareConfig,
                  core_of_proc: Optional[List[int]] = None,
                  max_cone: int = DEFAULT_MAX_CONE) -> Dict[str, int]:
    """Delete SendEdges whose payload is cheaper to recompute locally.

    Mutates ``part`` (``procs``, ``sends``, ``local_commits``) in place and
    returns the pass statistics. ``core_of_proc`` defaults to the identity
    placement used by :func:`~repro.core.compile.compile_circuit`.
    """
    if core_of_proc is None:
        core_of_proc = list(range(part.num_procs))
    defs = low.defs()

    owner_of_cur: Dict[int, int] = {}
    for (p, _nxt, cur) in part.local_commits:
        owner_of_cur[cur] = p

    # per-process load (instrs + outbound sends) — the straggler cap
    load = [len(p) for p in part.procs]
    inbound: Dict[int, List[SendEdge]] = {}
    for e in part.sends:
        load[e.src_proc] += 1
        inbound.setdefault(e.dst_proc, []).append(e)
    cap = max(load) if load else 0

    owned: List[Set[int]] = [set() for _ in part.procs]
    for (p, _nxt, cur) in part.local_commits:
        owned[p].add(cur)
    recv_curs: List[Set[int]] = [set() for _ in part.procs]
    for e in part.sends:
        recv_curs[e.dst_proc].add(e.cur_vreg)
    rematted: List[Set[int]] = [set() for _ in part.procs]

    # live receive counts: the epilogue-setting receiver may exceed the
    # load cap by at most the replay slots it has shed (each slot over the
    # cap risks +1 t_compute but is paid for by a guaranteed -1 epilogue)
    recv_now = [len(inbound.get(p, ())) for p in range(part.num_procs)]
    shed = [0] * part.num_procs

    cone_cache: Dict[int, Optional[Tuple[FrozenSet[int], FrozenSet[int]]]] = {}

    def cone_of(nxt: int):
        if nxt not in cone_cache:
            cone_cache[nxt] = pure_backward_cone(low, nxt, max_cone,
                                                 defs=defs)
        return cone_cache[nxt]

    deleted: Set[int] = set()          # id(edge)
    new_commits: List[Tuple[int, int, int]] = []
    sends_deleted = 0
    instrs_added = 0
    procs_touched: Set[int] = set()

    # hottest receivers first: they set the epilogue and gain the most
    order = sorted(inbound, key=lambda d: (-len(inbound[d]), d))
    for d in order:
        proc_set = set(part.procs[d])
        changed = True
        while changed:
            changed = False
            for e in sorted(inbound[d], key=lambda e: (e.cur_vreg,
                                                       e.src_proc)):
                if id(e) in deleted:
                    continue
                cone = cone_of(e.nxt_vreg)
                if cone is None:
                    continue
                cone_idx, state_reads = cone
                new = cone_idx - proc_set
                avail = owned[d] | recv_curs[d] | rematted[d]
                if any(s in owner_of_cur and s not in avail
                       for s in state_reads):
                    continue
                hops = hw.route_hops(core_of_proc[e.src_proc],
                                     core_of_proc[e.dst_proc])
                route_cost = 1 + hops * hw.send_latency + 1
                if len(new) > route_cost:
                    continue
                over = load[d] + len(new) - cap
                if over > 0:
                    other_max = max((recv_now[p]
                                     for p in range(part.num_procs)
                                     if p != d), default=0)
                    if not (recv_now[d] > other_max
                            and over <= shed[d] + 1):
                        continue
                proc_set |= new
                load[d] += len(new)
                load[e.src_proc] -= 1
                recv_now[d] -= 1
                shed[d] += 1
                for s in state_reads:
                    if s in owner_of_cur:
                        part.remat_reads.add((d, s))
                recv_curs[d].discard(e.cur_vreg)
                rematted[d].add(e.cur_vreg)
                deleted.add(id(e))
                new_commits.append((d, e.nxt_vreg, e.cur_vreg))
                sends_deleted += 1
                instrs_added += len(new)
                procs_touched.add(d)
                changed = True
        if d in procs_touched:
            part.procs[d] = sorted(proc_set)

    if deleted:
        part.sends = [e for e in part.sends if id(e) not in deleted]
        part.local_commits.extend(new_commits)
        part.remat_commits.update(new_commits)

    for e in part.sends:
        assert core_of_proc[e.src_proc] != core_of_proc[e.dst_proc], (
            "self-route SEND survived rematerialization: "
            f"{e.src_proc}->{e.dst_proc}")

    return {
        "remat_sends": sends_deleted,
        "remat_instrs": instrs_added,
        "remat_procs": len(procs_touched),
    }
