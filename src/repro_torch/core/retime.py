# Copy of src/repro/core/retime.py (commit aa57dc1); imports may differ.
"""Boundary retiming: choose the work that crosses the Vcycle commit.

Cross-Vcycle software pipelining (``core.schedule.pipeline_schedule``)
overlaps consecutive Vcycles: slots of cycle k+1 that depend only on state
already committed by cycle k issue during cycle k's epilogue / idle tail.
This pass picks *which* instructions those are — the **hoist set** H, one
set per process. A hoisted instruction is executed in the schedule's
prologue region (slots ``[0, P)``) and, by the rotated engine convention,
realized at the *end* of the previous engine Vcycle, gated on "no exception
raised" — which is exactly retiming a pure op backwards across the
register-commit boundary.

Legality (per process ``p``, instruction ``i``):

  * **pure** — ``op in PURE_OPS | {LUT}`` with a register result. No
    memory traffic (a prologue never touches scratchpads), no SEND, no
    privileged op: the hoisted value lives only in its destination
    register, so withholding the whole prologue on an exception is a
    single register-plane select in every engine.
  * **not a commit** — the destination must not be architectural state:
    not a register-share commit (those write the current register
    directly), not a commit-MOV, and not a host-visible output vreg (a
    hoisted output would be one cycle ahead of the netlist oracle).
  * **committed-state sources only** — every source is either (a) defined
    by another hoisted instruction of ``p`` (the hoist set is
    ancestor-closed), (b) an uncommitted leaf (constant / pinned init), or
    (c) a *locally* committed current register whose baseline commit
    becomes visible by slot ``theta`` — late commits would drag the
    initiation interval right back up (the cross-iteration RAW constraint
    is ``II >= sigma - s``).  Exchange-fed registers are never eligible:
    their commit is the epilogue replay, ``sigma ~ t_compute``.

Selection is budgeted and height-ranked: instructions at the head of the
latency-weighted critical chain hoist first (their removal shortens the
body's span, which is the only way a prologue lowers II), until the
per-core budget — sized to the schedule's idle tail,
``(vcpl - crit_path_lb) + epilogue`` — is spent. Because a predecessor's
height strictly exceeds its consumer's, ranking by height admits ancestors
before dependants, keeping the set closed by construction.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .isa import HardwareConfig, Instr, Op, PURE_OPS
from .schedule import RAW, ScheduleResult, _build_deps

HOISTABLE_OPS = frozenset(PURE_OPS | {Op.LUT})


def plan_retime(core_instrs: List[List[Instr]],
                core_of_proc: List[int],
                hw: HardwareConfig,
                base: ScheduleResult,
                share: List[Dict[int, int]],
                commit_def: List[Dict[int, int]],
                war_edges: List[List[Tuple[int, int]]],
                order_edges: List[List[Tuple[int, int]]],
                output_vregs: Set[int],
                theta: int,
                budget: int) -> List[Set[int]]:
    """Per-process hoist sets for the modulo pipeliner.

    ``base`` is the unpipelined schedule (slot positions feed the
    commit-visibility test). ``commit_def[p]`` maps each locally committed
    current-register vreg to its committing instruction index (the shared
    next-value def or the commit MOV). ``theta`` caps the baseline
    visibility slot of any current-register source (``theta < 0`` forbids
    committed-register sources entirely — the conservative arm).
    ``budget`` caps hoisted instructions per core.
    """
    L = hw.raw_latency
    nproc = len(core_instrs)
    preds, succs = _build_deps(core_instrs, war_edges, order_edges)

    # baseline slot of every instruction (placement keyed per core by id)
    placed: List[Dict[int, int]] = [{} for _ in base.cores]
    for c, cp in enumerate(base.cores):
        for s, ins in enumerate(cp.slots):
            if ins is not None:
                placed[c][id(ins)] = s

    hoist: List[Set[int]] = [set() for _ in range(nproc)]
    if budget <= 0:
        return hoist

    for p, instrs in enumerate(core_instrs):
        if not instrs:
            continue
        c = core_of_proc[p]
        slot_of = [placed[c].get(id(ins), 0) for ins in instrs]

        # vregs whose write is a commit: shared next-value defs, commit-MOV
        # destinations, and exchange-fed current registers of *other* procs
        # (the SEND payload def itself stays hoistable — the SEND reads it
        # from the body under the prologue->body RAW constraint).
        commit_dsts: Set[int] = set(share[p])            # nxt of shared
        for cur, di in commit_def[p].items():
            commit_dsts.add(instrs[di].dst)              # cur (MOV) or nxt

        # locally committed curs and their visibility slots; exchange-fed
        # curs (inbound SENDs) are poisoned outright.
        sigma0: Dict[int, int] = {}
        for cur, di in commit_def[p].items():
            sigma0[cur] = slot_of[di] + L
        poisoned: Set[int] = set()
        for q, qinstrs in enumerate(core_instrs):
            for ins in qinstrs:
                if ins.op == Op.SEND and ins.send_dst_proc == p:
                    poisoned.add(ins.send_dst_vreg)

        # RAW def per source, from the incremental dependence graph (a
        # current register read *before* its commit-MOV must resolve to the
        # committed leaf, not to the MOV that recommits it later)
        pred_of_src: List[Dict[int, int]] = []
        for i in range(len(instrs)):
            m: Dict[int, int] = {}
            for (j, kind) in preds[p][i]:
                if kind == RAW:
                    w = instrs[j].writes()
                    if w is not None:
                        m[w] = j
            pred_of_src.append(m)

        # forward eligibility pass (lists are topo-ordered, so every local
        # def precedes its readers and one pass reaches the fixpoint)
        eligible: List[bool] = [False] * len(instrs)
        for i, ins in enumerate(instrs):
            w = ins.writes()
            if (ins.op not in HOISTABLE_OPS or w is None or w == 0
                    or w in commit_dsts or w in output_vregs):
                continue
            # a WAR/ORDER predecessor pins the instruction into the body
            if any(k != RAW for (_, k) in preds[p][i]):
                continue
            ok = True
            for s in ins.srcs:
                if s in poisoned:
                    ok = False
                    break
                d = pred_of_src[i].get(s)
                if d is not None:
                    if not eligible[d]:
                        ok = False
                        break
                elif s in sigma0:
                    if theta < 0 or sigma0[s] > theta:
                        ok = False
                        break
                # else: uncommitted leaf (constant / pinned init) — fine
            eligible[i] = ok

        if not any(eligible):
            continue

        # latency-weighted height to the schedule exit: chain heads first
        height = [1] * len(instrs)
        for i in range(len(instrs) - 1, -1, -1):
            best = 1
            for (j, kind) in succs[p][i]:
                lat = L if kind == RAW else 1
                if lat + height[j] > best:
                    best = lat + height[j]
            height[i] = best

        order = sorted((i for i in range(len(instrs)) if eligible[i]),
                       key=lambda i: (-height[i], i))
        chosen = hoist[p]
        for i in order:
            if len(chosen) >= budget:
                break
            # ancestor-closed: every locally defined source already chosen
            # (a predecessor's height strictly exceeds its consumer's, so
            # ranking by height admits ancestors first; a budget-evicted
            # ancestor simply drops its dependants here)
            if all(d in chosen for d in pred_of_src[i].values()):
                chosen.add(i)
    return hoist
