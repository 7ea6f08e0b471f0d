# Copy of src/repro/core/partition.py (commit aa57dc1); imports may differ.
"""Parallelism extraction: split into per-sink processes, then merge.

Paper §6.1:

  * **Split** — one process per data sink (a next-register word, a store, an
    EXPECT, or a host-visible output); each process is the backward cone of
    its sink, with DAG nodes *duplicated* across processes to maximize
    parallelism. Instructions that access the same memory must colocate, and
    all privileged instructions (GLD/GST/EXPECT, outputs) colocate in the
    privileged process.
  * **Merge** — reduce the process count to the available cores with a
    communication-aware balanced heuristic (algorithm **B**): repeatedly take
    the cheapest process and merge it with the communicating partner that
    minimizes the merged cost, where cost = instructions + Sends. Merging is
    non-linear because duplicated instructions deduplicate (set union) and
    Sends between the pair vanish. A communication-oblivious LPT baseline
    (algorithm **L**) is provided for the Fig. 9 / Table 4 ablation.

Cross-process dataflow is *exclusively* register (state) values: the producer
of a next-register value SENDs it to every remote process that reads the
register's current value, and delivery happens at the Vcycle boundary — the
static-BSP exchange.

Since PR 3 the input is the *optimized* IR (``core.opt`` runs between lower
and partition): cones are smaller, copy-propagation has collapsed MOV chains
(exposing larger fanout-free logic components to ``core.lutsynth``), and the
merge cost model — instructions + Sends — therefore prices the instructions
that will actually be scheduled. The split relies on the IR's liveness
contract: every next-register word keeps a unique defining instruction
(``Lowered.check``), so every register word is a sink here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .isa import Instr, Op
from .lower import Lowered

PRIV = -1  # pseudo-sink id for the privileged group


@dataclass
class SendEdge:
    """next-register value flowing between processes at the Vcycle boundary."""
    src_proc: int
    nxt_vreg: int       # value being sent (defined in src_proc)
    dst_proc: int
    cur_vreg: int       # register (leaf vreg) updated in dst_proc


@dataclass
class Partition:
    lowered: Lowered
    procs: List[List[int]]             # per-process instr indices (topo order)
    priv_proc: int
    proc_mems: List[List[str]]         # local memories owned per process
    sends: List[SendEdge]
    local_commits: List[Tuple[int, int, int]]  # (proc, nxt_vreg, cur_vreg)
    # commits added by core.remat: these always commit via an explicit MOV
    # (never the Wimmer-Franz register share) so the rematerialized compute
    # can float early in the schedule instead of being WAR-serialized
    # behind every local reader of the register
    remat_commits: Set[Tuple[int, int, int]] = field(default_factory=set)
    # (proc, cur_vreg) state leaves read by rematerialized cones: their
    # commits are likewise forced to MOV, otherwise the WAR edge
    # reader-before-def would splice the (low-priority) rematerialized
    # compute into the middle of the proc's critical chain
    remat_reads: Set[Tuple[int, int]] = field(default_factory=set)
    # diagnostics
    split_count: int = 0
    merge_steps: int = 0

    @property
    def num_procs(self) -> int:
        return len(self.procs)

    def clone(self) -> "Partition":
        """Independent copy for a compile arm: ``core.remat`` mutates
        ``procs``/``sends``/commit sets in place, and ``compile_circuit``
        schedules one arm per candidate placement. ``lowered`` is shared
        (read-only past partitioning); ``SendEdge``s are fresh objects
        because remat keys deletions by identity."""
        return Partition(
            self.lowered, [list(p) for p in self.procs], self.priv_proc,
            [list(m) for m in self.proc_mems],
            [SendEdge(e.src_proc, e.nxt_vreg, e.dst_proc, e.cur_vreg)
             for e in self.sends],
            list(self.local_commits),
            remat_commits=set(self.remat_commits),
            remat_reads=set(self.remat_reads),
            split_count=self.split_count, merge_steps=self.merge_steps)

    def stats(self) -> Dict[str, int]:
        sizes = [len(p) for p in self.procs]
        return {
            "procs": len(self.procs),
            "split_procs": self.split_count,
            "sends": len(self.sends),
            "instrs_total": sum(sizes),
            "instrs_max": max(sizes) if sizes else 0,
            "instrs_unique": len({i for p in self.procs for i in p}),
        }


class _Splitter:
    def __init__(self, low: Lowered):
        self.low = low
        self.defs: Dict[int, int] = low.defs()
        # state leaves = current-register vregs
        self.cur_vregs: Set[int] = low.state_vregs()

    def cone(self, sink: int) -> Tuple[FrozenSet[int], FrozenSet[int]]:
        """Backward closure from instr ``sink``. Returns (instr ids, state
        leaves read)."""
        instrs: Set[int] = set()
        reads: Set[int] = set()
        stack = [sink]
        while stack:
            idx = stack.pop()
            if idx in instrs:
                continue
            instrs.add(idx)
            for s in self.low.instrs[idx].reads():
                d = self.defs.get(s)
                if d is not None:
                    if d not in instrs:
                        stack.append(d)
                elif s in self.cur_vregs:
                    reads.add(s)
        return frozenset(instrs), frozenset(reads)


class _UF:
    def __init__(self):
        self.p: Dict[int, int] = {}

    def find(self, x: int) -> int:
        r = x
        while self.p.setdefault(r, r) != r:
            r = self.p[r]
        while self.p[x] != r:
            self.p[x], x = r, self.p[x]
        return r

    def union(self, a: int, b: int) -> int:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra
        return ra


def split(low: Lowered) -> Tuple[List[Set[int]], List[Set[int]],
                                 Dict[int, int], List[Tuple[int, int]], int,
                                 Dict[int, List[str]]]:
    """Split into maximal processes. Returns (instr sets, read sets,
    sink->group, regword (sink,cur) pairs, priv group index, group mems)."""
    sp = _Splitter(low)
    instrs = low.instrs

    # sinks
    next_vregs: Dict[int, int] = {}  # nxt vreg -> cur vreg
    for r in low.regs:
        for cw, nw in zip(r.cur, r.nxt):
            next_vregs[nw] = cw
    out_vregs = {v for vs in low.outputs.values() for v in vs}

    sinks: List[int] = []
    for idx, ins in enumerate(instrs):
        w = ins.writes()
        if ins.op in (Op.ST, Op.GST, Op.EXPECT):
            sinks.append(idx)
        elif w is not None and (w in next_vregs or w in out_vregs):
            sinks.append(idx)

    cones = {s: sp.cone(s) for s in sinks}

    uf = _UF()
    uf.find(PRIV)
    mem_anchor: Dict[str, int] = {}
    for s in sinks:
        cone_instrs, _ = cones[s]
        root = s
        for idx in cone_instrs:
            ins = instrs[idx]
            if ins.is_privileged():
                root = uf.union(PRIV, root)
            if ins.op in (Op.LD, Op.ST) and ins.mem is not None:
                if ins.mem in mem_anchor:
                    root = uf.union(mem_anchor[ins.mem], root)
                else:
                    mem_anchor[ins.mem] = root
        w = instrs[s].writes()
        if w is not None and w in out_vregs:
            uf.union(PRIV, s)

    groups: Dict[int, List[int]] = {}
    for s in sinks:
        groups.setdefault(uf.find(s), []).append(s)
    # guarantee the privileged group exists even if empty
    priv_root = uf.find(PRIV)
    groups.setdefault(priv_root, [])

    roots = sorted(groups, key=lambda r: (r != priv_root, r))
    proc_instrs: List[Set[int]] = []
    proc_reads: List[Set[int]] = []
    sink_group: Dict[int, int] = {}
    group_mems: Dict[int, List[str]] = {}
    for gi, root in enumerate(roots):
        ii: Set[int] = set()
        rr: Set[int] = set()
        for s in groups[root]:
            ci, cr = cones[s]
            ii |= ci
            rr |= cr
            sink_group[s] = gi
        proc_instrs.append(ii)
        proc_reads.append(rr)
        group_mems[gi] = sorted({m for m, anchor in mem_anchor.items()
                                 if uf.find(anchor) == root})
    regwords = [(s, next_vregs[instrs[s].writes()])
                for s in sinks if instrs[s].writes() in next_vregs]
    return proc_instrs, proc_reads, sink_group, regwords, 0, group_mems


class _MergeState:
    """Incremental cost model over groups during merging."""

    def __init__(self, proc_instrs: List[Set[int]], proc_reads: List[Set[int]],
                 sink_group: Dict[int, int],
                 regwords: List[Tuple[int, int]],
                 group_mems: Dict[int, List[str]], priv: int):
        self.instrs = proc_instrs
        self.reads = proc_reads
        self.alive = [True] * len(proc_instrs)
        self.mems = dict(group_mems)
        self.priv = priv
        # regword: owner group + cur vreg
        self.owned: List[List[int]] = [[] for _ in proc_instrs]  # cur vregs
        self.cur_owner: Dict[int, int] = {}
        for s, cur in regwords:
            g = sink_group[s]
            self.owned[g].append(cur)
            self.cur_owner[cur] = g
        self.readers: Dict[int, Set[int]] = {}
        for g, rr in enumerate(proc_reads):
            for cur in rr:
                self.readers.setdefault(cur, set()).add(g)

    def sends(self, g: int) -> int:
        n = 0
        for cur in self.owned[g]:
            n += len(self.readers.get(cur, set()) - {g})
        return n

    def cost(self, g: int) -> int:
        return len(self.instrs[g]) + self.sends(g)

    def merged_cost(self, a: int, b: int) -> int:
        ni = len(self.instrs[a] | self.instrs[b])
        ns = 0
        for g in (a, b):
            for cur in self.owned[g]:
                ns += len(self.readers.get(cur, set()) - {a, b})
        return ni + ns

    def neighbors(self, g: int) -> Set[int]:
        out: Set[int] = set()
        for cur in self.reads[g]:                 # producers of what g reads
            o = self.cur_owner.get(cur)
            if o is not None and o != g and self.alive[o]:
                out.add(o)
        for cur in self.owned[g]:                 # consumers of what g owns
            for r in self.readers.get(cur, set()):
                if r != g and self.alive[r]:
                    out.add(r)
        return out

    def merge(self, a: int, b: int) -> int:
        """Merge b into a (a must not be the one discarded if priv)."""
        if b == self.priv:
            a, b = b, a
        self.instrs[a] |= self.instrs[b]
        self.instrs[b] = set()
        for cur in self.reads[b]:
            rs = self.readers[cur]
            rs.discard(b)
            rs.add(a)
        self.reads[a] |= self.reads[b]
        self.reads[b] = set()
        for cur in self.owned[b]:
            self.cur_owner[cur] = a
        self.owned[a] += self.owned[b]
        self.owned[b] = []
        self.mems[a] = sorted(set(self.mems.get(a, [])) |
                              set(self.mems.get(b, [])))
        self.mems[b] = []
        self.alive[b] = False
        return a


def merge_balanced(state: _MergeState, num_cores: int,
                   extra_rounds: int = 64) -> int:
    """Algorithm B: communication-aware balanced merging."""
    steps = 0
    def alive_groups():
        return [g for g in range(len(state.instrs)) if state.alive[g]]

    while True:
        groups = alive_groups()
        if len(groups) <= 1:
            break
        over = len(groups) > num_cores
        if not over and extra_rounds <= 0:
            break
        costs = {g: state.cost(g) for g in groups}
        p = min(groups, key=lambda g: (costs[g], g))
        cands = state.neighbors(p)
        if not cands:
            cands = {g for g in groups if g != p}
            # fall back to the next-cheapest processes only
            cands = set(sorted(cands, key=lambda g: costs[g])[:8])
        best_q, best_c = None, None
        for q in cands:
            c = state.merged_cost(p, q)
            if best_c is None or c < best_c:
                best_q, best_c = q, c
        if best_q is None:
            break
        if not over:
            # only continue if the merge does not create a new straggler and
            # reduces total cost (fewer Sends / deduplicated instructions)
            max_cost = max(costs.values())
            if best_c >= max_cost or best_c >= costs[p] + costs[best_q]:
                extra_rounds = 0
                continue
            extra_rounds -= 1
        state.merge(p, best_q)
        steps += 1
    return steps


def merge_lpt(state: _MergeState, num_cores: int) -> int:
    """Algorithm L: communication-oblivious longest-processing-time-first."""
    groups = [g for g in range(len(state.instrs)) if state.alive[g]]
    if len(groups) <= num_cores:
        return 0
    groups.sort(key=lambda g: -state.cost(g))
    bins: List[int] = groups[:num_cores]
    loads = {g: state.cost(g) for g in bins}
    steps = 0
    for g in groups[num_cores:]:
        tgt = min(bins, key=lambda b: loads[b])
        kept = state.merge(tgt, g)
        if kept != tgt:  # priv swap
            loads[kept] = loads.pop(tgt)
            bins[bins.index(tgt)] = kept
            tgt = kept
        loads[tgt] = state.cost(tgt)
        steps += 1
    return steps


def partition(low: Lowered, num_cores: int,
              strategy: str = "balanced") -> Partition:
    proc_instrs, proc_reads, sink_group, regwords, priv, group_mems = split(low)
    split_count = sum(1 for s in proc_instrs if s)
    state = _MergeState(proc_instrs, proc_reads, sink_group, regwords,
                        group_mems, priv)
    if strategy == "balanced":
        steps = merge_balanced(state, num_cores)
    elif strategy == "lpt":
        steps = merge_lpt(state, num_cores)
    else:
        raise ValueError(strategy)

    # compact to final processes; keep privileged first
    alive = [g for g in range(len(state.instrs))
             if state.alive[g] and (state.instrs[g] or g == state.priv)]
    alive.sort(key=lambda g: (g != state.priv,))
    remap = {g: i for i, g in enumerate(alive)}

    procs = [sorted(state.instrs[g]) for g in alive]
    proc_mems = [state.mems.get(g, []) for g in alive]

    # communication edges + local commits
    cur_of_nxt: Dict[int, int] = {}
    for r in low.regs:
        for cw, nw in zip(r.cur, r.nxt):
            cur_of_nxt[nw] = cw
    nxt_def_proc: Dict[int, int] = {}
    for s, cur in regwords:
        g = state.cur_owner[cur]   # owner group after merging
        if state.alive[g]:
            nxt_def_proc[low.instrs[s].writes()] = remap[g]

    sends: List[SendEdge] = []
    local_commits: List[Tuple[int, int, int]] = []
    for nxt, cur in cur_of_nxt.items():
        owner = nxt_def_proc.get(nxt)
        if owner is None:
            continue  # dead register (no live reader anywhere, cone empty)
        readers = {remap[g] for g in state.readers.get(cur, set())
                   if state.alive[g]}
        for rproc in sorted(readers):
            if rproc == owner:
                continue
            sends.append(SendEdge(owner, nxt, rproc, cur))
        # the owner always keeps an architecturally-visible copy (hosts read
        # and checkpoint registers from their owner core), even without
        # in-process readers
        local_commits.append((owner, nxt, cur))

    return Partition(low, procs, remap.get(state.priv, 0), proc_mems, sends,
                     local_commits, split_count=split_count,
                     merge_steps=steps)
