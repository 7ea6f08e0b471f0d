# Copy of src/repro/core/compile.py (commit aa57dc1); imports may differ.
"""End-to-end compiler: Circuit -> executable Program.

Pipeline (paper Fig. 4, plus the PR 3 optimizing middle-end — see
``docs/compiler.md``): lower -> **opt pass pipeline** (``core.opt``:
constant folding, copy propagation, strength reduction, CSE, DCE) ->
split/merge partition -> custom-function synthesis -> SEND insertion +
commit planning -> list scheduling + NoC routing -> register allocation ->
binary (dense arrays consumed by the static-BSP executors in ``core.bsp``
/ ``kernels``). ``optimize=False`` skips the middle-end entirely and is
bit-identical to the legacy path (the fixed cross-PR baseline).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from .isa import HardwareConfig, Instr, NUM_FIELDS, Op, WORD_MASK
from .lower import InitVal, Lowered, Reloc, def_index, lower
from .lutsynth import synthesize
from .opt import optimize_lowered
from .netlist import Circuit
from .partition import Partition, SendEdge, partition
from .place import PLACEMENTS, hop_cost, place
from .regalloc import CoreAlloc, allocate
from .remat import rematerialize
from .retime import plan_retime
from .schedule import (PIPELINES, PipelineInfo, ScheduleResult,
                       pipeline_schedule, schedule, validate_schedule)


@dataclass
class Program:
    """Compiled Manticore binary + static exchange schedule."""
    name: str
    hw: HardwareConfig
    code: np.ndarray           # [C, T, 7] int32 (op,dst,s1..s4,imm)
    luts: np.ndarray           # [C, 32, 16] uint16
    reg_init: np.ndarray       # [C, R] uint16
    spad_init: np.ndarray      # [C, S] uint16
    gmem_init: np.ndarray      # [G] uint16
    # static BSP exchange: value produced at (src_core, src_slot) lands in
    # (dst_core, dst_mreg) at the Vcycle boundary.
    xchg_src_core: np.ndarray  # [M] int32
    xchg_src_slot: np.ndarray  # [M] int32
    xchg_dst_core: np.ndarray  # [M] int32
    xchg_dst_reg: np.ndarray   # [M] int32
    t_compute: int
    vcpl: int
    used_cores: int
    outputs: Dict[str, Tuple[int, List[int]]]      # name -> (core, mregs)
    state_regs: Dict[str, List[List[Tuple[int, int]]]]  # reg -> per-word [(core, mreg), ...]
    stats: Dict[str, float] = field(default_factory=dict)
    # partial-evaluation metadata (filled by compile_circuit; recomputed on
    # demand for Programs built by hand, e.g. in tests): per-slot opcode
    # bitmask over the used cores, bit i set iff Op(i) appears in slot i.
    slot_op_mask: Optional[np.ndarray] = None      # [T] uint64
    # cross-Vcycle pipelining: the first pipe_prologue code slots are the
    # retimed prologue of the *next* Vcycle — the engines execute them at
    # the end of each cycle on post-exchange state, gated on "no exception
    # raised" (0 = unpipelined; see core.schedule.PipelineInfo)
    pipe_prologue: int = 0

    @property
    def num_cores(self) -> int:
        return self.code.shape[0]

    @property
    def has_global(self) -> bool:
        return bool(self.stats.get("global_ops", 0))

    @property
    def n_sends(self) -> int:
        return int(self.xchg_src_core.shape[0])

    def _op_masks(self) -> np.ndarray:
        if self.slot_op_mask is None:
            self.slot_op_mask = slot_op_masks(self.code, self.used_cores)
        return self.slot_op_mask

    def used_reg_count(self) -> int:
        """Number of machine registers the program can ever touch (max
        register index referenced by any used core's code or by the
        exchange, plus one). Register allocation only hands out registers
        that some instruction references, so slicing every per-core
        register file to this width is lossless — and it is what makes
        batched state ([B, C, R]) cache/VMEM-friendly: the paper's
        2048-entry BRAM file is free in hardware, but an interpreter
        should not carry the unused tail."""
        C = max(1, min(self.used_cores, self.code.shape[0]))
        r = int(self.code[:C, :, 1:6].max()) if self.code.size else 0
        if self.n_sends:
            r = max(r, int(self.xchg_dst_reg.max()))
        return min(r + 1, self.hw.num_regs)

    def op_set(self) -> frozenset:
        """Set of opcodes the program actually contains (used cores only).

        This is the compile-time knowledge the engines specialize on: a
        program with no LUT never pays the 16-pattern loop, one with no
        GLD/GST skips the cache model entirely, etc.
        """
        mask = int(np.bitwise_or.reduce(self._op_masks())) if \
            self._op_masks().size else 0
        return frozenset(Op(i) for i in range(64) if (mask >> i) & 1)

    def init_images(self, reg_plane: Dict[str, int],
                    mem_plane: Optional[Dict[str, List[int]]] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Apply one stimulus init plane to the base binary images.

        ``reg_plane`` maps RTL register name -> init value; every machine
        register holding a word of that register (owner *and* duplicated
        reader copies, from ``state_regs``) is patched. ``mem_plane`` maps
        memory name -> flattened 16-bit word image, placed at the memory's
        base via ``stats["mem_layout"]``. Returns fresh
        ``(reg_init, spad_init, gmem_init)`` arrays — the compiled
        ``code``/``luts`` are untouched, which is the whole point: B
        stimuli share one schedule and differ only in initial state.
        """
        reg_init = self.reg_init.copy()
        spad_init = self.spad_init.copy()
        gmem_init = self.gmem_init.copy()
        for name, val in reg_plane.items():
            words = self.state_regs.get(name)
            assert words is not None, (
                f"register {name!r} not in state_regs — its words were "
                "optimized away and cannot carry a per-stimulus init")
            for j, locs in enumerate(words):
                w = (int(val) >> (16 * j)) & WORD_MASK
                for (core, mreg) in locs:
                    reg_init[core, mreg] = w
        layout = self.stats.get("mem_layout", {})
        for name, image in (mem_plane or {}).items():
            core, base, size, is_global = layout[name]
            w = np.asarray(image, dtype=np.uint16)
            assert w.shape[0] <= size, (name, w.shape[0], size)
            if is_global:
                gmem_init[base:base + w.shape[0]] = w
            else:
                spad_init[core, base:base + w.shape[0]] = w
        return reg_init, spad_init, gmem_init

    def init_images_batch(self, reg_planes: Sequence[Dict[str, int]],
                          mem_planes: Optional[Sequence] = None,
                          workers: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All B stimulus init images, generated **host-parallel** and
        stacked directly into the batched ``([B, C, R], [B, C, S],
        [B, G])`` layout the batched/sharded engines consume.

        ``init_images`` is pure host-side numpy patching; at large B it
        was the last serial stage of a batched launch. Each worker thread
        writes its stimulus straight into its row of the pre-allocated
        stacked arrays (no per-stimulus tuple list, no ``np.stack`` copy
        at the end). ``workers=None`` sizes the pool to ``os.cpu_count()``;
        ``workers=1`` (or B == 1) runs inline.
        """
        import os
        from concurrent.futures import ThreadPoolExecutor

        B = len(reg_planes)
        if mem_planes is None:
            mem_planes = [None] * B
        assert len(mem_planes) == B, (len(mem_planes), B)
        regs = np.empty((B,) + self.reg_init.shape, self.reg_init.dtype)
        spads = np.empty((B,) + self.spad_init.shape, self.spad_init.dtype)
        gmems = np.empty((B,) + self.gmem_init.shape, self.gmem_init.dtype)

        def one(b: int) -> None:
            r, s, g = self.init_images(reg_planes[b], mem_planes[b])
            regs[b], spads[b], gmems[b] = r, s, g

        if workers is None:
            workers = min(B, os.cpu_count() or 1)
        if B <= 1 or workers <= 1:
            for b in range(B):
                one(b)
        else:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(one, range(B)))
        return regs, spads, gmems

    def save(self, path):
        """Persist this compiled Program as a single versioned ``.npz``
        artifact (see :mod:`repro.sim.artifact`). ``Program.load(path)``
        restores it bit-exactly — arrays, exchange tables,
        ``outputs``/``state_regs`` maps and ``stats`` — so the middle-end
        cost is paid once per design, not once per process."""
        from ..sim.artifact import save_program
        return save_program(self, path)

    @staticmethod
    def load(path) -> "Program":
        from ..sim.artifact import load_program
        return load_program(path)

    def send_capture(self, C: int) -> np.ndarray:
        """[T, C] int32 capture-index table: entry (t, c) is the flat SEND
        index whose value is produced at slot t on core c, or ``n_sends``
        (a sacrificial slot) everywhere else. The engines scatter each
        slot's results through this table into a compact ``[n_sends + 1]``
        buffer instead of materializing the full [T, C] trace."""
        T = self.code.shape[1]
        cap = np.full((T, C), self.n_sends, np.int32)
        for i in range(self.n_sends):
            t = int(self.xchg_src_slot[i])
            c = int(self.xchg_src_core[i])
            if c < C:
                cap[t, c] = i
        return cap


def slot_groups(program: "Program", C: int):
    """Partially evaluate the code stream into per-slot opcode groups.

    Returns a list over slots of lists of
    ``(op, cores, dst, s1, s2, s3, s4, imm, sid)`` — one entry per opcode
    present in that slot with the (static) core batch executing it, its
    decoded fields, and each lane's compact SEND-capture index. All-NOP
    slots produce empty lists, NOP lanes are dropped entirely: both the
    numpy ISA simulator and the unrolled jnp engine execute *only* the
    instructions the schedule actually contains.
    """
    from .isa import Op as _Op
    code = program.code[:C]
    cap = program.send_capture(C)
    T = code.shape[1]
    out = []
    for t in range(T):
        ops_t = code[:, t, 0]
        groups = []
        for opcode in np.unique(ops_t):
            if opcode == int(_Op.NOP):
                continue
            cores = np.nonzero(ops_t == opcode)[0]
            w = code[cores, t]
            groups.append((_Op(int(opcode)), cores, w[:, 1], w[:, 2],
                           w[:, 3], w[:, 4], w[:, 5],
                           w[:, 6].astype(np.uint32), cap[t, cores]))
        out.append(groups)
    return out


def slot_op_masks(code: np.ndarray, used_cores: int) -> np.ndarray:
    """Per-slot opcode-usage bitmask over the first ``used_cores`` cores.

    code is [C, T, 7]; returns [T] uint64 with bit ``op`` set iff any used
    core executes ``op`` in that slot."""
    C = max(1, min(used_cores, code.shape[0]))
    ops = code[:C, :, 0].astype(np.uint64)          # [C, T]
    masks = np.left_shift(np.uint64(1), ops)        # NOP -> bit 0 (harmless)
    return np.bitwise_or.reduce(masks, axis=0) if masks.size else \
        np.zeros((code.shape[1],), np.uint64)


def _raw_adjacency(instrs: List[Instr]) -> Dict[int, List[int]]:
    """RAW def->use adjacency within one process."""
    defs = def_index(instrs)
    adj: Dict[int, List[int]] = {}
    for i, ins in enumerate(instrs):
        for s in ins.srcs:
            d = defs.get(s)
            if d is not None:
                adj.setdefault(d, []).append(i)
    return adj


def _reachable(adj: Dict[int, List[int]], start: int) -> Set[int]:
    out: Set[int] = set()
    stack = [start]
    while stack:
        i = stack.pop()
        for u in adj.get(i, ()):
            if u not in out:
                out.add(u)
                stack.append(u)
    return out


@dataclass
class _Arm:
    """One scheduled compile arm: a candidate placement taken through
    remat + lutsynth + SEND insertion + commit planning + scheduling."""
    name: str
    core_of_proc: List[int]
    part: Partition
    proc_instrs: List[List[Instr]]
    proc_tables: List[List[Tuple[int, ...]]]
    send_dst_core: Dict[int, int]
    send_meta: List[Tuple[SendEdge, Instr]]
    war_edges: List[List[Tuple[int, int]]]
    order_edges: List[List[Tuple[int, int]]]
    share: List[Dict[int, int]]
    commit_def: List[Dict[int, int]]
    commit_movs: int
    shared_commits: int
    remat_stats: Dict[str, int]
    sched: ScheduleResult


def _compile_arm(name: str, core_of_proc: List[int], low: Lowered,
                 part: Partition, hw: HardwareConfig, use_luts: bool,
                 sched_strategy: str, check: bool,
                 tm: Dict[str, float]) -> _Arm:
    """Take one candidate placement through the placement-dependent
    backend: rematerialization (route costs), LUT synthesis, SEND
    insertion (destination cores), commit planning, and scheduling (NoC
    link/arrival reservation). ``part`` is mutated — pass a clone when
    scheduling more than one arm."""
    nproc = part.num_procs

    # ---- partition-aware rematerialization (slack strategy only: the
    # greedy path stays bit-identical to the frozen differential baseline)
    remat_stats: Dict[str, int] = {"remat_sends": 0, "remat_instrs": 0,
                                   "remat_procs": 0}
    if sched_strategy == "slack":
        t0 = time.perf_counter()
        remat_stats = rematerialize(low, part, hw,
                                    core_of_proc=core_of_proc)
        tm["remat"] = tm.get("remat", 0.0) + time.perf_counter() - t0

    # protected vregs: values with consumers outside the instruction lists
    # (the same liveness roots the opt passes preserve)
    protected: Set[int] = low.protected_vregs()

    # ---- per-process instruction lists + LUT synthesis -----------------
    t0 = time.perf_counter()
    proc_instrs: List[List[Instr]] = []
    proc_tables: List[List[Tuple[int, ...]]] = []
    for p in part.procs:
        instrs = [low.instrs[i] for i in p]
        if use_luts:
            instrs, tables = synthesize(instrs, low.const_vregs,
                                        frozenset(protected),
                                        max_tables=hw.num_luts)
        else:
            tables = []
        proc_instrs.append(instrs)
        proc_tables.append(tables)
    tm["lutsynth"] = tm.get("lutsynth", 0.0) + time.perf_counter() - t0

    # ---- SEND insertion + commit planning --------------------------------
    send_dst_core: Dict[int, int] = {}
    send_meta: List[Tuple[SendEdge, Instr]] = []
    for e in part.sends:
        ins = Instr(Op.SEND, 0, (e.nxt_vreg,),
                    send_dst_proc=e.dst_proc, send_dst_vreg=e.cur_vreg)
        proc_instrs[e.src_proc].append(ins)
        send_dst_core[id(ins)] = core_of_proc[e.dst_proc]
        send_meta.append((e, ins))

    war_edges: List[List[Tuple[int, int]]] = [[] for _ in range(nproc)]
    order_edges: List[List[Tuple[int, int]]] = [[] for _ in range(nproc)]
    share: List[Dict[int, int]] = [dict() for _ in range(nproc)]
    # cur vreg -> index of its committing instr (shared def or commit MOV):
    # the pipeliner derives commit-visibility slots from this
    commit_def: List[Dict[int, int]] = [dict() for _ in range(nproc)]
    commit_movs = 0
    shared_commits = 0
    # incremental dependence graph per process (RAW + accepted WAR edges):
    # a share is legal only if adding reader->def edges keeps it acyclic,
    # i.e. no reader of cur is reachable from def(nxt). Mutually-swapping
    # registers (r0'=r1; r1'=r0) would otherwise deadlock the scheduler.
    proc_adj: List[Optional[Dict[int, List[int]]]] = [None] * nproc
    for (p, nxt, cur) in part.local_commits:
        instrs = proc_instrs[p]
        if proc_adj[p] is None:
            proc_adj[p] = _raw_adjacency(instrs)
        adj = proc_adj[p]
        def_idx = next(i for i, ins in enumerate(instrs)
                       if ins.writes() == nxt)
        readers = [i for i, ins in enumerate(instrs)
                   if cur in ins.srcs and i != def_idx]
        desc = _reachable(adj, def_idx)
        if ((p, nxt, cur) not in part.remat_commits
                and (p, cur) not in part.remat_reads
                and not any(r in desc for r in readers)):
            # share machine register: next value lands in cur's register,
            # WAR edges force every read of cur to issue first.
            share[p][nxt] = cur
            commit_def[p][cur] = def_idx
            war_edges[p] += [(r, def_idx) for r in readers]
            for r in readers:
                adj.setdefault(r, []).append(def_idx)
            shared_commits += 1
        else:
            mov = Instr(Op.MOV, cur, (nxt,))
            instrs.append(mov)
            mi = len(instrs) - 1
            commit_def[p][cur] = mi
            war_edges[p] += [(r, mi) for r in readers]
            adj.setdefault(def_idx, []).append(mi)
            for r in readers:
                adj.setdefault(r, []).append(mi)
            commit_movs += 1

    # memory-order edges: every LD of a memory before its first ST; STs in
    # program order (full-cycle semantics: reads see pre-cycle state)
    for p, instrs in enumerate(proc_instrs):
        by_mem: Dict[str, Tuple[List[int], List[int]]] = {}
        for i, ins in enumerate(instrs):
            if ins.op in (Op.LD, Op.GLD):
                by_mem.setdefault(ins.mem or "?", ([], []))[0].append(i)
            elif ins.op in (Op.ST, Op.GST):
                by_mem.setdefault(ins.mem or "?", ([], []))[1].append(i)
        for lds, sts in by_mem.values():
            for a, b in zip(sts, sts[1:]):
                order_edges[p].append((a, b))
            if sts:
                order_edges[p] += [(ld, sts[0]) for ld in lds]

    # ---- schedule ---------------------------------------------------------
    t0 = time.perf_counter()
    sched = schedule(proc_instrs, core_of_proc, hw, send_dst_core,
                     war_edges, order_edges, strategy=sched_strategy)
    tm["schedule"] = tm.get("schedule", 0.0) + time.perf_counter() - t0
    if check:
        validate_schedule(sched, proc_instrs, core_of_proc, hw,
                          send_dst_core, war_edges, order_edges)

    return _Arm(name, core_of_proc, part, proc_instrs, proc_tables,
                send_dst_core, send_meta, war_edges, order_edges, share,
                commit_def, commit_movs, shared_commits, remat_stats, sched)


def compile_circuit(circuit: Circuit,
                    hw: Optional[HardwareConfig] = None,
                    strategy: str = "balanced",
                    use_luts: bool = True,
                    optimize: bool = True,
                    sched_strategy: str = "slack",
                    placement: Union[str, Sequence[int]] = "anneal",
                    pipeline: str = "modulo",
                    check: bool = False,
                    timings: Optional[Dict[str, float]] = None) -> Program:
    """Compile ``circuit`` into an executable :class:`Program`.

    ``strategy`` picks the partition merge heuristic (``"balanced"`` /
    ``"lpt"``), ``sched_strategy`` the scheduler (``"slack"`` — the
    slack-driven default with rematerialization — or ``"greedy"``, the
    original scheduler kept frozen for differential testing; see
    ``core.schedule``). ``placement`` picks the process-to-core mapping
    (``core.place``): ``"anneal"`` (default) optimizes slack-weighted hop
    count and ships whichever of {annealed, identity} geometry schedules
    the lower VCPL; ``"identity"`` is the frozen process-p-on-core-p
    mapping; an explicit core list (one core id per process, all distinct)
    is a testing hook. ``pipeline`` enables cross-Vcycle modulo pipelining
    (``"modulo"``, default): boundary retiming + overlap accounting ship a
    steady-state initiation interval II < VCPL when legal, best-of-two
    against the unpipelined schedule (``stats["pipeline_pick"]``);
    ``"off"`` is the frozen unpipelined path. ``check=True`` re-validates
    the schedule against the machine model
    (``core.schedule.validate_schedule``) before emitting the binary."""
    hw = hw or HardwareConfig()
    if pipeline not in PIPELINES:
        raise ValueError(
            f"unknown pipeline mode {pipeline!r}; choose from {PIPELINES}")
    tm: Dict[str, float] = {} if timings is None else timings

    t0 = time.perf_counter()
    low = lower(circuit)
    tm["lower"] = time.perf_counter() - t0

    # ---- optimizing middle-end (PR 3; optimize=False is the bit-identical
    # legacy path: the pass pipeline is skipped entirely) ------------------
    instrs_lowered = len(low.instrs)
    opt_records: List[Dict] = []
    if optimize:
        t0 = time.perf_counter()
        low, opt_records = optimize_lowered(low)
        tm["opt"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    part0 = partition(low, hw.num_cores, strategy)
    tm["partition"] = time.perf_counter() - t0
    nproc = part0.num_procs
    assert nproc <= hw.num_cores, (nproc, hw.num_cores)

    # ---- placement (core.place): candidate process-to-core mappings ------
    t0 = time.perf_counter()
    place_stats: Dict[str, float] = {}
    if isinstance(placement, str):
        placement_name = placement
        pl = place(low, part0, hw, strategy=placement)
        place_stats = dict(pl.stats)
        ident = list(range(nproc))
        if pl.core_of_proc != ident:
            # schedule both geometries, ship the lower VCPL: the weighted
            # hop objective is a proxy — the scheduler is the arbiter
            candidates = [("anneal", pl.core_of_proc), ("identity", ident)]
        else:
            candidates = [(placement, ident)]
    else:
        placement_name = "explicit"
        cop = [int(c) for c in placement]
        if (len(cop) != nproc or len(set(cop)) != nproc
                or any(c < 0 or c >= hw.num_cores for c in cop)):
            raise ValueError(
                f"explicit placement must be {nproc} distinct core ids "
                f"< {hw.num_cores}, got {cop}")
        place_stats = {"total_hops": float(hop_cost(cop, part0.sends, hw)),
                       "weighted_hops": 0.0, "place_moves": 0.0}
        candidates = [("explicit", cop)]
    tm["place"] = time.perf_counter() - t0

    best: Optional[_Arm] = None
    for arm_name, core_of_proc in candidates:
        arm_part = part0.clone() if len(candidates) > 1 else part0
        arm = _compile_arm(arm_name, core_of_proc, low, arm_part, hw,
                           use_luts, sched_strategy, check, tm)
        # <= so identity (scheduled second) wins ties: same VCPL at a more
        # compact core numbering
        if best is None or arm.sched.vcpl <= best.sched.vcpl:
            best = arm
    assert best is not None
    if best.name == "identity" and len(candidates) > 1:
        # the annealed geometry lost at the scheduler: report identity hops
        place_stats["total_hops"] = place_stats.get(
            "identity_hops", place_stats.get("total_hops", 0.0))
        place_stats["weighted_hops"] = place_stats.get(
            "identity_weighted_hops", place_stats.get("weighted_hops", 0.0))
    part, core_of_proc, sched = best.part, best.core_of_proc, best.sched
    proc_instrs, proc_tables = best.proc_instrs, best.proc_tables
    send_meta, send_dst_core = best.send_meta, best.send_dst_core
    share, commit_def = best.share, best.commit_def
    commit_movs, shared_commits = best.commit_movs, best.shared_commits
    remat_stats = best.remat_stats
    used = max(core_of_proc) + 1 if core_of_proc else 1

    # ---- cross-Vcycle modulo pipelining (core.retime + pipeline_schedule):
    # best-of-two ship rule — the pipelined schedule replaces the baseline
    # only when its steady-state initiation interval beats the unpipelined
    # VCPL; "off" (and a losing pipelined arm) leaves the baseline binary
    # untouched bit for bit.
    vcpl0 = sched.vcpl
    crit_lb0 = int(sched.stats.get("crit_path_lb", 0))
    pipe_pick = "off"
    pipe_info: Optional[PipelineInfo] = None
    if pipeline == "modulo":
        t0 = time.perf_counter()
        output_vregs: Set[int] = set()
        for vregs in low.outputs.values():
            output_vregs.update(vregs)
        epi0 = int(sched.stats.get("epilogue", 0))
        budget = max(0, vcpl0 - crit_lb0) + epi0
        # three hoist arms: none (pure overlap accounting — the emitted
        # stream stays the baseline), aggressive retime (committed-register
        # sources visible by the critical-path bound), conservative retime
        # (no committed-register sources at all)
        hoists = [[set() for _ in range(nproc)]]
        if budget > 0:
            for theta in (crit_lb0, -1):
                h = plan_retime(proc_instrs, core_of_proc, hw, sched, share,
                                commit_def, best.war_edges, best.order_edges,
                                output_vregs, theta=theta, budget=budget)
                if h not in hoists:
                    hoists.append(h)
        best_pipe = None
        best_key = None
        for hoist in hoists:
            r = pipeline_schedule(proc_instrs, core_of_proc, hw,
                                  send_dst_core, best.war_edges,
                                  best.order_edges, share, commit_def,
                                  hoist, strategy=sched_strategy,
                                  crit_path_lb=crit_lb0, base=sched)
            if r is None:
                continue
            # ties go to the arm that retimes more work across the commit
            # boundary: same modeled throughput, but the hoisted carries
            # shorten the next iteration's critical head
            key = (r[1].ii, -sum(len(h) for h in hoist))
            if best_key is None or key < best_key:
                best_pipe, best_key = r, key
        tm["pipeline"] = time.perf_counter() - t0
        if best_pipe is not None and best_pipe[1].ii < vcpl0:
            pipe_pick = "modulo"
            sched, pipe_info = best_pipe
            if check:
                validate_schedule(sched, proc_instrs, core_of_proc, hw,
                                  send_dst_core, best.war_edges,
                                  best.order_edges, pipeline=pipe_info)

    # ---- memory placement (resolve relocations) --------------------------
    spad_base: Dict[str, int] = {}
    gmem_base: Dict[str, int] = {}
    core_spad_used = [0] * hw.num_cores
    g_used = 0
    owner_core: Dict[str, int] = {}
    def place_spad(mname: str, c: int) -> None:
        owner_core[mname] = c
        spad_base[mname] = core_spad_used[c]
        core_spad_used[c] += low.mems[mname].depth * low.mems[mname].stride
        if core_spad_used[c] > hw.spad_words:
            raise RuntimeError(
                f"scratchpad overflow on core {c}: {core_spad_used[c]} "
                f"words (memory {mname})")

    for p, mems in enumerate(part.proc_mems):
        for mname in mems:
            place_spad(mname, core_of_proc[p])
    for mname, m in low.mems.items():
        if m.is_global:
            gmem_base[mname] = g_used
            g_used += m.depth * m.stride
        elif mname not in spad_base:
            # every access optimized away (e.g. provably-dead stores): the
            # memory still gets a placement so its init image and any
            # relocatable base stay resolvable
            place_spad(mname, core_of_proc[part.priv_proc])

    def resolve(v: InitVal) -> int:
        if isinstance(v, int):
            return v & WORD_MASK
        m = low.mems[v.mem]
        base = gmem_base[v.mem] if m.is_global else spad_base[v.mem]
        addr = base + v.offset
        return (addr >> 16) & WORD_MASK if v.part == "hi" else addr & WORD_MASK

    # ---- register allocation ---------------------------------------------
    t0 = time.perf_counter()
    pinned: Dict[int, InitVal] = dict(low.vreg_init)
    for r in low.regs:
        for j, cw in enumerate(r.cur):
            pinned[cw] = (r.init >> (16 * j)) & WORD_MASK

    allocs: List[Optional[CoreAlloc]] = [None] * hw.num_cores
    for p in range(nproc):
        c = core_of_proc[p]
        # prologue carries live across the iteration boundary — their
        # machine registers must not be recycled mid-stream
        carries = ({proc_instrs[p][i].writes() for i in pipe_info.hoist[p]}
                   if pipe_info is not None else None)
        allocs[c] = allocate(sched.cores[c].slots, pinned, share[p],
                             hw.num_regs, no_recycle=carries)
    tm["regalloc"] = time.perf_counter() - t0

    # ---- emit binary -------------------------------------------------------
    C, T = hw.num_cores, max(sched.t_compute, 1)
    code = np.zeros((C, T, NUM_FIELDS), dtype=np.int32)
    luts = np.zeros((C, hw.num_luts, 16), dtype=np.uint16)
    reg_init = np.zeros((C, hw.num_regs), dtype=np.uint16)
    spad_init = np.zeros((C, max(max(core_spad_used), 1)), dtype=np.uint16)
    gmem_init = np.zeros((max(g_used, 1),), dtype=np.uint16)

    send_slot_reg: Dict[int, Tuple[int, int]] = {}  # id(ins) -> (core, slot)
    global_ops = 0
    for c in range(C):
        al = allocs[c]
        if al is None:
            continue
        vm = al.vreg_to_mreg
        for mreg, iv in al.init:
            reg_init[c, mreg] = resolve(iv)
        for t, ins in enumerate(sched.cores[c].slots):
            if ins is None:
                continue
            op = ins.op
            if op in (Op.GLD, Op.GST):
                global_ops += 1
            dst = vm.get(ins.dst, 0) if ins.writes() is not None else 0
            if op == Op.MOV and ins.dst in vm:   # commit MOV writes cur
                dst = vm[ins.dst]
            ss = [vm.get(s, 0) for s in ins.srcs] + [0] * (4 - len(ins.srcs))
            imm = ins.imm
            if op == Op.SEND:
                send_slot_reg[id(ins)] = (c, t)
            code[c, t] = (int(op), dst, ss[0], ss[1], ss[2], ss[3], imm)
    for p, tables in enumerate(proc_tables):
        c = core_of_proc[p]
        for k, tt in enumerate(tables):
            luts[c, k] = np.array(tt, dtype=np.uint16)

    # exchange tables
    xs_core, xs_slot, xd_core, xd_reg = [], [], [], []
    for e, ins in send_meta:
        c, t = send_slot_reg[id(ins)]
        dc = core_of_proc[e.dst_proc]
        dal = allocs[dc]
        assert dal is not None
        dreg = dal.vreg_to_mreg.get(e.cur_vreg)
        assert dreg is not None, (
            f"SEND target register v{e.cur_vreg} unallocated in core {dc}")
        xs_core.append(c); xs_slot.append(t)
        xd_core.append(dc); xd_reg.append(dreg)
        imm = (dc << 16) | dreg
        code[c, t, 6] = imm

    # memory images
    for mname, m in low.mems.items():
        w = np.array(m.init_words, dtype=np.uint16)
        if m.is_global:
            b = gmem_base[mname]
            gmem_init[b:b + len(w)] = w
        else:
            c, b = owner_core[mname], spad_base[mname]
            spad_init[c, b:b + len(w)] = w

    # host-visible values
    outputs: Dict[str, Tuple[int, List[int]]] = {}
    priv_core = core_of_proc[part.priv_proc]
    pal = allocs[priv_core]
    for name, vregs in low.outputs.items():
        if pal is not None and all(v in pal.vreg_to_mreg for v in vregs):
            outputs[name] = (priv_core, [pal.vreg_to_mreg[v] for v in vregs])

    # every core holding a copy of a register word (owner + duplicated
    # readers) — read_reg uses the first, elastic migration writes them all
    state_regs: Dict[str, List[List[Tuple[int, int]]]] = {}
    for r in low.regs:
        words: List[List[Tuple[int, int]]] = []
        for cw in r.cur:
            locs = [(c, allocs[c].vreg_to_mreg[cw]) for c in range(C)
                    if allocs[c] is not None and cw in allocs[c].vreg_to_mreg]
            words.append(locs)
        if all(words):
            state_regs[r.name] = words

    # partial-evaluation metadata: per-slot opcode usage + histogram (the
    # engines specialize on this; see core.bsp / kernels.vcycle)
    op_masks = slot_op_masks(code, used)
    opcodes, op_counts = np.unique(code[:used, :, 0], return_counts=True)
    op_histogram = {Op(int(o)).name: int(n)
                    for o, n in zip(opcodes, op_counts) if o}

    stats = dict(sched.stats)
    stats.update(part.stats())
    stats["mem_layout"] = {
        mname: ((0, gmem_base[mname], m.depth * m.stride, True)
                if m.is_global else
                (owner_core[mname], spad_base[mname], m.depth * m.stride,
                 False))
        for mname, m in low.mems.items()}
    crit_lb = sched.stats.get("crit_path_lb", 0)
    ship_vcpl = pipe_info.ii if pipe_info is not None else sched.vcpl
    stats.update({
        "optimize": bool(optimize),
        "sched_strategy": sched_strategy,
        "vcpl_over_lb": round(sched.vcpl / crit_lb, 4) if crit_lb else 0.0,
        "sched_seconds": round(tm.get("schedule", 0.0), 6),
        "pipeline": pipeline,
        "pipeline_pick": pipe_pick,
        "vcpl_ii": ship_vcpl,
        "vcpl_unpipelined": vcpl0,
        "pipe_prologue_len": pipe_info.prologue_len if pipe_info else 0,
        "pipe_hoisted": (pipe_info.stats["hoisted"] if pipe_info else 0),
        "sched_minimal": (ship_vcpl <= crit_lb if pipe_info is not None
                          else sched.stats.get("sched_minimal", False)),
        **remat_stats,
        "instrs_lowered": instrs_lowered,
        "instrs_opt": len(low.instrs),
        "opt_passes": opt_records,
        "commit_movs": commit_movs,
        "shared_commits": shared_commits,
        "global_ops": global_ops,
        "lut_tables": sum(len(t) for t in proc_tables),
        "lut_instrs": int((code[..., 0] == int(Op.LUT)).sum()),
        "op_histogram": op_histogram,
        "used_cores": used,
        "spad_words_max": max(core_spad_used),
        "compile_times": dict(tm),
        "placement": placement_name,
        "place_pick": best.name,
        "place_seconds": round(tm.get("place", 0.0), 6),
        **{k: v for k, v in place_stats.items() if k != "place_seconds"},
    })

    return Program(
        name=circuit.name, hw=hw, code=code, luts=luts, reg_init=reg_init,
        spad_init=spad_init, gmem_init=gmem_init,
        xchg_src_core=np.array(xs_core, dtype=np.int32),
        xchg_src_slot=np.array(xs_slot, dtype=np.int32),
        xchg_dst_core=np.array(xd_core, dtype=np.int32),
        xchg_dst_reg=np.array(xd_reg, dtype=np.int32),
        t_compute=sched.t_compute, vcpl=ship_vcpl, used_cores=used,
        outputs=outputs, state_regs=state_regs, stats=stats,
        slot_op_mask=op_masks,
        pipe_prologue=pipe_info.prologue_len if pipe_info else 0)
