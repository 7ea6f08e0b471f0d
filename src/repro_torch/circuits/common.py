# Copy of src/repro/circuits/common.py (commit aa57dc1); imports may differ.
"""Shared helpers for the benchmark circuits.

Every benchmark is *self-checking* (paper §7.5: "wrapped in simple,
assertion-based Verilog test drivers"): the builder computes golden values in
plain Python while constructing the netlist, embeds them as constants, and
the circuit EXPECTs equality when its cycle counter reaches ``n_cycles``
(exception id FINISH fires on success; MISMATCH on a wrong value).

Batched stimuli (PR 2): a builder called with ``seeds=[s0, s1, ...]``
constructs **one** structural netlist (wires, registers, memories and code
are those of ``s0``) plus *per-seed init planes* — for every seed-dependent
value the builder routes the value through :class:`Planes` instead of a
``c.const``/plain ``c.reg``, so the value lands in *initial state* (register
file / scratchpad / global-memory images) rather than in instruction
immediates. All seeds then share the same compiled ``code``/``luts`` and a
``BatchedMachine`` can simulate every stimulus in a single device launch.
Golden check values are seed-dependent too, so in batched mode they become
self-holding registers (``Planes.hold``) initialized per seed.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..core.netlist import Circuit, Memory, Sig

FINISH = 1        # clean end-of-simulation
MISMATCH = 2      # golden check failed
M32 = (1 << 32) - 1
M16 = (1 << 16) - 1


class Planes:
    """Per-seed init planes collected while building one structural netlist.

    ``live=False`` (a legacy single-seed build) degrades every helper to the
    plain constructs the pre-batching builders used — ``hold`` becomes
    ``c.const``, ``reg``/``mem`` plain construction — so existing callers
    get bit-identical netlists. ``live=True`` records, for each seed, the
    name → init value (registers) and name → 16-bit-word image (memories)
    overlays that :meth:`repro.core.compile.Program.init_images` turns into
    per-stimulus ``reg_init``/``spad_init``/``gmem_init`` arrays.
    """

    def __init__(self, c: Circuit, n_seeds: int, live: bool):
        self.c = c
        self.n = n_seeds
        self.live = live
        self.regs: List[Dict[str, int]] = [dict() for _ in range(n_seeds)]
        self.mems: List[Dict[str, List[int]]] = [dict() for _ in range(n_seeds)]

    def reg(self, width: int, inits: Sequence[int], name: str) -> Sig:
        """A register whose *initial value* varies per seed."""
        assert len(inits) == self.n, (name, len(inits), self.n)
        m = (1 << width) - 1
        r = self.c.reg(width, init=inits[0] & m, name=name)
        if self.live:
            for b in range(self.n):
                self.regs[b][name] = inits[b] & m
        return r

    def hold(self, values: Sequence[int], width: int, name: str) -> Sig:
        """A per-seed 'constant': a self-holding register in batched mode
        (value lives in the init plane, not in an immediate), a plain
        shared constant otherwise."""
        if not self.live:
            return self.c.const(values[0], width)
        r = self.reg(width, values, name)
        self.c.set_next(r, r)
        return r

    def mem(self, name: str, depth: int, width: int,
            inits: Sequence[Sequence[int]],
            is_global: bool = False) -> Memory:
        """A memory whose init image varies per seed (recorded flattened to
        the 16-bit words the scratchpad/global images use)."""
        assert len(inits) == self.n, (name, len(inits), self.n)
        m = self.c.mem(name, depth, width, init=list(inits[0]),
                       is_global=is_global)
        if self.live:
            stride = (width + 15) // 16
            emask = (1 << width) - 1
            for b in range(self.n):
                words: List[int] = []
                for v in inits[b]:
                    v &= emask
                    for w in range(stride):
                        words.append((v >> (16 * w)) & M16)
                self.mems[b][name] = words
        return m


def seed_list(seed: int, seeds: Optional[Sequence[int]]) -> List[int]:
    """Normalize the (legacy ``seed``, batched ``seeds``) pair."""
    return [seed] if seeds is None else list(seeds)


def make_planes(c: Circuit, seed: int,
                seeds: Optional[Sequence[int]]) -> "Planes":
    sl = seed_list(seed, seeds)
    return Planes(c, len(sl), live=seeds is not None)


@dataclass
class Bench:
    circuit: Circuit
    n_cycles: int            # cycle at which FINISH fires (== cycles to run)
    meta: Dict = field(default_factory=dict)
    # batched-stimulus metadata (None for legacy single-seed builds):
    seeds: Optional[List[int]] = None
    reg_planes: Optional[List[Dict[str, int]]] = None
    mem_planes: Optional[List[Dict[str, List[int]]]] = None

    @property
    def batch(self) -> int:
        return len(self.reg_planes) if self.reg_planes is not None else 1

    def attach(self, planes: Planes, seeds: Sequence[int]) -> "Bench":
        """Record a live build's planes on this bench (no-op when legacy)."""
        if planes.live:
            self.seeds = list(seeds)
            self.reg_planes = planes.regs
            self.mem_planes = planes.mems
        return self

    def images(self, program) -> List:
        """Per-stimulus (reg_init, spad_init, gmem_init) images for a
        Program compiled from this bench's circuit."""
        assert self.reg_planes is not None, "bench was not built with seeds"
        return [program.init_images(r, m)
                for r, m in zip(self.reg_planes, self.mem_planes)]

    def images_batch(self, program, workers: Optional[int] = None):
        """Stacked ``([B, C, R], [B, C, S], [B, G])`` init images,
        generated host-parallel (:meth:`Program.init_images_batch`) — the
        layout the batched/sharded engines consume directly."""
        assert self.reg_planes is not None, "bench was not built with seeds"
        return program.init_images_batch(self.reg_planes, self.mem_planes,
                                         workers=workers)

    def compile(self, hw=None, **options) -> "Simulation":  # noqa: F821
        """Compile this bench through the :mod:`repro.sim` facade — the
        returned Simulation knows the cycle budget and the seed planes, so
        ``bench.compile(hw).run()`` is the whole simulate-and-check flow.
        Options (``optimize=``, ``use_luts=``, ``cache=``, ...) are those
        of :func:`repro.sim.compile`."""
        from ..sim import facade
        return facade.compile(self, hw, **options)


def rng(seed: int) -> random.Random:
    return random.Random(seed)


def rotl32(c: Circuit, x: Sig, k: int) -> Sig:
    k %= 32
    if k == 0:
        return x
    return (x << k) | (x >> (32 - k))


def rotr32(c: Circuit, x: Sig, k: int) -> Sig:
    return rotl32(c, x, 32 - (k % 32))


def py_rotl32(x: int, k: int) -> int:
    k %= 32
    return ((x << k) | (x >> (32 - k))) & M32


def xorshift32_py(x: int) -> int:
    x ^= (x << 13) & M32
    x ^= x >> 17
    x ^= (x << 5) & M32
    return x & M32


def xorshift32_sig(c: Circuit, x: Sig) -> Sig:
    x = x ^ (x << 13)
    x = x ^ (x >> 17)
    x = x ^ (x << 5)
    return x


def rom16(c: Circuit, values: List[int], idx: Sig, width: int = 16) -> Sig:
    """Small ROM as a mux tree (keeps cones parallelizable, unlike a
    scratchpad memory which would serialize every reader into one core)."""
    sigs = [c.const(v, width) for v in values]
    n = max(1, (len(values) - 1).bit_length())
    return c.onehot_mux(idx[n - 1:0] if idx.width > n else idx, sigs)


def make_counter(c: Circuit, width: int, name: str = "ctr") -> Sig:
    ctr = c.reg(width, init=0, name=name)
    c.set_next(ctr, ctr + 1)
    return ctr


def finish_and_check(c: Circuit, ctr: Sig, n_cycles: int,
                     checks: List, planes: Optional[Planes] = None) -> int:
    """Arm golden checks at ``ctr == n_cycles`` and FINISH one cycle later,
    so a MISMATCH always freezes the machine before the clean finish.

    A check is ``(actual, golden)`` where ``golden`` is an int (shared by
    every stimulus) or a per-seed sequence (batched builds; the golden
    becomes a hold-register so it lands in the init planes, keeping the
    code stream identical across seeds).

    Returns the total cycle count at which FINISH fires (what the driver
    should expect from a correct run)."""
    if planes is None:
        planes = Planes(c, 1, live=False)
    at_check = ctr.eq(n_cycles)
    for k, (actual, golden) in enumerate(checks):
        golds = [golden] * planes.n if isinstance(golden, int) \
            else list(golden)
        g = planes.hold(golds, actual.width, f"gold{k}")
        # only differs from golden while the check is armed
        val = c.mux(at_check, actual, g)
        c.expect_eq(val, g, MISMATCH)
    c.finish_when(ctr.eq(n_cycles + 1), FINISH)
    return n_cycles + 2
