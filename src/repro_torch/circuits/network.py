# Copy of src/repro/circuits/network.py (commit aa57dc1); imports may differ.
"""Network benchmarks: noc (2-D deflection torus) and rv32r (ring of tiny
processors). Paper §7.5.

Batched builds (``seeds=[...]``): the router pipeline / per-core program
structure is shared; the per-seed stimulus is the initial network state
(in-flight flits, sink totals, accumulators, ring tokens). The golden
mirrors run from the same per-seed state.
"""
from __future__ import annotations

from typing import List

from ..core.netlist import Circuit, Sig
from .common import (Bench, M16, M32, finish_and_check, make_counter,
                     make_planes, rng, seed_list)

# flit encoding: [12]=valid, [11:10]=dest.y, [9:8]=dest.x, [7:0]=payload
_V = 1 << 12


def build_noc(rows: int = 4, cols: int = 4, n_cycles: int = 200,
              seed: int = 29, seeds=None) -> Bench:
    """Uni-directional 2-D torus with dimension-ordered (X then Y) routing
    and Hoplite-style deflection: through-traffic in the Y plane has
    priority, turning flits deflect around their row ring."""
    c = Circuit("noc")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    n = rows * cols
    ctr = make_counter(c, 16)

    # per-seed initial network state: random in-flight flits and sink
    # totals (all-zero for the legacy single-seed build, as before)
    if planes.live:
        x0s, y0s, s0s = [], [], []
        for s in sl:
            r = rng(s)
            x0s.append([r.getrandbits(13) for _ in range(n)])
            y0s.append([r.getrandbits(13) for _ in range(n)])
            s0s.append([r.getrandbits(32) for _ in range(n)])
    else:
        x0s = y0s = [[0] * n]
        s0s = [[0] * n]
    xreg = [planes.reg(13, [x0s[b][i] for b in range(len(sl))], f"x{i}")
            for i in range(n)]
    yreg = [planes.reg(13, [y0s[b][i] for b in range(len(sl))], f"y{i}")
            for i in range(n)]
    sink = [planes.reg(32, [s0s[b][i] for b in range(len(sl))], f"s{i}")
            for i in range(n)]

    def fxy(i):
        return i % cols, i // cols

    for i in range(n):
        x, y = fxy(i)
        west = xreg[(y * cols + (x - 1) % cols)]
        north = yreg[((y - 1) % rows) * cols + x]

        xv = west[12]
        xdx = west[9:8]
        xdy = west[11:10]
        x_here = xdx.eq(x)
        x_cons = xv & x_here & xdy.eq(y)           # consume from X plane
        x_turn = xv & x_here & ~xdy.eq(y)          # wants the Y plane

        yv = north[12]
        ydy = north[11:10]
        y_cons = yv & ydy.eq(y)                    # consume from Y plane
        y_pass = yv & ~ydy.eq(y)                   # through-traffic

        # Y register: through traffic wins; otherwise a turning flit enters
        zero = c.const(0, 13)
        c.set_next(yreg[i], c.mux(y_pass, north, c.mux(x_turn & ~y_pass,
                                                       west, zero)))
        # X register: flit continues if not at its column, or deflects when
        # blocked from turning; else this router may inject
        x_fwd = xv & (~x_here | (x_turn & y_pass))
        inj_turn = ctr[2:0].eq(i & 7)              # injection cadence
        pay = (ctr[7:0] ^ c.const(i * 29 & 0xFF, 8))
        dest = ((ctr + 3 * i)[3:0])                # roaming destination
        flit = c.const(1, 1).cat(dest).cat(pay)    # valid|dest|payload
        c.set_next(xreg[i], c.mux(x_fwd, west, c.mux(inj_turn, flit, zero)))
        consumed = (c.mux(x_cons, west[7:0], c.const(0, 8)).zext(32) +
                    c.mux(y_cons, north[7:0], c.const(0, 8)).zext(32))
        c.set_next(sink[i], sink[i] + consumed)

    # ---- python golden (exact mirror), per seed ----
    finals: List[List[int]] = []
    for b in range(len(sl)):
        xp, yp, sp = list(x0s[b]), list(y0s[b]), list(s0s[b])
        for t in range(n_cycles):
            nx, ny, ns = [0] * n, [0] * n, list(sp)
            for i in range(n):
                x, y = fxy(i)
                west = xp[y * cols + (x - 1) % cols]
                north = yp[((y - 1) % rows) * cols + x]
                xv, xdx, xdy = west >> 12, (west >> 8) & 3, (west >> 10) & 3
                x_here = int(xdx == x)
                x_cons = xv & x_here & int(xdy == y)
                x_turn = xv & x_here & (1 - int(xdy == y))
                yv, ydy = north >> 12, (north >> 10) & 3
                y_cons = yv & int(ydy == y)
                y_pass = yv & (1 - int(ydy == y))
                ny[i] = north if y_pass else (west if (x_turn and not y_pass)
                                              else 0)
                x_fwd = xv & ((1 - x_here) | (x_turn & y_pass))
                inj_turn = int((t & 7) == (i & 7))
                pay = ((t & 0xFF) ^ (i * 29 & 0xFF))
                dest = (t + 3 * i) & 0xF
                flit = _V | (dest << 8) | pay
                nx[i] = west if x_fwd else (flit if inj_turn else 0)
                consumed = (west & 0xFF if x_cons else 0) + \
                           (north & 0xFF if y_cons else 0)
                ns[i] = (sp[i] + consumed) & M32
            xp, yp, sp = nx, ny, ns
        finals.append(sp)

    checks = [(sink[i], [finals[b][i] for b in range(len(sl))])
              for i in range(n)]
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta={"sink0": finals[0][0]}).attach(planes, sl)


def build_rv32r(n_cores: int = 16, n_cycles: int = 128,
                seed: int = 31, seeds=None) -> Bench:
    """Ring of tiny in-order processors: each runs an 8-instruction loop
    (mux-tree "decoder" over its PC) and exchanges a 16-bit token with its
    ring neighbour every cycle (the paper's riscv-mini ring, miniaturized).
    The instruction immediates are structure (``seeds[0]``); per-seed
    stimulus is the initial accumulator / ring-token state."""
    c = Circuit("rv32r")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    r = rng(sl[0])
    ctr = make_counter(c, 16)
    imm = [r.getrandbits(16) for _ in range(n_cores)]
    if planes.live:
        a0s, r0s = [], []
        for s in sl:
            rr = rng(s * 7 + 1)
            a0s.append([rr.getrandbits(32) for _ in range(n_cores)])
            r0s.append([rr.getrandbits(16) for _ in range(n_cores)])
    else:
        a0s = [[i * 0x1234567 & M32 for i in range(n_cores)]]
        r0s = [list(imm)]
    acc = [planes.reg(32, [a0s[b][i] for b in range(len(sl))], f"acc{i}")
           for i in range(n_cores)]
    ring = [planes.reg(16, [r0s[b][i] for b in range(len(sl))], f"ring{i}")
            for i in range(n_cores)]
    pc = [c.reg(3, init=i & 7, name=f"pc{i}") for i in range(n_cores)]

    for i in range(n_cores):
        rin = ring[(i - 1) % n_cores]
        a = acc[i]
        ops: List[Sig] = [
            a + imm[i],                      # addi
            a ^ rin.zext(32),                # xor ring
            (a << 1) | (a >> 31),            # rotl 1
            a + rin.zext(32),                # add ring
            a - imm[i],                      # subi
            a & (rin.zext(32) | 0xFFFF0000), # and
            (a >> 3) + imm[i],               # srli+add
            a * 5,                           # mul small
        ]
        c.set_next(acc[i], c.onehot_mux(pc[i], ops))
        c.set_next(pc[i], pc[i] + 1)
        c.set_next(ring[i], a[15:0] ^ a[31:16])

    # golden, per seed
    finals = []
    for b in range(len(sl)):
        ap = list(a0s[b])
        rp = list(r0s[b])
        pp = [i & 7 for i in range(n_cores)]
        for _ in range(n_cycles):
            na, nr, np_ = [0] * n_cores, [0] * n_cores, [0] * n_cores
            for i in range(n_cores):
                rin = rp[(i - 1) % n_cores]
                a = ap[i]
                ops_p = [
                    (a + imm[i]) & M32,
                    a ^ rin,
                    ((a << 1) | (a >> 31)) & M32,
                    (a + rin) & M32,
                    (a - imm[i]) & M32,
                    a & (rin | 0xFFFF0000),
                    ((a >> 3) + imm[i]) & M32,
                    (a * 5) & M32,
                ]
                na[i] = ops_p[pp[i]]
                np_[i] = (pp[i] + 1) & 7
                nr[i] = ((a & M16) ^ (a >> 16)) & M16
            ap, rp, pp = na, nr, np_
        finals.append(ap)
    checks = [(acc[i], [finals[b][i] for b in range(len(sl))])
              for i in range(n_cores)]
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta={"acc0": finals[0][0]}).attach(planes, sl)
