# Copy of src/repro/circuits/compute.py (commit aa57dc1); imports may differ.
"""Compute-heavy benchmarks: bc (bitcoin/SHA-round), mm (matmul),
mc (Monte-Carlo), cgra (PE grid). Paper §7.5.

Every builder accepts ``seeds=[...]`` for batched-stimulus builds: one
structural netlist (built from ``seeds[0]``) whose seed-dependent values —
register resets and golden check constants — live in per-seed init planes
(see ``common.Planes``). Structural constants (mm's ROM matrices, cgra's
weights) stay those of ``seeds[0]``; the *stimulus* axis is the initial
register state.
"""
from __future__ import annotations

from typing import List

from ..core.netlist import Circuit, Sig
from .common import (Bench, M16, M32, finish_and_check, make_counter,
                     make_planes, rng, rom16, rotr32, py_rotl32, seed_list,
                     xorshift32_py, xorshift32_sig)

_K = [0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
      0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5]
_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]


def build_bc(n_cycles: int = 64, n_pipes: int = 2, seed: int = 7,
             seeds=None) -> Bench:
    """SHA-256-style round pipelines fed by an xorshift message schedule.
    ``n_pipes`` independent pipelines model the miner's unrolled cores."""
    c = Circuit("bc")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    ctr = make_counter(c, 16)
    checks = []
    golden_meta = {}
    for pipe in range(n_pipes):
        w0s = [rng(s + pipe).getrandbits(32) for s in sl]
        st = [c.reg(32, init=_IV[i] ^ pipe, name=f"h{pipe}_{i}")
              for i in range(8)]
        w = planes.reg(32, w0s, f"w{pipe}")
        c.set_next(w, xorshift32_sig(c, w))
        a, b_, cc, d, e, f, g, h = st
        s1 = rotr32(c, e, 6) ^ rotr32(c, e, 11) ^ rotr32(c, e, 25)
        ch = (e & f) ^ (~e & g)
        kc = c.const(_K[pipe % 8], 32)
        t1 = h + s1 + ch + kc + w
        s0 = rotr32(c, a, 2) ^ rotr32(c, a, 13) ^ rotr32(c, a, 22)
        maj = (a & b_) ^ (a & cc) ^ (b_ & cc)
        t2 = s0 + maj
        c.set_next(h, g); c.set_next(g, f); c.set_next(f, e)
        c.set_next(e, d + t1)
        c.set_next(d, cc); c.set_next(cc, b_); c.set_next(b_, a)
        c.set_next(a, t1 + t2)

        # python golden, per seed
        golds_a, golds_e = [], []
        for w0 in w0s:
            sp = [(_IV[i] ^ pipe) & M32 for i in range(8)]
            wp = w0
            for _ in range(n_cycles):
                pa, pb, pc_, pd, pe, pf, pg, ph = sp
                ps1 = py_rotl32(pe, 32 - 6) ^ py_rotl32(pe, 32 - 11) ^ \
                    py_rotl32(pe, 32 - 25)
                pch = (pe & pf) ^ (~pe & pg & M32)
                pt1 = (ph + ps1 + pch + _K[pipe % 8] + wp) & M32
                ps0 = py_rotl32(pa, 32 - 2) ^ py_rotl32(pa, 32 - 13) ^ \
                    py_rotl32(pa, 32 - 22)
                pmaj = (pa & pb) ^ (pa & pc_) ^ (pb & pc_)
                pt2 = (ps0 + pmaj) & M32
                sp = [(pt1 + pt2) & M32, pa, pb, pc_, (pd + pt1) & M32,
                      pe, pf, pg]
                wp = xorshift32_py(wp)
            golds_a.append(sp[0])
            golds_e.append(sp[4])
        checks.append((a, golds_a))
        checks.append((e, golds_e))
        golden_meta[f"digest{pipe}"] = golds_a[0]
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta=golden_meta).attach(planes, sl)


def build_mm(n: int = 8, seed: int = 11, seeds=None) -> Bench:
    """n x n int16 matrix multiply on n row-PEs; PE i streams A[i,k]*B[k,j]
    over time (one (j,k) pair per cycle) and checks each C[i,j].

    The A/B matrices are ROM constants (structure), so the batched stimulus
    axis is a per-seed random *initial accumulator*: block j=0 then sums
    ``acc0 + Σ A[i,k]B[k,0]`` and the golden compare subtracts the
    (init-plane-held) ``acc0`` before checking against the shared ROM
    goldens — code identical across seeds, state seed-dependent."""
    c = Circuit("mm")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    r = rng(sl[0])
    A = [[r.getrandbits(16) for _ in range(n)] for _ in range(n)]
    B = [[r.getrandbits(16) for _ in range(n)] for _ in range(n)]
    Cg = [[sum(A[i][k] * B[k][j] for k in range(n)) & M32
           for j in range(n)] for i in range(n)]

    lg = (n - 1).bit_length()
    ctr = make_counter(c, 16)
    k_idx = ctr[lg - 1:0]
    j_idx = ctr[2 * lg - 1:lg]
    # shared B element (same for every PE): one mux tree over (j,k)
    b_flat = [B[k][j] for j in range(n) for k in range(n)]
    b_el = rom16(c, b_flat, ctr[2 * lg - 1:0], 16)

    checks = []
    for i in range(n):
        a_el = rom16(c, A[i], k_idx, 16)
        acc0s = [0] if not planes.live else \
            [rng(s * 1013 + i).getrandbits(32) for s in sl]
        acc = planes.reg(32, acc0s, f"acc{i}")
        prod = (a_el.zext(32) * b_el.zext(32))
        at_last_k = k_idx.eq(n - 1)
        nxt = c.mux(at_last_k, c.const(0, 32), acc + prod)
        c.set_next(acc, nxt)
        # per-cycle golden compare accumulates into a *sticky* error bit so
        # the check logic stays inside the PE's process (a per-cycle EXPECT
        # would drag every PE cone into the privileged core)
        cg_el = rom16(c, [Cg[i][j] & M16 for j in range(n)], j_idx, 16)
        cg_hi = rom16(c, [(Cg[i][j] >> 16) & M16 for j in range(n)], j_idx, 16)
        full = acc + prod
        if planes.live:
            # block j=0 starts from the per-seed acc0 — subtract it before
            # comparing against the (shared, structural) golden ROM
            a0 = planes.hold(acc0s, 32, f"acc0h{i}")
            corr = c.mux(j_idx.eq(0), a0, c.const(0, 32))
            full = full - corr
        mism = at_last_k & (full[15:0].ne(cg_el) | full[31:16].ne(cg_hi))
        err = c.reg(1, init=0, name=f"err{i}")
        c.set_next(err, err | mism)
        checks.append((err, 0))
        checks.append((acc, 0))  # accumulator parks at 0 after last reset

    total = finish_and_check(c, ctr, n * n, checks, planes)
    return Bench(c, total, meta={"C00": Cg[0][0]}).attach(planes, sl)


def build_mc(n_walkers: int = 16, n_cycles: int = 128, seed: int = 3,
             seeds=None) -> Bench:
    """Monte-Carlo price evolution with fixed-point arithmetic + xorshift
    RNG per walker (paper's mc)."""
    c = Circuit("mc")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    ctr = make_counter(c, 16)
    rs = [rng(s) for s in sl]
    checks = []
    csum_g = 0
    sums: List[Sig] = []
    for wk in range(n_walkers):
        seed_ws = [r.getrandbits(32) | 1 for r in rs]
        p0s = [(1 << 16) + r.getrandbits(12) for r in rs]
        x = planes.reg(32, seed_ws, f"rng{wk}")
        p = planes.reg(32, p0s, f"price{wk}")
        c.set_next(x, xorshift32_sig(c, x))
        up = (p * (x & 0xFF)) >> 12
        dn = p >> 6
        c.set_next(p, p + up - dn)
        sums.append(p)

        # golden, per seed
        golds = []
        for seed_w, p0 in zip(seed_ws, p0s):
            xp, pp = seed_w, p0
            for _ in range(n_cycles):
                pup = (pp * (xp & 0xFF)) >> 12
                pdn = pp >> 6
                pp = (pp + pup - pdn) & M32
                xp = xorshift32_py(xp)
            golds.append(pp)
        checks.append((p, golds))
        csum_g = (csum_g + golds[0]) & M32
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta={"csum": csum_g}).attach(planes, sl)


def build_cgra(rows: int = 4, cols: int = 4, n_cycles: int = 96,
               seed: int = 5, seeds=None) -> Bench:
    """Coarse-grained reconfigurable array: fixed-point MAC PEs on a 2-D
    torus, each combining its north and east neighbours every cycle. The
    weights are structure (``seeds[0]``); the per-seed stimulus is the
    initial PE state."""
    c = Circuit("cgra")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    ctr = make_counter(c, 16)
    n = rows * cols
    r0 = rng(sl[0])
    inits = [[r0.getrandbits(32) for _ in range(n)]]
    wgt = [r0.getrandbits(8) | 1 for _ in range(n)]   # structure: seeds[0]
    for s in sl[1:]:
        r = rng(s)
        inits.append([r.getrandbits(32) for _ in range(n)])
    v = [planes.reg(32, [inits[b][i] for b in range(len(sl))], f"pe{i}")
         for i in range(n)]
    for i in range(n):
        row, col = divmod(i, cols)
        north = v[((row - 1) % rows) * cols + col]
        east = v[row * cols + (col + 1) % cols]
        mac = v[i] + ((north * wgt[i]) >> 8)
        c.set_next(v[i], mac ^ (east >> 1))

    # golden, per seed
    finals = []
    for b in range(len(sl)):
        vp = list(inits[b])
        for _ in range(n_cycles):
            nxt = []
            for i in range(n):
                row, col = divmod(i, cols)
                north = vp[((row - 1) % rows) * cols + col]
                east = vp[row * cols + (col + 1) % cols]
                mac = (vp[i] + (((north * wgt[i]) & M32) >> 8)) & M32
                nxt.append(mac ^ (east >> 1))
            vp = nxt
        finals.append(vp)
    checks = [(v[i], [finals[b][i] for b in range(len(sl))])
              for i in range(0, n, 3)]
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta={"pe0": finals[0][0]}).attach(planes, sl)
