# Copy of src/repro/circuits/memory.py (commit aa57dc1); imports may differ.
"""Memory-centric benchmarks: vta (GEMM accelerator core), blur (stencil
line buffers), jpeg (serial variable-length decoder). Paper §7.5.

These stress the scratchpad path: instructions touching one memory must
colocate on its owner core (paper §6.1), so these designs parallelize poorly
by construction — exactly the behaviour Table 3 shows for vta/jpeg.

Batched builds (``seeds=[...]``): the seed-dependent data here is mostly
*memory images* (vta's weight/input buffers, jpeg's Huffman table), which
already live in init state — they become per-seed scratchpad planes via
``Planes.mem`` with no structural change at all.
"""
from __future__ import annotations

from ..core.netlist import Circuit
from .common import (Bench, M16, M32, finish_and_check, make_counter,
                     make_planes, rng, seed_list, xorshift32_py,
                     xorshift32_sig)


def build_vta(n_cycles: int = 256, depth: int = 256, acc_depth: int = 64,
              lanes: int = 4, seed: int = 13, seeds=None) -> Bench:
    """GEMM core: ``lanes`` parallel MAC lanes, each with its own wgt/inp
    buffers and accumulator scratchpad (paper's vta, 4-lane spatial config,
    buffers divided to fit scratchpads)."""
    c = Circuit("vta")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    ctr = make_counter(c, 16)
    lg_acc = (acc_depth - 1).bit_length()
    i = ctr[7:0].zext(16)
    j = ctr[lg_acc - 1:0].zext(16)
    checks = []
    csums = {}
    for ln in range(lanes):
        rs = [rng(s + 101 * ln) for s in sl]
        wgt_vs = [[r.getrandbits(16) for _ in range(depth)] for r in rs]
        inp_vs = [[r.getrandbits(16) for _ in range(depth)] for r in rs]
        wgt = planes.mem(f"wgt{ln}", depth, 16, wgt_vs)
        inp = planes.mem(f"inp{ln}", depth, 16, inp_vs)
        accm = c.mem(f"acc{ln}", acc_depth, 32)
        w = c.mem_read(wgt, i)
        x = c.mem_read(inp, ((i + j) & 0xFF))
        prod = w.zext(32) * x.zext(32)
        a_old = c.mem_read(accm, j)
        c.mem_write(accm, j, a_old + prod, c.const(1, 1))
        csum = c.reg(32, init=0, name=f"csum{ln}")
        c.set_next(csum, csum + prod)
        # probe through a register so the EXPECT cone reads register state,
        # not the scratchpad (a direct mem read would pull every lane's
        # memory into the privileged process)
        probe = c.reg(32, init=0, name=f"probe{ln}")
        c.set_next(probe, c.mem_read(accm, c.const(0, 16)))

        csumps, probes = [], []
        for wgt_v, inp_v in zip(wgt_vs, inp_vs):
            accp = [0] * acc_depth
            csump, probe_g = 0, 0
            for t in range(n_cycles):
                if t == n_cycles - 1:
                    probe_g = accp[0]   # the probe register lags one cycle
                ip, jp = t & 0xFF, t & (acc_depth - 1)
                pr = (wgt_v[ip] * inp_v[(ip + jp) & 0xFF]) & M32
                accp[jp] = (accp[jp] + pr) & M32
                csump = (csump + pr) & M32
            csumps.append(csump)
            probes.append(probe_g)
        checks += [(csum, csumps), (probe, probes)]
        csums[f"csum{ln}"] = csumps[0]
    total = finish_and_check(c, ctr, n_cycles, checks, planes)
    return Bench(c, total, meta=csums).attach(planes, sl)


def build_blur(n_cycles: int = 256, width: int = 32, seed: int = 17,
               seeds=None) -> Bench:
    """3x3 Gaussian stencil with two line buffers over a streamed image
    (paper's blur: non-uniform partitioned reuse buffers)."""
    c = Circuit("blur")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    seed_vs = [rng(s).getrandbits(32) | 1 for s in sl]
    lb1 = c.mem("lb1", width, 16)
    lb2 = c.mem("lb2", width, 16)
    ctr = make_counter(c, 16)
    col = (ctr & (width - 1))[15:0]

    x = planes.reg(32, seed_vs, "pixgen")
    c.set_next(x, xorshift32_sig(c, x))
    pix = x[15:0]

    row1 = c.mem_read(lb1, col)
    row2 = c.mem_read(lb2, col)
    c.mem_write(lb2, col, row1, c.const(1, 1))
    c.mem_write(lb1, col, pix, c.const(1, 1))

    # 3x3 window registers (shift in the three row taps)
    taps = {}
    for rname, src in (("r0", row2), ("r1", row1), ("r2", pix)):
        t0 = c.reg(16, init=0, name=f"{rname}a")
        t1 = c.reg(16, init=0, name=f"{rname}b")
        c.set_next(t1, t0)
        c.set_next(t0, src)
        taps[rname] = (src, t0, t1)

    def w32(s):
        return s.zext(32)

    (p02, p01, p00) = taps["r0"]
    (p12, p11, p10) = taps["r1"]
    (p22, p21, p20) = taps["r2"]
    out = (w32(p00) + (w32(p01) << 1) + w32(p02) +
           (w32(p10) << 1) + (w32(p11) << 2) + (w32(p12) << 1) +
           w32(p20) + (w32(p21) << 1) + w32(p22)) >> 4
    csum = c.reg(32, init=0, name="csum")
    c.set_next(csum, (csum ^ out) + 1)

    # golden, per seed
    golds = []
    for seed_v in seed_vs:
        lb1p, lb2p = [0] * width, [0] * width
        t0p = {k: 0 for k in ("r0", "r1", "r2")}
        t1p = {k: 0 for k in ("r0", "r1", "r2")}
        xp, csump = seed_v, 0
        for t in range(n_cycles):
            colp = t & (width - 1)
            pixp = xp & M16
            r1p, r2p = lb1p[colp], lb2p[colp]
            srcs = {"r0": r2p, "r1": r1p, "r2": pixp}
            outp = (t1p["r0"] + 2 * t0p["r0"] + srcs["r0"] +
                    2 * t1p["r1"] + 4 * t0p["r1"] + 2 * srcs["r1"] +
                    t1p["r2"] + 2 * t0p["r2"] + srcs["r2"]) >> 4
            csump = ((csump ^ outp) + 1) & M32
            lb2p[colp] = r1p
            lb1p[colp] = pixp
            for k in srcs:
                t1p[k] = t0p[k]
                t0p[k] = srcs[k]
            xp = xorshift32_py(xp)
        golds.append(csump)
    total = finish_and_check(c, ctr, n_cycles, [(csum, golds)], planes)
    return Bench(c, total, meta={"csum": golds[0]}).attach(planes, sl)


def build_jpeg(n_cycles: int = 512, seed: int = 23, seeds=None) -> Bench:
    """Serial variable-length decoder: a leading-ones length chain, a
    barrel-shifted bit reservoir and a Huffman table lookup form one long
    sequential dependence per cycle (the paper's jpeg: Huffman is the
    bottleneck and parallelism is ~nil)."""
    c = Circuit("jpeg")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    rs = [rng(s) for s in sl]
    huff_vs = [[r.getrandbits(16) for _ in range(64)] for r in rs]
    huff = planes.mem("huff", 64, 16, huff_vs)
    seed_vs = [r.getrandbits(32) | 1 for r in rs]

    ctr = make_counter(c, 16)
    buf = planes.reg(32, seed_vs, "buf")
    c.set_next(buf, xorshift32_sig(c, buf))

    # leading-ones count of the top 8 bits (serial chain)
    ones = c.const(0, 4)
    run = c.const(1, 1)
    for k in range(8):
        bit = buf[31 - k]
        run = run & bit
        ones = ones + run.zext(4)
    # barrel shift by the decoded length (serial mux chain)
    shifted = c.shr_dyn(buf, ones)
    sym = (shifted & 0x3F)[5:0]
    entry = c.mem_read(huff, sym.zext(16))
    val = c.reg(32, init=0, name="val")
    nxt = ((val << 1) | (val >> 31)) + entry.zext(32) + ones.zext(32)
    c.set_next(val, nxt)

    # golden, per seed
    golds = []
    for huff_v, seed_v in zip(huff_vs, seed_vs):
        bufp, valp = seed_v, 0
        for _ in range(n_cycles):
            onesp, runp = 0, 1
            for k in range(8):
                runp &= (bufp >> (31 - k)) & 1
                onesp += runp
            shiftedp = bufp >> onesp
            symp = shiftedp & 0x3F
            valp = (((valp << 1) | (valp >> 31)) + huff_v[symp] + onesp) & M32
            bufp = xorshift32_py(bufp)
        golds.append(valp)
    total = finish_and_check(c, ctr, n_cycles, [(val, golds)], planes)
    return Bench(c, total, meta={"val": golds[0]}).attach(planes, sl)
