"""mc: Monte-Carlo price walkers.

A frozen copy of ``repro_torch.circuits.compute.build_mc``, but for its
goldens: they come from the reference, which cuts the 32-bit product as the
netlist's multiply does (the builder's Python loop keeps it whole, so its
tests of more than some 400 cycles MISMATCH on a sound simulator).

Each walker holds a 32-bit xorshift state ``rng<w>`` and a 32-bit price
``price<w>``; the netlist checks every price against its golden value at
cycle ``n_cycles`` and FINISHes one cycle later. Stimulus ``s`` draws its
walkers' initial states from ``random.Random(s)`` as ``build_mc`` does.
"""
from __future__ import annotations

import random

import numpy as np

from ..reference import mc as ref
from .netlist import Planes, Suite, finish_and_check, make_counter, \
    xorshift32_sig


def draw(seeds, n_walkers: int):
    """Initial ``rng``, ``price`` ``[N, n_walkers]`` of each stimulus seed."""
    x = np.empty((len(seeds), n_walkers), np.int64)
    p = np.empty_like(x)
    for i, s in enumerate(seeds):
        r = random.Random(s)
        for w in range(n_walkers):
            x[i, w] = r.getrandbits(32) | 1
            p[i, w] = (1 << 16) + r.getrandbits(12)
    return x, p


def lanes(params: dict) -> int:
    """Reference lanes a stimulus: one a walker."""
    return int(params["n_walkers"])


def build(params: dict, n_cycles: int, seeds, net_seed: int,
          device=None, arith=ref.Exact) -> Suite:
    """The netlist of ``net_seed``'s stimulus and the suite of ``seeds``:
    their initial states, goldens and expected registers at the freeze,
    stepped by the reference in ``arith``."""
    from repro_torch.core.netlist import Circuit

    nw = int(params["n_walkers"])
    x0, p0 = draw([net_seed, *seeds], nw)
    golden, final = ref.run(x0, p0, n_cycles, device=device,
                           arith=arith)
    c = Circuit("mc")
    planes = Planes(c)
    ctr = make_counter(c, 16)
    checks = []
    for wk in range(nw):
        x = planes.reg(32, x0[0, wk], x0[1:, wk], f"rng{wk}")
        p = planes.reg(32, p0[0, wk], p0[1:, wk], f"price{wk}")
        c.set_next(x, xorshift32_sig(c, x))
        up = (p * (x & 0xFF)) >> 12
        dn = p >> 6
        c.set_next(p, p + up - dn)
        checks.append((p, golden[0, wk], golden[1:, wk]))
    finish = finish_and_check(c, ctr, n_cycles, checks, planes)
    expected = ref.registers(final[0][1:], final[1][1:], golden[1:], finish)
    return Suite(c, finish, planes.cols, expected)
