"""Netlist helpers of the generators.

Frozen copies of ``repro_torch.circuits.common``'s.

Each node is made in the order the port's builders make it, so a generator
gives the netlist (and fingerprint) of ``repro_torch.circuits.build`` for the
same seeds. Per-stimulus values are recorded as columns ``name -> [N]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

FINISH = 1
MISMATCH = 2


class Planes:
    """Registers whose initial value differs per stimulus.

    The netlist takes the value of the netlist's own stimulus (``net``);
    ``cols[name]`` keeps every stimulus's value, masked to the width."""

    def __init__(self, c):
        self.c = c
        self.cols: Dict[str, np.ndarray] = {}

    def reg(self, width: int, net: int, values, name: str):
        m = (1 << width) - 1
        r = self.c.reg(width, init=int(net) & m, name=name)
        self.cols[name] = np.asarray(values, np.int64) & m
        return r

    def hold(self, net: int, values, width: int, name: str):
        r = self.reg(width, net, values, name)
        self.c.set_next(r, r)
        return r


def make_counter(c, width: int, name: str = "ctr"):
    ctr = c.reg(width, init=0, name=name)
    c.set_next(ctr, ctr + 1)
    return ctr


def xorshift32_sig(c, x):
    x = x ^ (x << 13)
    x = x ^ (x >> 17)
    x = x ^ (x << 5)
    return x


def finish_and_check(c, ctr, n_cycles: int, checks, planes: Planes) -> int:
    """Arm the golden checks at ``ctr == n_cycles`` and FINISH one cycle
    later. A check is ``(actual, net golden, [N] goldens)``. Returns the
    cycle at which FINISH fires."""
    at_check = ctr.eq(n_cycles)
    for k, (actual, net, golds) in enumerate(checks):
        g = planes.hold(net, golds, actual.width, f"gold{k}")
        val = c.mux(at_check, actual, g)
        c.expect_eq(val, g, MISMATCH)
    c.finish_when(ctr.eq(n_cycles + 1), FINISH)
    return n_cycles + 2


@dataclass
class Suite:
    """A design and its stimuli.

    ``circuit`` is the netlist (its register inits those of the netlist's own
    stimulus); ``finish`` the cycle at which a sound run freezes on FINISH;
    ``cols`` each per-stimulus register's initial values ``[N]``; ``expected``
    every architectural register's value ``[N]`` at that freeze, by RTL name,
    from the plain reference."""
    circuit: object
    finish: int
    cols: Dict[str, np.ndarray]
    expected: Dict[str, np.ndarray]

    @property
    def size(self) -> int:
        return len(next(iter(self.cols.values())))

    def planes(self, lo: int, hi: int) -> List[Dict[str, int]]:
        """Register-init planes of stimuli ``[lo, hi)``, as
        ``Program.init_images`` takes them."""
        names = list(self.cols)
        block = np.stack([self.cols[n][lo:hi] for n in names], 1).tolist()
        return [dict(zip(names, row)) for row in block]
