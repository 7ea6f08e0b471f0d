"""Reference of mc: 32-bit xorshift walkers driving 32-bit prices.

Per cycle and walker: ``price += ((price * (rng & 0xFF)) mod 2**32) >> 12``
less ``price >> 6``, then ``rng`` takes its xorshift32 step (13, 17, 5).
The product is cut to 32 bits, as the netlist's 32-bit multiply cuts it.
"""
from __future__ import annotations

from . import M32, Exact, advance, host, lanes


def step(x, p, arith=Exact):
    up = arith.mul(p, x & 0xFF) >> 12
    p = arith.sub(arith.add(p, up), p >> 6)
    x = x ^ ((x << 13) & M32)
    x = x ^ (x >> 17)
    x = x ^ ((x << 5) & M32)
    return x, p


def run(x0, p0, n_cycles: int, device=None, arith=Exact):
    """Every stimulus ``[N, W]`` from its initial state: the prices after
    ``n_cycles`` cycles (the goldens) and ``(rng, price)`` after
    ``n_cycles + 2``, where a sound run freezes on FINISH."""
    def one(s, t):
        return step(*s, arith)

    s = advance(one, (lanes(x0, device), lanes(p0, device)), 0, n_cycles)
    golden = host(s[1])
    x, p = advance(one, s, n_cycles, 2)
    return golden, (host(x), host(p))


def registers(x, p, golden, finish: int) -> dict:
    """Every architectural register ``[N]`` at the freeze, by RTL name."""
    out = {"ctr": (golden[:, 0] * 0 + finish) & 0xFFFF}
    for w in range(x.shape[1]):
        out[f"rng{w}"] = x[:, w]
        out[f"price{w}"] = p[:, w]
        out[f"gold{w}"] = golden[:, w]
    return out
