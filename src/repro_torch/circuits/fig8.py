# Copy of src/repro/circuits/fig8.py (commit aa57dc1); imports may differ.
"""Fig. 8 microbenchmarks: FIFO vs RAM at 1 KiB / 64 KiB / 512 KiB.

1 KiB fits the scratchpad (no global stalls); 64 KiB goes through the
privileged core's 128 KiB cache (all hits after warmup); 512 KiB spills to
DRAM (misses => long stalls). One load + one store per Vcycle, like the
paper."""
from __future__ import annotations

from ..core.netlist import Circuit
from .common import Bench, FINISH, make_counter, make_planes, rng, seed_list


def build_membench(kind: str, kib: int, n_cycles: int = 4096,
                   seed: int = 0, seeds=None) -> Bench:
    assert kind in ("fifo", "ram")
    words = kib * 1024 // 2
    c = Circuit(f"{kind}_{kib}k")
    sl = seed_list(seed, seeds)
    planes = make_planes(c, seed, seeds)
    m = c.mem("m", words, 16, is_global=(kib * 1024 > 32768))
    ctr = make_counter(c, 32)

    if kind == "fifo":
        addr = ctr  # sequential
    else:
        x0s = [0x1234567] if not planes.live else \
            [rng(s).getrandbits(32) | 1 for s in sl]
        x = planes.reg(32, x0s, "rng")
        # xorshift-style address scramble (paper: XOR-shift-128; 32 here)
        nx = x ^ (x << 13)
        nx = nx ^ (nx >> 17)
        nx = nx ^ (nx << 5)
        c.set_next(x, nx)
        addr = x
    a16 = addr[15:0]
    a_hi = addr[31:16]
    idx = a_hi.cat(a16) if words > 65536 else addr
    rd = c.mem_read(m, idx.trunc(32) if idx.width > 32 else idx.zext(32)
                    if idx.width < 32 else idx)
    acc = c.reg(16, init=0, name="acc")
    c.set_next(acc, acc + rd)
    c.mem_write(m, idx.trunc(32) if idx.width > 32 else idx.zext(32)
                if idx.width < 32 else idx, rd ^ 0x5A5A, c.const(1, 1))
    c.finish_when(ctr.eq(n_cycles), FINISH)
    return Bench(c, n_cycles + 1,
                 meta={"kind": kind, "kib": kib}).attach(planes, sl)
