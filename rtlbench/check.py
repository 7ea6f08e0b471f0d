"""What decides ``correct``: every test of the window against the reference.

Each test the window ran is held to the plain reference's prediction for
its stimulus (``Suite.expected``): the exception ids (FINISH alone), the
cycle at which it froze, and every architectural register by RTL name.
Each number below is a count of tests, compared exactly (limit 0).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

FINISH = 1
LIMITS = {"missing": 0, "wrong_exceptions": 0, "wrong_cycles": 0,
          "wrong_registers": 0}


def compare(run):
    """Counts of tests that came back missing or wrong, each with its
    limit; the tests attempted; the tests with any fault."""
    suite, B = run.suite, run.batch
    names = sorted(suite.expected)
    exp = np.stack([suite.expected[n] for n in names], 1).tolist()
    n = {k: 0 for k in LIMITS}
    attempted = failed = 0
    for b, res in zip(run.batches, run.results):
        attempted += B
        seen = {}
        for r in res:
            if 0 <= r.batch_index < B:
                seen.setdefault(r.batch_index, r)
        n["missing"] += B - len(seen)
        failed += B - len(seen)
        for i, r in seen.items():
            want = exp[b["index"] * B + i]
            bad = (r.exception_ids != {FINISH},
                   r.cycles != suite.finish,
                   sorted(r.registers) != names
                   or [r.registers[k] for k in names] != want)
            for k, v in zip(("wrong_exceptions", "wrong_cycles",
                             "wrong_registers"), bad):
                n[k] += v
            failed += any(bad)
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in n.items()}
    return checks, attempted, failed


def correct(checks: Dict, attempted: int) -> bool:
    """Every number within its limit, over at least one test."""
    return attempted > 0 and all(c["value"] <= c["limit"]
                                 for c in checks.values())


def lines(checks: Dict):
    """One line a number: its name, value and limit."""
    return [f"check {k} {c['value']} limit {c['limit']}"
            for k, c in checks.items()]
