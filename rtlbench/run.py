"""Run one cell of the benchmark and print its result as the last line.

    python3 rtlbench/run.py --workload mc.regress --seed 7 --seconds 50 \
        --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without the cards the cell asks for, or if JAX or the JAX package
was loaded.
"""
import time

T_PROCESS = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# every build and kernel cache inside the checkout, at fixed paths
CACHE = ROOT / "rtlbench" / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from rtlbench import check, harness

    cell = harness.load_cell(a.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA devices; "
              f"this machine has {have}", file=sys.stderr)
        return 2
    out = harness.measure(a.workload, a.seed, a.seconds, bool(a.trace),
                          [f"cuda:{i}" for i in range(cell.chips)],
                          t_process=T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules loaded that a run may not load: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
