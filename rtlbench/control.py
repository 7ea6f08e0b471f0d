"""The control: the reference in the program's place, with a guarantee broken.

    python3 rtlbench/control.py --workload mc.regress --seeds 11 12 13

For each seed, makes the cell's suite as a run does, then steps the
reference once more in ``NoCarry`` arithmetic (each 32-bit add, subtract
and multiply in 16-bit halves, the carry between them dropped: what a
kernel that lost the carry chain of the machine's 16-bit words would
give), hands its registers to the same comparison as the program's
results, one test a stimulus, and prints the numbers compared, one JSON
line a seed. ``correct`` has to come out false on every seed.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


FINISH = 1


class Result:
    """What the comparison reads of a test's result."""

    def __init__(self, b, cycles, registers):
        self.batch_index, self.cycles, self.registers = b, cycles, registers
        self.exception_ids = {FINISH}


def control_checks(run, arith) -> dict:
    """The comparison's numbers for ``arith``'s registers in the place of
    the program's, each stimulus of the suite once."""
    from rtlbench import check, stimuli
    from rtlbench.drivers import suite as drv

    cfg, mix = run.cell.config, run.cell.traffic
    gen = stimuli.module(cfg["design"])
    dev = run.devices[0]
    low = gen.build(cfg["params"], int(mix["test_cycles"]),
                    drv.stimulus_seeds(run.seed, int(mix["suite"])),
                    int(cfg["net_seed"]),
                    device=dev if dev.startswith("cuda") else None,
                    arith=arith)
    run.suite = drv.make_suite(run)
    B = run.batch = int(mix["batch"])
    names = sorted(low.expected)
    for lo in range(0, low.size, B):
        run.batches.append({"index": lo // B})
        run.results.append([
            Result(i, low.finish,
                   {n: int(low.expected[n][lo + i]) for n in names})
            for i in range(B)])
    checks, attempted, failed = check.compare(run)
    return {"correct": check.correct(checks, attempted),
            "attempted": attempted, "failed": failed, "checks": checks}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    a = ap.parse_args(argv)

    from rtlbench import harness
    from rtlbench.reference import NoCarry

    cell = harness.load_cell(a.workload)
    for seed in a.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, [a.device])
        out = control_checks(run, NoCarry)
        out.update(workload=a.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
