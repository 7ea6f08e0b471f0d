"""Kernel: the chunk kernel's share of its roofline, %: the least time of
its launches in the window (``roofline.py``, from the Program) over their
device time in the trace."""
from rtlbench import roofline


def read(run):
    tr = run.trace
    if tr is None or run.batch < 2 or not tr.chunk_launches():
        return None
    # each device's launches run its shard of the batch
    per_launch = run.batch // max(tr.n_devices, 1)
    least = roofline.least_s(roofline.chunk_work(run.program), per_launch,
                             tr.chunk_launches(),
                             run.tests * run.suite.finish)
    return 100.0 * least / tr.chunk_s()
