"""Kernel at B=1: chunk device time over Vcycles times the busiest core's
live rows in the Program, ns."""
from rtlbench import roofline


def read(run):
    tr = run.trace
    if tr is None or run.batch != 1 or not tr.chunk_launches():
        return None
    busiest = roofline.chunk_work(run.program).busiest
    return tr.chunk_s() * 1e9 / (run.tests * run.suite.finish * busiest)
