"""Dispatch: the mean device-idle gap between consecutive chunk kernels of
one ``run_batch`` (one host sync a chunk), in us, from the trace."""


def read(run):
    if run.trace is None:
        return None
    g = run.trace.chunk_gaps_ns()
    return float(g.mean()) / 1e3 if len(g) else None
