"""Regression throughput: stimulus-cycles of the tests run to their end in
the window, over the window's seconds, in millions a second."""


def read(run):
    if run.batch < 2:
        return None
    return run.tests * run.suite.finish / run.window_s / 1e6
