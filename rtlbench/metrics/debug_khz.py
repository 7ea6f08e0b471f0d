"""One test's simulation speed: Vcycles of the one stimulus's tests run to
their end in the window, over the window's seconds, in thousands a second."""


def read(run):
    if run.batch != 1:
        return None
    return run.tests * run.suite.finish / run.window_s / 1e3
