"""Set-up: process start to the window's start (host clock), less the
seconds of the stimulus suite, whose goldens the reference steps."""


def read(run):
    return run.setup_s
