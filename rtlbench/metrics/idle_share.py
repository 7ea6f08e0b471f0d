"""Device: share of the traced window with no operation on the card, %
(the mean over the run's cards)."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.idle_share()
