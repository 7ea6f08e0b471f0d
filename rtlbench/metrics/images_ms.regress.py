"""Images: mean ms a batch in ``Bench.images_batch`` (the ``images`` span)."""


def read(run):
    spans = run.spans("images")
    if run.batch < 2 or not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) / 1e6
