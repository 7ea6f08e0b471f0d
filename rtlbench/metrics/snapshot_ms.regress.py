"""Results: mean ms a batch of ``run_batch`` outside the engine's own
``chunks_s`` (the chunks and the registers' copy), i.e. the snapshots."""


def read(run):
    rows = [b for b in run.batches if b["chunks_s"] is not None]
    if run.batch < 2 or not rows:
        return None
    return sum((b["t3"] - b["t2"]) / 1e6 - b["chunks_s"] * 1e3
               for b in rows) / len(rows)
