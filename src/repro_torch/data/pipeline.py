# Copy of src/repro/data/pipeline.py (commit 5b8f1d0); imports may differ.
"""Deterministic synthetic token pipeline.

Counter-based (stateless-resumable): batch ``i`` is a pure function of
(seed, i), so restart-after-failure resumes exactly by restoring the step
counter from the checkpoint — no data-state files, no skew between hosts.
Each host materializes only its shard of the global batch (``host_slice``),
which is how the pipeline scales to thousands of nodes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Markov-chain-ish synthetic LM data (learnable structure, so loss
    decreases during the example training run)."""

    def __init__(self, cfg: PipelineConfig):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        B, S = self.local_batch, cfg.seq_len
        # structured stream: x[t+1] = (a*x[t] + b + noise) % vocab
        a = 31
        x = np.empty((B, S + 1), np.int64)
        x[:, 0] = rng.integers(0, cfg.vocab, (B,))
        noise = (rng.random((B, S)) < 0.1)
        rnd = rng.integers(0, cfg.vocab, (B, S))
        for t in range(S):
            nxt = (a * x[:, t] + 7) % cfg.vocab
            x[:, t + 1] = np.where(noise[:, t], rnd[:, t], nxt)
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
