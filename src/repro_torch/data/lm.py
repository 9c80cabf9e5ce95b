"""Deterministic, resumable synthetic LM token pipeline.

Batches are a pure function of (seed, step) — a restarted/rescaled trainer
regenerates the exact stream from any step, which is what makes the
checkpoint/restart tests byte-exact. The token process is a Zipf-mixture
Markov chain so a ~100M model actually has structure to learn (loss drops
well below the unigram entropy within a few hundred steps).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    zipf_a: float = 1.2
    n_states: int = 64          # Markov mixture states


class LMTokenStream:
    def __init__(self, cfg: LMDataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # per-state token distributions: shifted Zipf over a state-local slice
        self._offsets = rng.integers(0, cfg.vocab, cfg.n_states)
        self._trans = rng.integers(0, cfg.n_states, (cfg.n_states, 4))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        state = rng.integers(0, cfg.n_states, cfg.batch)
        toks = np.empty((cfg.batch, cfg.seq + 1), np.int32)
        z = rng.zipf(cfg.zipf_a, (cfg.batch, cfg.seq + 1)).astype(np.int64)
        pick = rng.integers(0, 4, (cfg.batch, cfg.seq + 1))
        for t in range(cfg.seq + 1):
            toks[:, t] = (self._offsets[state] + z[:, t]) % cfg.vocab
            state = self._trans[state, pick[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
