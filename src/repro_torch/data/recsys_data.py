"""Synthetic click-log / sequence pipelines for the recsys archs.

Labels come from a hidden FM teacher over the same id space, so CTR training
has real signal (logloss decreases); sequences follow item-popularity Zipf
with short-range repetition like production behavior logs. Deterministic in
(seed, step) — resumable, like the LM stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CTRStream:
    """Batches for fm/dcn/bst: sparse ids (+dense), teacher-scored labels."""

    n_sparse: int
    rows_per_field: int
    batch: int
    n_dense: int = 0
    seq_len: int = 0            # >0 → also emit behavior sequences (bst)
    n_items: int = 0
    seed: int = 0
    teacher_dim: int = 8

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._tv = rng.normal(size=(self.n_sparse, self.teacher_dim)) * 0.5
        self._bias = rng.normal() * 0.1

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B = self.batch
        sparse = (rng.zipf(1.3, (B, self.n_sparse)) %
                  self.rows_per_field).astype(np.int32)
        # teacher: hash id → pseudo-embedding via sin features
        phase = (sparse[..., None] * 0.37 + np.arange(self.teacher_dim) * 1.7)
        emb = np.sin(phase) * self._tv[None]
        score = emb.sum((1, 2)) + self._bias
        label = (rng.random(B) < 1 / (1 + np.exp(-score))).astype(np.float32)
        out = {"sparse": sparse, "label": label}
        if self.n_dense:
            out["dense"] = rng.normal(size=(B, self.n_dense)).astype(np.float32)
        if self.seq_len:
            out["seq"] = (rng.zipf(1.3, (B, self.seq_len)) %
                          self.n_items).astype(np.int32)
            out["target"] = (rng.zipf(1.3, B) % self.n_items).astype(np.int32)
        return out


@dataclasses.dataclass
class SequenceStream:
    """bert4rec masked-item batches (mask_pos/labels/neg_ids form)."""

    n_items: int
    seq_len: int
    batch: int
    n_mask: int = 32
    n_neg: int = 1024
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.batch, self.seq_len
        n_mask = min(self.n_mask, S)
        n_neg = min(self.n_neg, self.n_items)
        seq = (rng.zipf(1.2, (B, S)) % self.n_items).astype(np.int32)
        # short-range repetition: 20% of positions repeat an earlier item
        rep = rng.random((B, S)) < 0.2
        shift = rng.integers(1, 5, (B, S))
        idx = np.maximum(np.arange(S)[None] - shift, 0)
        seq = np.where(rep, np.take_along_axis(seq, idx, 1), seq)

        mask_pos = np.stack([rng.choice(S, n_mask, replace=False)
                             for _ in range(B)]).astype(np.int32)
        labels = np.take_along_axis(seq, mask_pos, 1).astype(np.int32)
        masked = seq.copy()
        np.put_along_axis(masked, mask_pos, self.n_items + 1, 1)  # [MASK]
        neg = (rng.zipf(1.2, n_neg) % self.n_items).astype(np.int32)
        return {"seq": masked, "mask_pos": mask_pos, "labels": labels,
                "neg_ids": neg}
