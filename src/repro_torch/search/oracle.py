"""Exact reference searchers — the correctness oracles for the fleet, the
port of ``repro/search/oracle.py``.

:class:`OracleSearcher` is dict-based BM25: the same Lucene variant as the
builder (no (k1+1) numerator), with the same uint8 tf clamp, so the blocked
path must match to float tolerance whenever block truncation (M) does not
drop postings.

:class:`DenseOracleSearcher` is the dense tier's twin: brute-force inner
products over the full corpus through K4's plain twin
(:func:`repro_torch.kernels.ref.dot_topk_batch_ref`), whose per-row order
depends on D alone, so per-partition fleet scores must be BIT-identical,
not merely close. ``hybrid_oracle_fuse`` runs the same Reciprocal Rank
Fusion the coordinator runs, over the two oracles' rankings.

``StructuredOracleSearcher`` waits with the structured tier (ROADMAP
Queue 1 item 3).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.partition import rrf_fuse
from repro_torch.index.tokenizer import tokenize
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.ref import dot_topk_batch_ref


class OracleSearcher:
    def __init__(self, docs: list[tuple[str, str]], *, k1: float = 0.9,
                 b: float = 0.4) -> None:
        self.k1, self.b = k1, b
        self.doc_ids = [d for d, _ in docs]
        self.doc_toks = [tokenize(t) for _, t in docs]
        self.doc_len = [len(t) for t in self.doc_toks]
        self.avgdl = sum(self.doc_len) / max(1, len(self.doc_len))
        self.postings: dict[str, dict[int, int]] = {}
        for i, toks in enumerate(self.doc_toks):
            for t, tf in Counter(toks).items():
                self.postings.setdefault(t, {})[i] = min(tf, 255)
        self.n_docs = len(docs)

    def idf(self, term: str) -> float:
        df = len(self.postings.get(term, {}))
        return math.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))

    def search(self, query: str, k: int = 10) -> list[tuple[int, float]]:
        scores: dict[int, float] = {}
        for term, qtf in Counter(tokenize(query)).items():
            plist = self.postings.get(term)
            if not plist:
                continue
            idf = self.idf(term)
            for doc, tf in plist.items():
                dl = self.doc_len[doc]
                denom = tf + self.k1 * (1 - self.b + self.b * dl / self.avgdl)
                scores[doc] = scores.get(doc, 0.0) + qtf * idf * tf / denom
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:k]


class DenseOracleSearcher:
    """Exact dense ranking over the FULL corpus, scored by K4's plain twin
    on ``device`` (None → the card), never by the kernel.

    Index ``docs`` in the fleet's ``live_corpus()`` order: global index i
    here is then (partition, internal id) in ascending order, so the
    fleet's cross-partition (-score, partition, doc_id) merge and this
    oracle's (-score, index) ranking share tie-breaks exactly.
    """

    def __init__(self, docs: list[tuple[str, str]],
                 embedder: "Callable[[str], Any]", device=None) -> None:
        self.doc_ids = [d for d, _ in docs]
        self.embedder = embedder
        self.device = resolve_device(device)
        if docs:
            vectors = np.stack([embedder(t) for _, t in docs]).astype(np.float32)
        else:
            vectors = np.zeros((0, 1), dtype=np.float32)
        self.vectors = torch.from_numpy(vectors).to(self.device)

    def search(self, query: "str | Sequence[float]",
               k: int = 10) -> list[tuple[int, float]]:
        """Top-k (global index, score); ``query`` is text (embedded here,
        exactly as the coordinator embeds) or a pre-computed vector."""
        n = self.vectors.shape[0]
        if n == 0:
            return []
        qv = (self.embedder(query) if isinstance(query, str)
              else np.asarray(query, dtype=np.float32))
        q = torch.from_numpy(np.asarray(qv, dtype=np.float32)[None, :]).to(self.device)
        vals, ids = dot_topk_batch_ref(q, self.vectors, min(k, n))
        return [(int(i), float(v))
                for v, i in zip(vals[0].cpu().numpy(), ids[0].cpu().numpy())]


def hybrid_oracle_fuse(sparse_ranked: Sequence[tuple[int, float]],
                       dense_ranked: Sequence[tuple[int, float]],
                       k: int) -> list[tuple[int, float]]:
    """RRF-fuse the two oracles' (global index, score) rankings with the
    SAME ``rrf_fuse`` call the fleet coordinator makes, in the same
    (sparse, dense) tier order — fused scores are bit-identical to the
    fleet's, and the keys are global doc indices."""
    return rrf_fuse([[d for d, _ in sparse_ranked],
                     [d for d, _ in dense_ranked]], k)
