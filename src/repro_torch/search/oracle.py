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

:class:`StructuredOracleSearcher` extends the pin to the v2 structured
surface: it packs the FULL corpus into one v2 segment and evaluates it on
``device`` with the very same :mod:`repro_torch.search.structured`
functions the fleet's partitions run — top-k scores must be BIT-identical
through the merge, facet counts and phrase match sets exactly equal. Its
``exact_*`` methods are an independent dict-based twin computed straight
from raw text (applying the format's documented POS_SLOTS truncation rule),
so tests can pin the packed evaluator against an implementation that shares
none of its code.
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


class StructuredOracleSearcher:
    """Exact structured retrieval over the full corpus — the fleet's pin
    for fielded scoring, phrases, facets, and match sets.

    Scores come from ONE full-corpus v2 pack evaluated by the shared
    :func:`repro_torch.search.structured.evaluate_structured` (bit-parity with
    the partitioned fleet is structural: every per-leaf input is global or
    per-doc). The ``exact_*`` twins recompute match sets and facet counts
    from raw text with the identical stored-occurrence truncation, sharing
    no code with the packer — the independent cross-check."""

    def __init__(self, docs: "list[tuple[str, Any]]", *,
                 facet_fields: Sequence[str] = (), k1: float = 0.9,
                 b: float = 0.4, device=None) -> None:
        from repro_torch.index.builder import (IndexWriter, POS_SLOTS,
                                               compute_global_stats, field_avgdl)
        from repro_torch.search.structured import StructuredState
        self.docs = list(docs)
        self.doc_ids = [d for d, _ in self.docs]
        self.pos_slots = POS_SLOTS
        w = IndexWriter(k1=k1, b=b, structured=True,
                        facet_fields=tuple(facet_fields))
        for ext_id, text in self.docs:
            w.add(ext_id, text)
        self.packed = w.pack()
        self.state = StructuredState.from_packed(self.packed,
                                                 device=resolve_device(device))
        stats = compute_global_stats(self.docs, fields=True)
        self.field_avgdl = {f: field_avgdl(stats, f)
                            for f in stats.get("fields", {})}

    def _query(self, query):
        from repro_torch.search.query import Query, parse_query
        return query if isinstance(query, Query) else parse_query(query)

    def evaluate(self, query) -> tuple["torch.Tensor", "torch.Tensor"]:
        """(scores, eligible) over the full corpus, on the oracle's device."""
        from repro_torch.search.structured import evaluate_structured
        return evaluate_structured(self.state, self._query(query),
                                   field_avgdl=self.field_avgdl)

    def search(self, query, k: int = 10) -> list[tuple[int, float]]:
        """Top-k (global doc index, f32 score), ties (-score, index) —
        the same order the fleet's (-score, partition, doc_id) merge
        induces on ``live_corpus()`` global indices."""
        from repro_torch.search.structured import structured_topk
        scores, _ = self.evaluate(query)
        vals, ids = structured_topk(scores, k)
        return [(int(i), float(v)) for v, i in zip(vals.cpu().numpy(), ids.cpu().numpy())
                if v > 0.0]

    def match_set(self, query) -> set[int]:
        _, eligible = self.evaluate(query)
        return set(torch.nonzero(eligible).reshape(-1).cpu().tolist())

    def facet_counts(self, query, facet_field: str) -> dict[str, int]:
        from repro_torch.search.structured import facet_counts
        _, eligible = self.evaluate(query)
        return facet_counts(self.state, eligible, facet_field)

    # -- independent dict-based twins (no packed-array code shared) --------

    def _stored_occurrences(self, text) -> dict[str, list[tuple[str, int]]]:
        """term -> first POS_SLOTS (field, position) occurrences, in
        tokenize_positions order — the format's truncation rule restated
        from the raw text."""
        from repro_torch.index.tokenizer import tokenize_positions
        occ: dict[str, list[tuple[str, int]]] = {}
        for fld, tok, pos in tokenize_positions(text):
            lst = occ.setdefault(tok, [])
            if len(lst) < self.pos_slots:
                lst.append((fld, pos))
        return occ

    def _leaf_matches(self, leaf, text) -> bool:
        occ = self._stored_occurrences(text)
        if leaf.kind == "term":
            t = leaf.terms[0]
            if leaf.field is None:
                return t in occ      # every present term stores ≥1 occurrence
            return any(f == leaf.field for f, _ in occ.get(t, ()))
        sets = [set(occ.get(t, ())) for t in leaf.terms]
        if not all(sets):
            return False
        for f, p in sets[0]:
            if leaf.field is not None and f != leaf.field:
                continue
            if all((f, p + i) in sets[i] for i in range(1, len(sets))):
                return True
        return False

    def exact_match_set(self, query) -> set[int]:
        q = self._query(query)
        if not q.leaves:
            return set()
        out = set()
        for i, (_, text) in enumerate(self.docs):
            hits = sum(self._leaf_matches(lf, text) for lf in q.leaves)
            ok = hits == len(q.leaves) if q.conjunctive else hits > 0
            if ok:
                out.add(i)
        return out

    def exact_facet_counts(self, query, facet_field: str) -> dict[str, int]:
        from repro_torch.index.tokenizer import field_items
        counts: dict[str, int] = {}
        for i in self.exact_match_set(query):
            val = dict(field_items(self.docs[i][1])).get(facet_field)
            if val:
                counts[str(val)] = counts.get(str(val), 0) + 1
        return counts


def hybrid_oracle_fuse(sparse_ranked: Sequence[tuple[int, float]],
                       dense_ranked: Sequence[tuple[int, float]],
                       k: int) -> list[tuple[int, float]]:
    """RRF-fuse the two oracles' (global index, score) rankings with the
    SAME ``rrf_fuse`` call the fleet coordinator makes, in the same
    (sparse, dense) tier order — fused scores are bit-identical to the
    fleet's, and the keys are global doc indices."""
    return rrf_fuse([[d for d, _ in sparse_ranked],
                     [d for d, _ in dense_ranked]], k)
