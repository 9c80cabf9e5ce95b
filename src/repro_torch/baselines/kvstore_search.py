"""Crane & Lin (ICTIR 2017) baseline: postings lists in a KV store — the
port of ``repro/baselines/kvstore_search.py``, plain Python as there: it
models the 2017 design's DynamoDB fetches and Python scoring, so nothing
of it runs on the card.

The design the paper improves on: "postings lists are stored in the DynamoDB
data store and query execution is handled by Lambda. ... End-to-end query
latency was around three seconds."

Every query term costs a DynamoDB round-trip to fetch its (full) postings
list, plus value deserialization at DynamoDB throughput; scoring happens in
plain Python (their custom query evaluator — no Lucene). No cache: DynamoDB
*is* the index store, so every invocation pays the fetches again. That
per-query store traffic is exactly why Anlessini's hydrate-once design wins
an order of magnitude.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter

from repro_torch.core.kvstore import KVModel, KVStore
from repro_torch.index.tokenizer import tokenize


@dataclasses.dataclass
class KVPostingsConfig:
    k1: float = 0.9
    b: float = 0.4
    # DynamoDB read throughput for large items (postings are big values):
    # ~1MB/s effective for sequential 400KB-item pages circa 2017.
    value_Bps: float = 4e6
    item_page_bytes: int = 400 << 10   # DynamoDB max item size 400KB → paging
    python_score_s_per_posting: float = 2.0e-7


class KVPostingsIndex:
    """Builds the baseline layout: one KV item (or page chain) per term."""

    def __init__(self, kv: KVStore | None = None,
                 config: KVPostingsConfig | None = None) -> None:
        self.kv = kv if kv is not None else KVStore(KVModel())
        self.config = config or KVPostingsConfig()
        self.n_docs = 0
        self.avgdl = 0.0

    def build(self, docs: list[tuple[str, str]]) -> None:
        postings: dict[str, dict[int, int]] = {}
        doc_len = []
        for i, (_, text) in enumerate(docs):
            toks = tokenize(text)
            doc_len.append(len(toks))
            for t, tf in Counter(toks).items():
                postings.setdefault(t, {})[i] = min(tf, 255)
        self.n_docs = len(docs)
        self.avgdl = sum(doc_len) / max(1, len(doc_len))
        self.kv.put("__stats__", {"n_docs": self.n_docs, "avgdl": self.avgdl,
                                  "doc_len": doc_len})
        for term, plist in postings.items():
            self.kv.put(f"p/{term}", {
                "df": len(plist),
                "docs": list(plist.keys()),
                "tfs": list(plist.values()),
            })

    # -- query path (the ~3s design) ------------------------------------------

    def search(self, query: str, k: int = 10):
        """Returns (hits, simulated_latency_s)."""
        cfg = self.config
        sim_s = 0.0
        stats = self.kv.get("__stats__")
        sim_s += self.kv.model.get_s
        n_docs, avgdl, doc_len = stats["n_docs"], stats["avgdl"], stats["doc_len"]

        scores: dict[int, float] = {}
        n_postings = 0
        for term, qtf in Counter(tokenize(query)).items():
            key = f"p/{term}"
            if key not in self.kv:
                continue
            item = self.kv.get(key)
            df = item["df"]
            # value transfer: postings bytes at DynamoDB throughput, paged
            nbytes = df * 8
            pages = max(1, -(-nbytes // cfg.item_page_bytes))
            sim_s += pages * self.kv.model.get_s + nbytes / cfg.value_Bps
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            for doc, tf in zip(item["docs"], item["tfs"]):
                dl = doc_len[doc]
                denom = tf + cfg.k1 * (1 - cfg.b + cfg.b * dl / avgdl)
                scores[doc] = scores.get(doc, 0.0) + qtf * idf * tf / denom
            n_postings += df
        sim_s += n_postings * cfg.python_score_s_per_posting
        ranked = sorted(scores.items(), key=lambda kv_: (-kv_[1], kv_[0]))[:k]
        return ranked, sim_s
