"""Searcher: hydration + batched query evaluation + document fetch — the
sparse, eager part of ``repro/search/searcher.py``.

The pieces assemble exactly like Figure 1 of the paper:

    client → Gateway → FaaSRuntime(search handler)
                         ├─ hydrate index   ← ObjectStore (S3)
                         ├─ evaluate query  (stateless torch fn, on the card)
                         └─ fetch raw docs  ← KVStore (DynamoDB)

Not ported yet, and refused with ``NotImplementedError`` rather than
answered some other way: lazy range hydration (ROADMAP Queue 1 item 2),
the dense and hybrid tiers, structured ``sq``/``sqs`` payloads and
rollover prewarm pings (Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.cache import HydrationCache
from repro_torch.core.kvstore import KVStore
from repro_torch.core.refresh import GENERATION_FILE, AssetCatalog, generation_version
from repro_torch.index.builder import PackedIndex, read_segment
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.bm25 import SearchState, encode_queries, make_search_fn


@dataclasses.dataclass
class SearchConfig:
    max_terms: int = 16
    max_blocks: int = 64          # M: impact-ordered truncation per term
    k: int = 10
    accumulator: str = "dense"    # "dense" | "sorted" | "pruned" (block-max)
    use_kernel: bool = False      # hand-written BM25 kernels (K3, or K1 when pruned)
    use_topk_kernel: bool = False # hand-written streaming top-k (K2)
    # device→host transfer + deserialize throughput used to convert index
    # bytes into simulated hydration seconds (on top of store network time)
    hydrate_Bps: float = 2e9
    # Deterministic exec-time model: when set, handlers report
    # sim_exec_s (+ sim_exec_per_query_s per extra batched query) as the
    # request's compute time instead of the measured wall time of the
    # device call. Results are still really computed — only the CLOCK is
    # modeled. Leave None to measure.
    sim_exec_s: float | None = None
    sim_exec_per_query_s: float = 0.0002
    # Per-1000-docs exec term of the model (see the reference).
    sim_exec_per_kdoc_s: float = 0.0
    # NRT writer-path model (see the reference).
    sim_write_s: float | None = None
    sim_write_per_doc_s: float = 2e-5
    # Lazy (partial) hydration: None and False hydrate eagerly here; True is
    # refused until lazy hydration is ported.
    lazy_hydration: bool | None = None


class Searcher:
    """Holds the hydrated state + search fn for one index version."""

    def __init__(self, packed: PackedIndex, config: SearchConfig | None = None,
                 device=None):
        self.config = config or SearchConfig()
        self.device = resolve_device(device)
        self.packed = packed
        self.state = SearchState.from_packed(packed, self.device)
        self.vocab = packed.vocab
        cfg = self.config
        self._fn = make_search_fn(
            packed.meta.n_docs, max_terms=cfg.max_terms,
            max_blocks=cfg.max_blocks, k=cfg.k,
            accumulator=cfg.accumulator, use_kernel=cfg.use_kernel,
            use_topk_kernel=cfg.use_topk_kernel,
        )

    def search(self, queries: list[str]) -> tuple[np.ndarray, np.ndarray]:
        # Pad the batch to the next power of two, as the reference does (its
        # jitted fn specializes on Q): the same batch shapes reach the card.
        Q = len(queries)
        Qp = 1 << max(0, (Q - 1).bit_length())
        tids, qtf = encode_queries(self.vocab, queries + [""] * (Qp - Q),
                                   max_terms=self.config.max_terms,
                                   idf=self.packed.idf)
        vals, ids = self._fn(self.state, tids, qtf)
        # the copy to the host is the synchronisation the handler's exec_s sees
        return vals.cpu().numpy()[:Q], ids.cpu().numpy()[:Q]

    def search_batch(self, queries: list[str],
                     k: int | None = None) -> list[list[tuple[int, float]]]:
        """Evaluate Q queries in ONE batched device call (the micro-batch
        path); returns per-query [(internal_id, score), ...] hit lists."""
        vals, ids = self.search(queries)
        n = self.packed.meta.n_docs
        out = []
        for qi in range(len(queries)):
            hits = [(int(i), float(v)) for v, i in zip(vals[qi], ids[qi])
                    if i < n and v > 0]
            out.append(hits[: (self.config.k if k is None else k)])
        return out

    def search_one(self, query: str, k: int | None = None):
        return self.search_batch([query], k)[0]


def hydrate_searcher(catalog: AssetCatalog, asset: str,
                     config: SearchConfig,
                     version: str | None = None,
                     device=None) -> tuple[Searcher, float]:
    """Cold-start hydration: resolve the version, stream its segment files
    through the StoreDirectory, unpack, move to the device. Returns
    (searcher, simulated_s).

    A plain version directory holds one segment. Generation manifests (NRT
    base + deltas) come with the fleet's write path and are refused until
    it is ported (ROADMAP Queue 1 item 5).
    """
    store = catalog.store
    before = store.stats.sim_seconds
    version, directory = catalog.open(asset, version)
    if GENERATION_FILE in directory.list():
        raise NotImplementedError(
            "generation manifests (NRT base + deltas) are not ported yet: "
            "ROADMAP Queue 1 item 5")
    packed = read_segment(directory)
    network_s = store.stats.sim_seconds - before
    deserialize_s = packed.nbytes / config.hydrate_Bps
    return Searcher(packed, config, device), network_s + deserialize_s


def make_search_handler(catalog: AssetCatalog, doc_store: KVStore,
                        asset: str = "index",
                        config: SearchConfig | None = None,
                        device=None):
    """Build the Lambda handler: (instance_cache, payload) -> (result, exec_s).

    The hydrated Searcher lives in the *instance's* HydrationCache — a warm
    instance skips straight to query evaluation (paper §2). Payloads carry
    either ``q`` (one query → flat result) or ``queries`` (micro-batch →
    ``{"results": [...]}``, one batched device call for the whole batch).
    ``payload["gen"]`` pins the index generation.

    ``device`` (None → the card) is where every hydrated Searcher lives.
    """
    cfg = config or SearchConfig()
    if cfg.lazy_hydration:
        raise NotImplementedError("lazy range hydration (lazy_hydration=True) is not "
                                  "ported yet: ROADMAP Queue 1 item 2")
    dev = resolve_device(device)

    def handler(cache: HydrationCache, payload: dict) -> tuple[dict, float]:
        gen = payload.get("gen")
        version = (generation_version(gen) if gen is not None
                   else catalog.current_version(asset))
        mode = payload.get("mode", "sparse")
        if mode not in ("sparse", "dense", "hybrid"):
            raise ValueError(f"unknown search mode: {mode!r}")
        if mode != "sparse":
            raise NotImplementedError(
                f"mode={mode!r}: the dense tier is not ported yet "
                "(ROADMAP Queue 1 item 3, kernel K4)")
        if "sq" in payload or "sqs" in payload:
            raise NotImplementedError(
                "structured sq/sqs payloads are not ported yet "
                "(ROADMAP Queue 1 item 3)")
        if "prewarm_terms" in payload:
            raise NotImplementedError(
                "rollover prewarm pings need lazy hydration, not ported yet "
                "(ROADMAP Queue 1 item 2)")

        batched = "queries" in payload
        queries = (list(payload["queries"]) if "queries" in payload
                   else [payload["q"]] if "q" in payload else [])
        k = int(payload.get("k", cfg.k))
        n_q = len(queries)

        t0 = time.perf_counter()
        exec_s = 0.0
        searcher = cache.get_or_hydrate(
            asset, version,
            lambda: hydrate_searcher(catalog, asset, cfg, version, dev))
        sparse_hits = searcher.search_batch(queries, k)
        if cfg.sim_exec_s is not None:
            exec_s += (cfg.sim_exec_s
                       + cfg.sim_exec_per_query_s * (n_q - 1)
                       + cfg.sim_exec_per_kdoc_s
                       * searcher.packed.meta.n_docs / 1000.0)
        else:
            exec_s = time.perf_counter() - t0

        ext = searcher.packed.meta.doc_ids
        fetch = payload.get("fetch_docs", True)
        # ONE batched KV fetch for the whole micro-batch
        keys = dict.fromkeys(ext[h[0]] for hits in sparse_hits for h in hits)
        raw, fetch_s = doc_store.batch_get_billed(keys) if fetch else ({}, 0.0)
        exec_s += fetch_s
        results = []
        for hits in sparse_hits:
            ids = [h[0] for h in hits]
            ext_ids = [ext[i] for i in ids]
            results.append({
                "ids": ids,
                "scores": [h[1] for h in hits],
                "ext_ids": ext_ids,
                "docs": [raw.get(e) for e in ext_ids] if raw else [],
            })
        if batched:
            return {"version": version, "results": results}, exec_s
        out = results[0]
        out["version"] = version
        return out, exec_s

    return handler
