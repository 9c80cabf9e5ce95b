"""Searcher: hydration + batched query evaluation + document fetch — the
port of ``repro/search/searcher.py``.

The pieces assemble exactly like Figure 1 of the paper:

    client → Gateway → FaaSRuntime(search handler)
                         ├─ hydrate index   ← ObjectStore (S3)
                         ├─ evaluate query  (stateless torch fn, on the card)
                         └─ fetch raw docs  ← KVStore (DynamoDB)

Eager and lazy hydration, plain versions and NRT generation manifests, the
sparse, dense and hybrid tiers, structured ``sq``/``sqs`` queries (evaluated
on the searcher's device, :mod:`repro_torch.search.structured`) and rollover
prewarm pings are served.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cache import HydrationCache
from repro_torch.core.kvstore import KVStore
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.refresh import GENERATION_FILE, AssetCatalog, generation_version
from repro_torch.index.builder import (VECTOR_META_FILE, PackedIndex,
                                       combine_segments, combine_vector_segments,
                                       read_segment, read_vector_segment)
from repro_torch.index.hydration import (LazyIndex, LazyVectors, SuperIndexMissing,
                                         open_partial_segment,
                                         open_partial_vector_segment)
from repro_torch.index.tokenizer import tokenize
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.dot_topk import dot_topk_batch
from repro_torch.search.bm25 import SearchState, encode_queries, make_search_fn
from repro_torch.search.query import Query, query_from_payload
from repro_torch.search.structured import (StructuredState, StructuredUnsupported,
                                           evaluate_structured, facet_counts,
                                           structured_topk)


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
    # Lazy (partial) hydration: a cold instance answers its first query from
    # range reads of the superindex + only the queried terms' posting blocks,
    # then backfills the rest OFF the critical path (billed to the ledger's
    # backfill line). Tri-state: None means "resolver's choice" — handlers
    # treat it as eager while fleet assembly (build_partitioned_search_app)
    # flips None→True, the fleet default. Pass an explicit bool to pin
    # either mode. Segments published before the lazy layout fall back to
    # full hydration automatically.
    lazy_hydration: bool | None = None


# How many highest-df terms a rollover prewarm ping hydrates on a lazy
# instance (instead of backfilling the whole partition).
PREWARM_TOP_TERMS = 64


class DenseTierMissing(Exception):
    """This asset version carries no dense-vector tier."""


class Searcher:
    """Holds the hydrated state + search fn for one index version."""

    def __init__(self, packed: PackedIndex, config: SearchConfig | None = None,
                 device=None):
        self.config = config or SearchConfig()
        self.device = resolve_device(device)
        self.packed = packed
        self.state = SearchState.from_packed(packed, self.device)
        self.vocab = packed.vocab
        self._structured: StructuredState | None = None
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

    @property
    def structured(self) -> StructuredState:
        """The v2 sidecar on this searcher's device, built on the first
        structured query (a lazy view that grows drops the whole Searcher,
        so this state can never outlive the view it was built from)."""
        if self.packed.fields is None:
            raise StructuredUnsupported(
                "structured query against a v1 segment (publish "
                "with IndexSpec(structured=True, ...))")
        if self._structured is None:
            self._structured = StructuredState.from_packed(self.packed, self.state)
        return self._structured

    def search_structured(self, queries: list[Query], k: int, *,
                          field_avgdl: dict, facets: list[list[str]]
                          ) -> tuple[list[list[tuple[int, float]]], list[dict]]:
        """Evaluate structured ASTs on the device: each query's dense scores
        and eligibility, then ONE top-k over the stacked (Q, n_docs) scores
        and one facet count per requested field over the stacked
        eligibility. Returns per-query hit lists and {field: {value: count}}
        dicts, as the reference's handler builds them."""
        state = self.structured
        if not queries:
            return [], []
        n = state.n_docs
        evals = [evaluate_structured(state, q, field_avgdl=field_avgdl)
                 for q in queries]
        scores = torch.stack([s for s, _ in evals])
        eligible = torch.stack([e for _, e in evals])
        with torch.profiler.record_function("structured.topk"):
            vals, ids = structured_topk(scores, k)
        with torch.profiler.record_function("structured.facets"):
            counts = {f: facet_counts(state, eligible, f)
                      for f in dict.fromkeys(f for req in facets for f in req)}
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        hits = [[(int(i), float(v)) for v, i in zip(vals[qi], ids[qi])
                 if i < n and v > 0] for qi in range(len(queries))]
        return hits, [{f: counts[f][qi] for f in req}
                      for qi, req in enumerate(facets)]


def hydrate_searcher(catalog: AssetCatalog, asset: str,
                     config: SearchConfig,
                     version: str | None = None,
                     device=None) -> tuple[Searcher, float]:
    """Cold-start hydration: resolve the version, stream its segment files
    through the StoreDirectory, unpack, move to the device. Returns
    (searcher, simulated_s).

    Two version layouts hydrate through the same call:

    * a PLAIN version directory holding one segment's files, read directly;
    * a GENERATION manifest (NRT): base + ordered delta segments stream in
      and fuse into one PackedIndex (:func:`~repro_torch.index.builder.
      combine_segments`) under the generation's live stats/vocab, with
      tombstones zeroed — so the search fn never knows the index was built
      incrementally.
    """
    store = catalog.store
    before = store.stats.sim_seconds
    version, directory = catalog.open(asset, version)
    if GENERATION_FILE in directory.list():
        manifest = catalog.read_generation(asset, version)
        stats, vocab = catalog.resolve_generation_state(manifest)
        packs = [read_segment(catalog.open_segment(asset, seg))
                 for seg in manifest.segments]
        packed = combine_segments(packs, vocab=vocab, stats=stats,
                                  tombstones=manifest.tombstones)
    else:
        packed = read_segment(directory)
    network_s = store.stats.sim_seconds - before
    deserialize_s = packed.nbytes / config.hydrate_Bps
    return Searcher(packed, config, device), network_s + deserialize_s


class DenseSearcher:
    """Dense-tier twin of :class:`Searcher`: brute-force inner-product
    top-k over one partition's document embeddings through the K4 kernel,
    one launch for the query micro-batch.

    Tombstoned rows are COMPACTED OUT before scoring (dense scores are
    legitimately negative, so masking-by-zero can't express deletion the
    way the sparse tier's tf-zeroing does); live rows keep their relative
    order, so internal-id ascending tie-breaks match a full rebuild. The
    rows live on ``device``; ``nbytes`` counts them as f32, as the
    reference's host array is counted.
    """

    def __init__(self, vectors: np.ndarray, doc_ids: list[str],
                 live: np.ndarray, config: SearchConfig | None = None,
                 device=None):
        self.config = config or SearchConfig()
        self.device = resolve_device(device)
        self.doc_ids = doc_ids
        self.n_docs = len(doc_ids)
        vecs = np.asarray(vectors, dtype=np.float32)
        rows = np.ascontiguousarray(vecs[np.asarray(live, bool)])
        self.rows = torch.from_numpy(rows).to(self.device)
        self.row_internal = np.flatnonzero(live).astype(np.int32)
        self.dim = vecs.shape[1] if vecs.ndim == 2 else 0
        self.nbytes = rows.nbytes

    def search_batch(self, qvecs, k: int | None = None
                     ) -> list[list[tuple[int, float]]]:
        """Score Q query vectors in ONE kernel launch; returns per-query
        [(internal_id, score), ...] — same hit-list shape as the sparse
        tier, so the coordinator merges both identically."""
        Q = len(qvecs)
        n_live = self.rows.shape[0]
        want = self.config.k if k is None else min(k, self.config.k)
        if Q == 0 or n_live == 0:
            return [[] for _ in range(Q)]
        kk = min(self.config.k, n_live)
        # pow-2 batch pad, exactly like the sparse path and the reference
        Qp = 1 << max(0, (Q - 1).bit_length())
        qarr = np.zeros((Qp, self.rows.shape[1]), dtype=np.float32)
        for i, v in enumerate(qvecs):
            qarr[i] = np.asarray(v, dtype=np.float32)
        vals, ids = dot_topk_batch(torch.from_numpy(qarr).to(self.device),
                                   self.rows, kk)
        # the copy to the host is the synchronisation the handler's exec_s sees
        vals = vals.cpu().numpy()[:Q]
        ids = ids.cpu().numpy()[:Q]
        out = []
        for qi in range(Q):
            hits = [(int(self.row_internal[i]), float(v))
                    for v, i in zip(vals[qi], ids[qi])]
            out.append(hits[:want])
        return out


def hydrate_dense_searcher(catalog: AssetCatalog, asset: str,
                           config: SearchConfig,
                           version: str | None = None,
                           device=None) -> tuple[DenseSearcher, float]:
    """Eager dense-tier hydration: stream the generation's vector segments
    (base + deltas), fuse rows in segment order — the SAME internal-id
    space the sparse tier's ``combine_segments`` builds — and flag the
    generation's tombstones dead. Returns (searcher, simulated_s).

    Raises :class:`DenseTierMissing` when the version has no vector tier
    (sparse-only fleets); callers surface that as a bad-request, not a 500.
    """
    store = catalog.store
    before = store.stats.sim_seconds
    version, directory = catalog.open(asset, version)
    if GENERATION_FILE in directory.list():
        manifest = catalog.read_generation(asset, version)
        if manifest.vec_base is None:
            raise DenseTierMissing(asset)
        packs = [read_vector_segment(catalog.open_segment(asset, seg))
                 for seg in manifest.vec_segments]
        vectors, doc_ids, live = combine_vector_segments(
            packs, tombstones=manifest.tombstones)
    else:
        if VECTOR_META_FILE not in directory.list():
            raise DenseTierMissing(asset)
        vectors, doc_ids, live = combine_vector_segments(
            [read_vector_segment(directory)])
    network_s = store.stats.sim_seconds - before
    searcher = DenseSearcher(vectors, doc_ids, live, config, device)
    return searcher, network_s + searcher.nbytes / config.hydrate_Bps


class LazyDenseSearcher:
    """Cache entry for a lazily-hydrated dense tier.

    Cold start reads each vector segment's compact superindex (one ranged
    GET), then :meth:`ensure_live` range-reads exactly the LIVE row spans —
    tombstoned rows never move, so there is no backfill stage: once the
    live rows are resident the view is complete and queries are
    bit-identical to eager hydration.
    """

    def __init__(self, lazy: LazyVectors, config: SearchConfig,
                 store: ObjectStore, device=None) -> None:
        self.lazy = lazy
        self.config = config
        self.device = resolve_device(device)
        self._store = store
        self._searcher: DenseSearcher | None = None

    @property
    def nbytes(self) -> int:
        return self.lazy.bytes_read

    def ensure_live(self) -> tuple[bool, float]:
        """Hydrate every live row span; (changed, sim_s) priced like
        :meth:`LazySearcher._billed` (network + deserialize of new bytes)."""
        net0 = self._store.stats.sim_seconds
        bytes0 = self.lazy.bytes_read
        changed = self.lazy.ensure_live()
        sim_s = (self._store.stats.sim_seconds - net0
                 + (self.lazy.bytes_read - bytes0) / self.config.hydrate_Bps)
        if changed:
            self._searcher = None
        return changed, sim_s

    @property
    def searcher(self) -> DenseSearcher:
        if self._searcher is None:
            vectors, doc_ids, live = self.lazy.combined()
            self._searcher = DenseSearcher(vectors, doc_ids, live, self.config,
                                           self.device)
        return self._searcher


def lazy_hydrate_dense_searcher(catalog: AssetCatalog, asset: str,
                                config: SearchConfig,
                                version: str | None = None,
                                device=None) -> tuple[LazyDenseSearcher, float]:
    """Lazy twin of :func:`hydrate_dense_searcher`: superindex-only cold
    read. Raises :class:`DenseTierMissing` when the version carries no
    vector tier, :class:`SuperIndexMissing` for pre-lazy vector segments
    (callers fall back to eager)."""
    store = catalog.store
    before = store.stats.sim_seconds
    version, directory = catalog.open(asset, version)
    if GENERATION_FILE in directory.list():
        manifest = catalog.read_generation(asset, version)
        if manifest.vec_base is None:
            raise DenseTierMissing(asset)
        segments = [open_partial_vector_segment(catalog.open_segment(asset, s))
                    for s in manifest.vec_segments]
        lazy = LazyVectors(segments, tombstones=manifest.tombstones)
    else:
        if VECTOR_META_FILE not in directory.list():
            raise DenseTierMissing(asset)
        lazy = LazyVectors([open_partial_vector_segment(directory)])
    network_s = store.stats.sim_seconds - before
    deserialize_s = lazy.bytes_read / config.hydrate_Bps
    return (LazyDenseSearcher(lazy, config, store, device),
            network_s + deserialize_s)


class LazySearcher:
    """Cache entry for a lazily-hydrated index version.

    Wraps a :class:`~repro_torch.index.hydration.LazyIndex` and lends out a
    :class:`Searcher` over its CURRENT view. The view's arrays are
    full-shape from the first byte (absent terms masked non-live), so
    results over hydrated terms are bit-identical to full hydration. Every
    change of the view rebuilds the Searcher, which copies the view's
    full-shape arrays to the device again.
    """

    def __init__(self, index: LazyIndex, config: SearchConfig,
                 store: ObjectStore, device=None) -> None:
        self.index = index
        self.config = config
        self.device = resolve_device(device)
        self._store = store           # billing seam: range-read sim seconds
        self._searcher: Searcher | None = None

    @property
    def full(self) -> bool:
        return self.index.state == "full"

    @property
    def nbytes(self) -> int:
        # what the cache's byte budget sees: the bytes actually streamed
        # into this instance so far (grows partial → full via note_backfill)
        return self.index.bytes_read

    def _billed(self, action) -> tuple[bool, float]:
        """Run ``action() -> changed`` and price it: store network seconds
        (range-read first-byte + bandwidth) + deserialize time for the new
        bytes. Invalidates the lent-out Searcher when the view grew."""
        net0 = self._store.stats.sim_seconds
        bytes0 = self.index.bytes_read
        changed = action()
        sim_s = (self._store.stats.sim_seconds - net0
                 + (self.index.bytes_read - bytes0) / self.config.hydrate_Bps)
        if changed:
            self._searcher = None
        return changed, sim_s

    def ensure_queries(self, queries: list[str]) -> tuple[bool, float]:
        """Hydrate the posting blocks every term of ``queries`` names;
        (changed, sim_s). On-critical-path: callers account ``sim_s`` as
        hydration."""
        return self.ensure_terms(
            {t for q in queries for t in tokenize(q)})

    def ensure_terms(self, terms) -> tuple[bool, float]:
        """Hydrate specific terms' posting blocks — the structured path
        hands in its ASTs' term set directly (the same coalesced ranged
        GETs also pull those rows' field/position payload on v2
        segments). Priced exactly like :meth:`ensure_queries`."""
        terms = set(terms)
        return self._billed(lambda: self.index.ensure_terms(terms))

    def ensure_top_terms(self, n: int) -> tuple[bool, float]:
        """Hydrate the ``n`` highest-document-frequency terms' blocks —
        the rollover-prewarm working set. (changed, sim_s), priced like
        :meth:`ensure_queries`."""
        terms = self.index.top_terms(n)
        return self._billed(lambda: self.index.ensure_terms(terms))

    def backfill(self) -> tuple[bool, float]:
        """Upgrade partial → full; (changed, sim_s). Off-critical-path:
        callers account ``sim_s`` as backfill, never latency."""
        return self._billed(self.index.backfill)

    @property
    def searcher(self) -> Searcher:
        if self._searcher is None:
            self._searcher = Searcher(self.index.packed(), self.config, self.device)
        return self._searcher


def lazy_hydrate_searcher(catalog: AssetCatalog, asset: str,
                          config: SearchConfig,
                          version: str | None = None,
                          device=None) -> tuple[LazySearcher, float]:
    """Partial cold-start hydration: ONE ranged GET per segment pulls the
    compact superindex (term extents + block_max + doc lengths + idf); no
    posting payload moves yet. Returns (entry, simulated_s) — the lazy
    replacement for :func:`hydrate_searcher`'s full streaming.

    Raises :class:`~repro_torch.index.hydration.SuperIndexMissing` for
    segments published before the lazy layout; callers fall back to full
    hydration.
    """
    store = catalog.store
    before = store.stats.sim_seconds
    version, directory = catalog.open(asset, version)
    if GENERATION_FILE in directory.list():
        manifest = catalog.read_generation(asset, version)
        stats, vocab = catalog.resolve_generation_state(manifest)
        segments = [open_partial_segment(catalog.open_segment(asset, seg))
                    for seg in manifest.segments]
        index = LazyIndex(segments, vocab=vocab, stats=stats,
                          tombstones=manifest.tombstones)
    else:
        index = LazyIndex([open_partial_segment(directory)])
    network_s = store.stats.sim_seconds - before
    deserialize_s = index.bytes_read / config.hydrate_Bps
    return LazySearcher(index, config, store, device), network_s + deserialize_s


def make_search_handler(catalog: AssetCatalog, doc_store: KVStore,
                        asset: str = "index",
                        config: SearchConfig | None = None,
                        device=None):
    """Build the Lambda handler: (instance_cache, payload) -> (result, exec_s).

    The hydrated Searcher lives in the *instance's* HydrationCache — a warm
    instance skips straight to query evaluation (paper §2).

    Payloads carry either ``q`` (one query → flat result) or ``queries``
    (micro-batch → ``{"results": [...]}``, one batched device call for the
    whole batch — how the gateway absorbs concurrent traffic without one
    invocation per query).

    ``payload["mode"]`` selects the tier(s): ``"sparse"`` (BM25, the
    default), ``"dense"`` (embedding inner product through K4; query
    vectors arrive as ``qv``/``qvs``, embedded at the coordinator so every
    replica scores identical floats), or ``"hybrid"`` (both tiers evaluated
    on the SAME instance against the SAME pinned generation; dense hit
    lists ride along under ``result["dense"]`` for the coordinator's RRF
    fusion). Each tier hydrates only when a payload needs it, and dense
    entries are cached under ``version + "+vec"`` so eviction drops both
    tiers together. Responses that served the dense tier stamp
    ``vec_version`` so the coordinator's generation check can refuse
    cross-tier generation skew.

    ``payload["prewarm_terms"]`` (with optional ``prewarm_dense``) marks a
    rollover-prewarm ping: hydrate the n highest-df terms' blocks (and the
    dense tier's live rows) on a lazy instance WITHOUT evaluating a query
    and WITHOUT triggering backfill.

    ``payload["gen"]`` (an int) PINS the index generation: the handler
    serves exactly that generation, hydrating it if this instance hasn't
    seen it yet. Unpinned payloads resolve the asset manifest's current
    version (the single-function app's path).

    STRUCTURED payloads carry ``sq`` (one AST payload dict) or ``sqs`` (a
    micro-batch of them) instead of text — the coordinator parsed the DSL
    at admission; workers never re-parse. They evaluate on the searcher's
    device over the v2 packed arrays (:meth:`Searcher.search_structured`,
    bit-identical across partitioning and to the reference), honouring
    ``facets`` (per-query facet-field requests, counted over the full
    eligible set) and ``favg`` (the generation's live per-field avgdls).
    Requires a segment published with field/position data — a structured
    payload against a v1 segment raises
    :class:`~repro_torch.search.structured.StructuredUnsupported`.

    ``device`` (None → the card) is where every hydrated searcher lives.
    """
    cfg = config or SearchConfig()
    lazy = bool(cfg.lazy_hydration)   # None (resolver's choice) → eager
    dev = resolve_device(device)

    def handler(cache: HydrationCache, payload: dict) -> tuple[dict, float]:
        gen = payload.get("gen")
        version = (generation_version(gen) if gen is not None
                   else catalog.current_version(asset))
        mode = payload.get("mode", "sparse")
        if mode not in ("sparse", "dense", "hybrid"):
            raise ValueError(f"unknown search mode: {mode!r}")

        def _hydrate():
            if lazy:
                try:
                    return lazy_hydrate_searcher(catalog, asset, cfg, version, dev)
                except SuperIndexMissing:
                    pass   # pre-lazy-layout segment: eager fallback
            return hydrate_searcher(catalog, asset, cfg, version, dev)

        def _hydrate_dense():
            # cached under version+"+vec": HydrationCache.invalidate(asset)
            # drops every version of every key for the asset name, so both
            # tiers evict together on rollover/budget pressure
            if lazy:
                try:
                    dentry, sim_s = lazy_hydrate_dense_searcher(
                        catalog, asset, cfg, version, dev)
                    # the live rows ARE the dense working set — pull them
                    # inside the hydration charge (header + live spans;
                    # tombstoned rows never move, so no backfill stage)
                    _, more = dentry.ensure_live()
                    return dentry, sim_s + more
                except SuperIndexMissing:
                    pass   # pre-lazy vector segment: eager fallback
            return hydrate_dense_searcher(catalog, asset, cfg, version, dev)

        # Rollover prewarm ping: warm the head-term working set (and the
        # dense tier when asked) without evaluating a query and without
        # backfilling.
        if "prewarm_terms" in payload:
            entry = cache.get_or_hydrate(asset, version, _hydrate)
            if isinstance(entry, LazySearcher) and not entry.full:
                changed, sim_s = entry.ensure_top_terms(
                    int(payload["prewarm_terms"]))
                if changed:
                    cache.note_hydration(sim_s)
            if payload.get("prewarm_dense"):
                cache.get_or_hydrate(asset, version + "+vec", _hydrate_dense)
            return {"version": version, "prewarmed": True}, 0.0

        need_sparse = mode in ("sparse", "hybrid")
        need_dense = mode in ("dense", "hybrid")
        batched = ("queries" in payload or "qvs" in payload
                   or "sqs" in payload)
        queries = (list(payload["queries"]) if "queries" in payload
                   else [payload["q"]] if "q" in payload else [])
        qvecs = (list(payload["qvs"]) if "qvs" in payload
                 else [payload["qv"]] if "qv" in payload else [])
        # structured (format-v2) queries arrive as admission-parsed AST
        # payloads (sq/sqs) — never re-parsed here — with per-query facet
        # requests and the generation's live field avgdls (favg)
        sq_payloads = (list(payload["sqs"]) if "sqs" in payload
                       else [payload["sq"]] if "sq" in payload else None)
        if sq_payloads is not None and mode != "sparse":
            raise StructuredUnsupported(
                "structured queries are sparse-tier only")
        k = int(payload.get("k", cfg.k))
        n_q = (len(sq_payloads) if sq_payloads is not None
               else len(qvecs) if mode == "dense" else len(queries))
        if need_dense and len(qvecs) != n_q:
            raise ValueError("hybrid query needs one vector per text query")

        t0 = time.perf_counter()
        exec_s = 0.0
        sparse_hits = dense_hits = facets_out = None
        searcher = dsearcher = None
        entry = None
        if need_sparse:
            entry = cache.get_or_hydrate(asset, version, _hydrate)
            if sq_payloads is not None:
                queries_ast = [query_from_payload(d) for d in sq_payloads]
                if isinstance(entry, LazySearcher):
                    # pull exactly the ASTs' term blocks — the same
                    # coalesced ranged GETs bring the v2 field/position
                    # rows along at the wider pitch
                    changed, sim_s = entry.ensure_terms(
                        {t for q in queries_ast for t in q.terms})
                    if changed:
                        cache.note_hydration(sim_s)
                    searcher = entry.searcher
                else:
                    searcher = entry
                # evaluated on the device's dense path — ALWAYS, even on
                # pruned fleets: field/phrase-modified impacts invalidate
                # the v1 block_max ceilings, so block-max pruning would be
                # unsound for structured queries
                sparse_hits, facets_out = searcher.search_structured(
                    queries_ast, k, field_avgdl=payload.get("favg") or {},
                    facets=payload.get("facets") or [[]] * n_q)
            else:
                if isinstance(entry, LazySearcher):
                    # pull exactly this batch's term blocks — on the
                    # critical path, so it accounts as hydration (a warm
                    # instance whose view already covers the terms pays
                    # nothing here)
                    changed, sim_s = entry.ensure_queries(queries)
                    if changed:
                        cache.note_hydration(sim_s)
                    searcher = entry.searcher
                else:
                    searcher = entry
                sparse_hits = searcher.search_batch(queries, k)
            if cfg.sim_exec_s is not None:
                exec_s += (cfg.sim_exec_s
                           + cfg.sim_exec_per_query_s * (n_q - 1)
                           + cfg.sim_exec_per_kdoc_s
                           * searcher.packed.meta.n_docs / 1000.0)
        if need_dense:
            dentry = cache.get_or_hydrate(asset, version + "+vec",
                                          _hydrate_dense)
            dsearcher = (dentry.searcher
                         if isinstance(dentry, LazyDenseSearcher) else dentry)
            dense_hits = dsearcher.search_batch(qvecs, k)
            if cfg.sim_exec_s is not None:
                # each tier is its own device call, so the model charges
                # the per-invocation base once per tier
                exec_s += (cfg.sim_exec_s
                           + cfg.sim_exec_per_query_s * (n_q - 1)
                           + cfg.sim_exec_per_kdoc_s
                           * dsearcher.n_docs / 1000.0)
        if cfg.sim_exec_s is None:
            exec_s = time.perf_counter() - t0

        primary = sparse_hits if need_sparse else dense_hits
        ext_sparse = searcher.packed.meta.doc_ids if searcher else None
        ext_dense = dsearcher.doc_ids if dsearcher is not None else None
        primary_ext = ext_sparse if need_sparse else ext_dense
        fetch = payload.get("fetch_docs", True)
        # ONE batched KV fetch for the whole micro-batch; hybrid unions both
        # tiers' hit ids so fused results materialize from one round trip
        keys = dict.fromkeys(primary_ext[h[0]]
                             for hits in primary for h in hits)
        if mode == "hybrid":
            keys.update(dict.fromkeys(ext_dense[h[0]]
                                      for hits in dense_hits for h in hits))
        raw, fetch_s = doc_store.batch_get_billed(keys) if fetch else ({}, 0.0)
        exec_s += fetch_s
        results = []
        for qi in range(n_q):
            hits = primary[qi]
            ids = [h[0] for h in hits]
            ext_ids = [primary_ext[i] for i in ids]
            r = {
                "ids": ids,
                "scores": [h[1] for h in hits],
                "ext_ids": ext_ids,
                "docs": [raw.get(e) for e in ext_ids] if raw else [],
            }
            if facets_out is not None:
                # per-partition scatter-add over the FULL eligible match
                # set; the coordinator merges these at gather like top-k
                r["facets"] = facets_out[qi]
            if mode == "hybrid":
                dh = dense_hits[qi]
                r["dense"] = {
                    "ids": [h[0] for h in dh],
                    "scores": [h[1] for h in dh],
                    "ext_ids": [ext_dense[h[0]] for h in dh],
                }
            results.append(r)
        # response is fully computed — NOW backfill partial → full, off the
        # critical path: the runtime bills the cache's backfill delta to its
        # own ledger line and excludes it from this request's latency
        if (need_sparse and isinstance(entry, LazySearcher)
                and not entry.full):
            _, bf_s = entry.backfill()
            cache.note_backfill(asset, version, bf_s, nbytes=entry.nbytes)

        if batched:
            out = {"version": version, "results": results}
        else:
            out = results[0]
            out["version"] = version
        if need_dense:
            out["vec_version"] = version
        return out, exec_s

    return handler
