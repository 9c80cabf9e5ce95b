"""End-to-end Anlessini application assembly (Figure 1 of the paper) — the
port of ``repro/search/service.py``'s read path.

``build_search_app`` wires corpus → index → object store → FaaS runtime →
gateway and returns the pieces.

``build_partitioned_search_app`` is the §3 scale-out assembly: the corpus
splits into N partitions, each published as generation 1 of its own asset
(packed with GLOBAL idf/avgdl) and served by its own Lambda function;
``/search`` fans out through ScatterGather and merges per-partition top-k
into a globally-ranked result — sparse (BM25), dense (K4 inner products)
or hybrid (both, fused with Reciprocal Rank Fusion). With ``replicas=R``
each segment is served by R independent instance pools and a
``HedgePolicy`` fires backup legs on replicas when a primary projects
cold/queued.

The fleet's write path (``POST /index``, commits, forks), its autoscaler
and the structured tier are not ported yet: they raise
``NotImplementedError`` naming their ROADMAP Queue 1 item.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Iterable

import numpy as np

from repro_torch.core.gateway import (BadRequest, Gateway, PendingResponse,
                                      WindowPolicy)
from repro_torch.core.kvstore import KVStore
from repro_torch.core.object_store import Backend, ObjectStore
from repro_torch.core.partition import (FleetSpec, GatewaySpec, HedgePolicy,
                                        IndexSpec, PartitionHit, ReplicationSpec,
                                        ScatterGather, _merge_hits, rrf_fuse)
from repro_torch.core.refresh import AssetCatalog, GenerationManifest
from repro_torch.core.runtime import FaaSRuntime, InvocationRecord, RuntimeConfig
from repro_torch.data.corpus import hash_embedder
from repro_torch.index.builder import (IndexWriter, MergePolicy,
                                       compute_global_stats, global_vocab,
                                       pack_vectors, write_segment,
                                       write_vector_segment)
from repro_torch.index.tokenizer import flatten_text
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.distributed import partition_corpus
from repro_torch.search.searcher import SearchConfig, make_search_handler

SEARCH_MODES = ("sparse", "dense", "hybrid")
WRITE_PATH = "the fleet's write path is not ported yet: ROADMAP Queue 1 item 5"


def _search_body(q: "str | list[str] | None", k: int, fetch_docs: bool,
                 mode: str = "sparse", vector=None) -> dict:
    """The ``/search`` body: ``q`` for one query, ``queries`` for a
    micro-batch (one invocation); ``qv``/``qvs`` carry query vectors."""
    body = {"k": k, "fetch_docs": fetch_docs}
    if mode != "sparse":
        body["mode"] = mode
    # batch shape follows the text queries when given, else the vectors:
    # a flat number sequence is ONE query vector, a sequence of sequences
    # is a micro-batch of them
    if q is not None:
        batch = not isinstance(q, str)
    else:
        batch = (vector is not None and len(vector) > 0
                 and hasattr(vector[0], "__len__"))
    if q is not None:
        if batch:
            body["queries"] = list(q)     # micro-batch: one invocation
        else:
            body["q"] = q
    if vector is not None:
        if batch:
            body["qvs"] = [[float(x) for x in v] for v in vector]
        else:
            body["qv"] = [float(x) for x in vector]
    return body


@dataclasses.dataclass
class SearchApp:
    store: ObjectStore
    catalog: AssetCatalog
    doc_store: KVStore
    runtime: FaaSRuntime
    gateway: Gateway
    asset: str

    def query(self, q: "str | list[str]", k: int = 10, *,
              t_arrival: float | None = None, fetch_docs: bool = True):
        return self.gateway.request(
            "GET", "/search", _search_body(q, k, fetch_docs),
            t_arrival=t_arrival)


def index_corpus(docs: Iterable[tuple[str, str]], store: ObjectStore,
                 doc_store: KVStore, *, asset: str = "index",
                 version: str = "v1",
                 global_stats: dict | None = None,
                 vocab: dict[str, int] | None = None) -> AssetCatalog:
    """The offline batch side: build, pack, publish (paper §3).

    Pass ``global_stats`` (index.builder.compute_global_stats over the FULL
    corpus) — and the corpus-global ``vocab`` — when these docs are one
    partition of a larger deployment."""
    writer = IndexWriter(global_stats=global_stats, vocab=vocab)
    for ext_id, text in docs:
        writer.add(ext_id, text)
        doc_store.put(ext_id, {"id": ext_id, "contents": text})
    packed = writer.pack()
    catalog = AssetCatalog(store)
    catalog.publish(asset, version, write_segment(packed))
    return catalog


def build_search_app(
    docs: Iterable[tuple[str, str]],
    *,
    runtime_config: RuntimeConfig | None = None,
    search_config: SearchConfig | None = None,
    backend: Backend | None = None,
    asset: str = "index",
    device=None,
) -> SearchApp:
    """Corpus → published index → one search function behind ``GET /search``.
    ``device`` (None → the card) is where the function's searchers live."""
    device = resolve_device(device)      # no card: raise before packing
    store = ObjectStore(backend)
    doc_store = KVStore()
    catalog = index_corpus(docs, store, doc_store, asset=asset)
    handler = make_search_handler(catalog, doc_store, asset, search_config, device)
    runtime = FaaSRuntime(runtime_config)
    runtime.register("search", handler)
    gateway = Gateway(runtime)
    gateway.route("GET", "/search", "search")
    return SearchApp(store, catalog, doc_store, runtime, gateway, asset)


# -- the fleet's indexer: bootstrap publish (the NRT write path waits) -----------


@dataclasses.dataclass
class _PartitionState:
    """One partition's segment tier, as the writer tracks it."""

    asset: str
    seg_docs: list                # (ext_id, text) in indexed order (base+deltas)
    tombstones: set               # deleted INTERNAL positions (not yet merged)
    base_seg: str
    deltas: list                  # delta segment ids, oldest first
    base_docs: int
    delta_docs: int
    staged_docs: list = dataclasses.field(default_factory=list)
    # dense tier twins (None/[] on sparse-only fleets): row r of the vector
    # segments is doc r of the sparse segments — one internal-id space, one
    # tombstone list, one generation number governs both tiers
    vec_base: "str | None" = None
    vec_deltas: list = dataclasses.field(default_factory=list)

    def live_docs(self) -> list:
        return [d for pos, d in enumerate(self.seg_docs)
                if pos not in self.tombstones]


class FleetIndexer:
    """The partitioned fleet's indexer, as far as the read path needs it.

    ``add_partition`` packs each partition's base segment (and its vector
    twin on fleets with a dense tier) against the corpus-global stats and
    vocab, and publishes generation 1 through a generation manifest, exactly
    as the reference does. It also registers each partition's writer
    function ``indexer-p{i}`` with the runtime, so function names match the
    reference's. Staging, commits, forks and the writer's body — the NRT
    write path — raise ``NotImplementedError`` (ROADMAP Queue 1 item 5).
    """

    def __init__(self, catalog: AssetCatalog, doc_store: KVStore,
                 runtime: FaaSRuntime, *, stats: dict, vocab: dict,
                 merge_policy: MergePolicy | None = None,
                 sim_write_s: float | None = None,
                 sim_write_per_doc_s: float = 2e-5,
                 stats_asset: str = "index-stats",
                 embedder: "Callable | None" = None,
                 vec_dim: int = 16, vec_dtype: str = "float32") -> None:
        self.catalog = catalog
        self.doc_store = doc_store
        self.runtime = runtime
        self.stats = stats
        self.vocab = vocab
        self.merge_policy = merge_policy or MergePolicy()
        self.sim_write_s = sim_write_s
        self.sim_write_per_doc_s = sim_write_per_doc_s
        # dense tier (optional): each base segment's vector twin is packed
        # from the same doc list, so both tiers publish under one generation
        self.embedder = embedder
        self.vec_dim = vec_dim
        self.vec_dtype = vec_dtype
        self.stats_asset = stats_asset    # shared per-generation stats/vocab
        self._stats_ref: list | None = None
        self.gen = 0
        self.parts: list[_PartitionState] = []

    # -- bootstrap (the offline batch build, generation-shaped) ---------------

    def add_partition(self, asset: str, docs: list[tuple[str, str]]) -> None:
        """Pack ``docs`` as partition ``len(self.parts)``'s base segment and
        publish generation 1."""
        self.gen = 1
        if self._stats_ref is None:       # once per generation, not per part
            self._stats_ref = self.catalog.publish_generation_state(
                self.stats_asset, self.gen, self.stats, self.vocab)
        i = len(self.parts)
        writer = IndexWriter(global_stats=self.stats, vocab=self.vocab)
        writer.add_many(docs)
        base_seg = f"g{self.gen:06d}-base"
        self.catalog.publish_segment(asset, base_seg,
                                     write_segment(writer.pack()))
        st = _PartitionState(asset=asset, seg_docs=list(docs),
                             tombstones=set(), base_seg=base_seg,
                             deltas=[], base_docs=len(docs), delta_docs=0)
        if self.embedder is not None:
            st.vec_base = f"g{self.gen:06d}-vecbase"
            self.catalog.publish_segment(
                asset, st.vec_base, write_vector_segment(self._pack_vecs(docs)))
        self.parts.append(st)
        self.catalog.publish_generation(asset, self._manifest(st))
        self.runtime.register(self._writer_fn(i),
                              self._make_indexer_handler(i))
        for ext, text in docs:
            self.doc_store.put(ext, {"id": ext, "contents": text})

    def _manifest(self, st: _PartitionState) -> GenerationManifest:
        return GenerationManifest(
            gen=self.gen, base=st.base_seg, deltas=list(st.deltas),
            tombstones=sorted(st.tombstones), stats_ref=self._stats_ref,
            vec_base=st.vec_base, vec_deltas=list(st.vec_deltas))

    def _pack_vecs(self, docs: list):
        """Embed + pack one segment's docs as its dense twin (row r of the
        vector segment IS doc r of the sparse segment)."""
        if docs:
            vecs = np.stack([self.embedder(flatten_text(text))
                             for _, text in docs]).astype(np.float32)
        else:
            vecs = np.zeros((0, self.vec_dim), dtype=np.float32)
        return pack_vectors(vecs, [ext for ext, _ in docs],
                            dtype=self.vec_dtype)

    def _writer_fn(self, i: int) -> str:
        """Handler name for partition ``i``'s writer Lambda."""
        return f"indexer-p{i}"

    def _make_indexer_handler(self, i: int):
        """Handler for ``indexer-p{i}``: registered so the fleet's functions
        match the reference's; invoking it raises until the write path is
        ported."""
        def handler(cache, payload: dict) -> tuple[dict, float]:
            raise NotImplementedError(WRITE_PATH)

        return handler

    # -- the NRT write path: not ported ---------------------------------------

    def stage_add(self, docs: Iterable[tuple[str, str]]) -> int:
        raise NotImplementedError(WRITE_PATH)

    def stage_delete(self, ids: Iterable[str]) -> int:
        raise NotImplementedError(WRITE_PATH)

    def sync(self) -> bool:
        raise NotImplementedError(WRITE_PATH)

    def fork(self, writer_id: int) -> "FleetIndexer":
        raise NotImplementedError(WRITE_PATH)

    def commit(self, fn_groups, *, t_arrival: float | None = None,
               ping_payload: dict | None = None,
               max_publish_retries: int = 3) -> tuple[dict, float]:
        raise NotImplementedError(WRITE_PATH)

    # -- introspection (tests, the oracle) --------------------------------------

    def live_corpus(self) -> list[tuple[str, str]]:
        """The searchable corpus, in (partition, internal id) order — the
        exact order a from-scratch rebuild (or oracle) must index to share
        the fleet's tie-breaks."""
        out = []
        for st in self.parts:
            out.extend(st.live_docs())
        return out

    def part_doc_offsets(self) -> list[int]:
        """Global-id base per partition (internal spaces INCLUDE tombstoned
        docs until a merge purges them)."""
        offs, n = [], 0
        for st in self.parts:
            offs.append(n)
            n += len(st.seg_docs)
        return offs


# -- fleet-level partitioned app (paper §3's scale-out, assembled) -----------------


@dataclasses.dataclass
class PartitionedSearchApp:
    """N document partitions behind one gateway route.

    Global doc id = the partition's doc-offset + partition-local internal
    id, the offsets being the indexer's ``part_doc_offsets()``; clients
    should key on ``ext_ids``, which are stable.
    """

    store: ObjectStore
    catalog: AssetCatalog
    doc_store: KVStore
    runtime: FaaSRuntime
    gateway: Gateway
    scatter: ScatterGather
    assets: list[str]
    fn_names: list[str]      # primaries, one per partition
    n_parts: int
    n_docs_local: int
    search_k: int = 10       # per-partition top-k (SearchConfig.k)
    fn_groups: list[list[str]] = dataclasses.field(default_factory=list)
    replicas: int = 1
    indexer: FleetIndexer | None = None
    # text → (dim,) f32 query embedder; non-None iff the fleet serves a
    # dense-vector tier (FleetSpec.index.vector)
    embedder: "Callable | None" = None

    def query(self, q: "str | list[str] | None" = None, k: int = 10, *,
              t_arrival: float | None = None, fetch_docs: bool = True,
              mode: str = "sparse", vector=None):
        """One query (str) or a micro-batch (list of str) through the
        gateway; batches evaluate as ONE invocation per partition.

        ``mode`` selects the tier(s): ``"sparse"`` (BM25), ``"dense"``
        (embedding inner product), or ``"hybrid"`` (both, fused with
        Reciprocal Rank Fusion). ``vector`` optionally supplies the query
        embedding(s) — one (dim,) sequence per query — otherwise the
        fleet's embedder derives them from the text; dense-mode callers
        may pass ``q=None`` with ``vector`` alone.

        ``k`` is capped at the per-partition ``SearchConfig.k``: each
        partition returns its top ``search_k`` candidates, so merged ranks
        beyond that are not sound and are never returned."""
        return self.gateway.request(
            "GET", "/search", _search_body(q, k, fetch_docs, mode, vector),
            t_arrival=t_arrival)

    def submit(self, q: "str | list[str] | None" = None, k: int = 10, *,
               t_arrival: float | None = None, fetch_docs: bool = True,
               mode: str = "sparse", vector=None) -> PendingResponse:
        """Admit a query to the gateway's adaptive micro-batch window:
        concurrent arrivals inside one window coalesce into ONE scatter —
        one batched invocation per partition per window — and under sparse
        traffic the window is zero, so the returned handle resolves
        immediately with exactly the latency :meth:`query` would have
        charged. The serving generation is pinned per query AT ADMISSION.
        A window groups dispatches by (generation, mode)."""
        return self.gateway.submit(
            "GET", "/search", _search_body(q, k, fetch_docs, mode, vector),
            t_arrival=t_arrival)

    def flush(self, now: float | None = None) -> int:
        """Close the search route's due admission window(s) — the window
        timer's analogue for virtual-clock callers; call once at end of
        run (``now=None`` closes unconditionally)."""
        return self.gateway.flush(now)

    def warm(self, *, t_arrival: float | None = None) -> list[InvocationRecord]:
        """Touch EVERY function — primaries and replicas — once, hydrating
        each pool. Pings bill to the ledger's idle line and stay out of
        latency percentiles."""
        t0 = self.runtime.clock if t_arrival is None else t_arrival
        payload = {"q": "", "k": 1, "fetch_docs": False}
        if self.embedder is not None:
            # warm BOTH tiers on hybrid fleets: a dense leg landing on a
            # pool that only ever saw sparse pings would hydrate cold
            payload["mode"] = "hybrid"
            payload["qv"] = [float(x) for x in self.embedder("")]
        recs = []
        for group in self.fn_groups:
            for fn in group:
                _, rec = self.runtime.invoke(fn, dict(payload), t_arrival=t0,
                                             keepalive=True)
                recs.append(rec)
        return recs

    # -- the /index coordinator (NRT writes): not ported ---------------------------

    def add_documents(self, docs: Iterable[tuple[str, str]], *,
                      t_arrival: float | None = None):
        raise NotImplementedError(WRITE_PATH)

    def delete_documents(self, ids: Iterable[str], *,
                         t_arrival: float | None = None):
        raise NotImplementedError(WRITE_PATH)

    def commit(self, *, t_arrival: float | None = None):
        raise NotImplementedError(WRITE_PATH)

    def _index_route(self, body: dict, t_arrival: float | None):
        raise NotImplementedError(WRITE_PATH)

    # -- the /search coordinator (Gateway → ScatterGather → merge) ---------------

    def _global_id(self, hit: PartitionHit, offsets: list[int] | None) -> int:
        if offsets is not None:
            return offsets[hit.partition] + hit.doc_id
        return hit.partition * self.n_docs_local + hit.doc_id

    def _fetch_raw(self, merged: list[list[PartitionHit]],
                   fetch_docs: bool) -> tuple[dict, float]:
        """ONE batched KV fetch for the union of all merged hits."""
        ext = dict.fromkeys(
            h.ext_id for hits in merged for h in hits if h.ext_id is not None)
        if not fetch_docs:
            return {}, 0.0
        return self.doc_store.batch_get_billed(ext)

    def _materialize(self, hits: list[PartitionHit], raw: dict) -> dict:
        offsets = (self.indexer.part_doc_offsets()
                   if self.indexer is not None else None)
        ext_ids = [h.ext_id for h in hits]
        return {
            "ids": [self._global_id(h, offsets) for h in hits],
            "scores": [h.score for h in hits],
            "ext_ids": ext_ids,
            "docs": [raw.get(e) for e in ext_ids] if raw else [],
        }

    def _query_plan(self, body: dict) -> tuple[str, bool, "list | None",
                                               "list | None"]:
        """Validate a /search body and resolve its tiers' inputs:
        (mode, batched, texts, vectors). Texts is None for a vector-only
        dense query; vectors is None for sparse. Embeds text queries at the
        COORDINATOR when the client sent no vectors — every scatter leg (and
        the oracle) then scores identical floats. Raises :class:`BadRequest`
        for anything the fleet cannot serve, with the reference's messages;
        a structured ``sq``/``sqs`` body is one of them, since no fleet of
        the port carries the structured tier."""
        mode = body.get("mode", "sparse")
        if mode not in SEARCH_MODES:
            raise BadRequest(f"mode must be one of {SEARCH_MODES}, "
                             f"got {mode!r}")
        if "sq" in body or "sqs" in body:
            if mode != "sparse":
                raise BadRequest("structured queries are sparse-tier only "
                                 f"(got mode={mode!r})")
            raise BadRequest(
                "this fleet serves no structured tier (build it with "
                "FleetSpec(index=IndexSpec(structured=True, ...)))")
        batched = "queries" in body or "qvs" in body
        if "queries" in body:
            texts = list(body["queries"])
        elif "q" in body:
            texts = [body["q"]]
        else:
            texts = None
        if mode == "sparse":
            if texts is None:
                raise BadRequest("sparse search needs q/queries text")
            if batched and not texts:
                # reject BEFORE anything dispatches: an empty micro-batch
                # has nothing to scatter
                raise BadRequest("queries=[] — an empty micro-batch has "
                                 "nothing to dispatch")
            return mode, batched, texts, None
        if self.embedder is None:
            raise BadRequest("this fleet serves no dense-vector tier "
                             "(build it with FleetSpec(index=IndexSpec("
                             "vector=VectorSpec(...))))")
        if mode == "hybrid" and texts is None:
            raise BadRequest("hybrid search needs q/queries text for its "
                             "sparse tier")
        if "qvs" in body:
            vecs = [list(v) for v in body["qvs"]]
        elif "qv" in body:
            vecs = [list(body["qv"])]
        else:
            vecs = None
        if vecs is None:
            if texts is None:
                raise BadRequest(f"{mode} search needs text or qv/qvs "
                                 "query vectors")
            vecs = [[float(x) for x in self.embedder(q)] for q in texts]
        if texts is not None and len(vecs) != len(texts):
            raise BadRequest(f"{len(vecs)} query vectors for "
                             f"{len(texts)} text queries")
        if batched and not vecs:
            raise BadRequest("qvs=[] — an empty micro-batch has nothing "
                             "to dispatch")
        return mode, batched, texts, vecs

    def _merged_hitlists(self, results: list, n_q: int, batched: bool,
                         mode: str, k: int) -> list[list[PartitionHit]]:
        """Coordinator-side gather: per-query global top-k hit lists from
        the scatter's raw per-partition results.

        Sparse/dense merge by (-score, partition, doc id). Hybrid fuses with
        Reciprocal Rank Fusion: each tier merges to the full per-partition
        depth (``search_k`` — the deepest sound ranking), then ``rrf_fuse``
        combines the two rankings by rank alone, in fixed (sparse, dense)
        tier order — the same call the oracle fusion makes, so fused scores
        are bit-identical to it."""
        def tier(qi: int, sub: str | None) -> list[dict]:
            per_part = []
            for r in results:
                rr = r["results"][qi] if batched else r
                per_part.append(rr[sub] if sub else rr)
            return per_part

        if mode != "hybrid":
            return [_merge_hits(tier(qi, None), k) for qi in range(n_q)]
        out = []
        for qi in range(n_q):
            sparse = _merge_hits(tier(qi, None), self.search_k)
            dense = _merge_hits(tier(qi, "dense"), self.search_k)
            bykey = {(h.partition, h.doc_id): h for h in dense}
            bykey.update({(h.partition, h.doc_id): h for h in sparse})
            fused = rrf_fuse([[(h.partition, h.doc_id) for h in sparse],
                              [(h.partition, h.doc_id) for h in dense]], k)
            out.append([PartitionHit(key[1], score, key[0],
                                     bykey[key].ext_id)
                        for key, score in fused])
        return out

    @staticmethod
    def _partitions(records) -> list[dict]:
        return [{"fn": r.fn, "cold": r.cold, "hydrate_s": r.hydrate_s,
                 "backfill_s": r.backfill_s, "latency_s": r.latency_s,
                 "hedged": r.hedged} for r in records]

    def _search_route(self, body: dict, t_arrival: float | None
                      ) -> tuple[dict, float, InvocationRecord | None]:
        # a partition only surfaces its top search_k candidates — a merged
        # rank past that could silently miss docs, so clamp rather than lie
        k = min(int(body.get("k", self.search_k)), self.search_k)
        fetch_docs = body.get("fetch_docs", True)
        mode, batched, texts, vecs = self._query_plan(body)
        n_q = len(texts) if texts is not None else len(vecs)
        # hybrid legs return their full search_k per tier — RRF ranks are
        # only sound at the deepest per-tier depth; the fused list then
        # truncates to the caller's k
        payload = {"k": self.search_k if mode == "hybrid" else k,
                   "fetch_docs": False}
        if mode != "sparse":
            payload["mode"] = mode
        if self.indexer is not None:
            # pin ONE generation for every leg of this query — primaries
            # and hedged backups — so no merge can tear across generations
            payload["gen"] = self.indexer.gen
        if batched:
            if texts is not None:
                payload["queries"] = texts
            if vecs is not None:
                payload["qvs"] = vecs
        else:
            if texts is not None:
                payload["q"] = texts[0]
            if vecs is not None:
                payload["qv"] = vecs[0]
        results, lat, records = self.scatter.scatter(
            payload, t_arrival=t_arrival)
        merged = self._merged_hitlists(results, n_q, batched, mode, k)
        raw, fetch_s = self._fetch_raw(merged, fetch_docs)
        if batched:
            result: dict = {"results": [self._materialize(merged[qi], raw)
                                        for qi in range(n_q)]}
        else:
            result = self._materialize(merged[0], raw)
        result["partitions"] = self._partitions(records)
        if "gen" in payload:
            result["generation"] = payload["gen"]
        slowest = max(records, key=lambda r: r.latency_s, default=None) \
            if records else None
        return result, lat + fetch_s, slowest

    # -- the windowed /search coordinator (adaptive micro-batch dispatch) ---------

    def _admit_search(self, body: dict, t_arrival: float) -> dict:
        """Admission hook for the batched ``/search`` route: validate the
        body before it can occupy the window, resolve its query vectors
        (embedding the text when the client sent none, so a flush never has
        to reject) and pin the serving generation AT ADMISSION."""
        mode, _, texts, vecs = self._query_plan(body)
        body = dict(body)
        body["_texts"], body["_vecs"], body["_mode"] = texts, vecs, mode
        if self.indexer is not None:
            body["_gen"] = self.indexer.gen
        return body

    def _search_route_batch(self, bodies: list, t_arrivals: list,
                            t_dispatch: float) -> list:
        """Dispatch ONE admission window: every query of every admitted
        body rides a single scatter per (pinned generation, mode) — one
        batched invocation per partition — and the merged per-query top-k
        is bit-identical to serial dispatch (per-query candidate sets never
        interact; a window's k is the per-partition ``search_k`` ceiling
        and each body's smaller ``k`` is a prefix of that merge)."""
        # (batched, texts, vecs, mode, n_q, k, fetch_docs, gen) per body
        per_body = []
        for body in bodies:
            texts, vecs = body["_texts"], body["_vecs"]
            per_body.append((
                "queries" in body or "qvs" in body,
                texts, vecs, body["_mode"],
                len(texts) if texts is not None else len(vecs),
                min(int(body.get("k", self.search_k)), self.search_k),
                body.get("fetch_docs", True),
                body.get("_gen")))
        # one scatter per (pinned generation, mode), in admission order
        group_order: list = []
        group_members: dict = {}
        for bi, pb in enumerate(per_body):
            gkey = (pb[7], pb[3])
            if gkey not in group_members:
                group_order.append(gkey)
                group_members[gkey] = []
            group_members[gkey].append(bi)
        merged_by_body: dict[int, list] = {}
        lat_by_body: dict[int, float] = {}
        recs_by_body: dict[int, list] = {}
        for gkey in group_order:
            gen, mode = gkey
            idxs = group_members[gkey]
            payload: dict = {"k": self.search_k, "fetch_docs": False}
            if mode != "sparse":
                payload["mode"] = mode
                payload["qvs"] = [v for bi in idxs for v in per_body[bi][2]]
            if mode != "dense":
                payload["queries"] = [q for bi in idxs for q in per_body[bi][1]]
            elif any(per_body[bi][1] is not None for bi in idxs):
                # text-less dense bodies leave queries out entirely;
                # mixed groups substitute "" so counts stay aligned
                payload["queries"] = [q for bi in idxs for q in
                                      (per_body[bi][1] or
                                       [""] * per_body[bi][4])]
            if gen is not None:
                payload["gen"] = gen
            results, lat, records = self.scatter.scatter(
                payload, t_arrival=t_dispatch)
            n_flat = sum(per_body[bi][4] for bi in idxs)
            merged = self._merged_hitlists(results, n_flat, True, mode,
                                           self.search_k)
            at = 0
            for bi in idxs:
                n = per_body[bi][4]
                merged_by_body[bi] = merged[at: at + n]
                at += n
                lat_by_body[bi] = lat
                recs_by_body[bi] = records
        # ONE batched KV fetch for the union of every doc-requesting
        # body's hits — the same amortization the handler-side batch does
        need = [hits for bi, pb in enumerate(per_body)
                if pb[6] for hits in merged_by_body[bi]]
        raw, fetch_s = self._fetch_raw(need, True) if need else ({}, 0.0)
        out = []
        for bi, (batched, _, _, _, n_q, k, fetch_docs, gen) in enumerate(per_body):
            braw = raw if fetch_docs else {}
            hit_lists = [hits[:k] for hits in merged_by_body[bi]]
            if batched:
                result: dict = {"results": [self._materialize(h, braw)
                                            for h in hit_lists]}
            else:
                result = self._materialize(hit_lists[0], braw)
            result["partitions"] = self._partitions(recs_by_body[bi])
            if gen is not None:
                result["generation"] = gen
            out.append((result,
                        lat_by_body[bi] + (fetch_s if fetch_docs else 0.0)))
        return out


def build_partitioned_search_app(
    docs: Iterable[tuple[str, str]],
    spec: "FleetSpec | int | None" = None,
    *,
    n_parts: int | None = None,
    replicas: int | None = None,
    hedge: "HedgePolicy | float | None" = None,
    autoscale=None,
    routing: str | None = None,
    window: WindowPolicy | None = None,
    partition_weights: "list[float] | None" = None,
    merge_policy: MergePolicy | None = None,
    runtime_config: RuntimeConfig | None = None,
    search_config: SearchConfig | None = None,
    backend: Backend | None = None,
    asset_prefix: str | None = None,
    device=None,
) -> PartitionedSearchApp:
    """Assemble the partitioned fleet: one segment per partition, ``replicas``
    Lambda functions serving it, global BM25 stats, scatter-gather behind
    ``/search``::

        app = build_partitioned_search_app(docs, FleetSpec(
            n_parts=4,
            replication=ReplicationSpec(replicas=2, hedge=0.05),
            index=IndexSpec(vector=VectorSpec(dim=16)),   # dense tier
        ))

    DEPRECATED, as in the reference: the pre-FleetSpec keyword sprawl
    (``n_parts=..., replicas=..., hedge=..., ...``) still assembles
    identically through a shim — each legacy kwarg maps onto the
    corresponding spec field, and a bare int second positional is
    ``n_parts`` — but mixing both surfaces in one call is an error.

    Every partition's segment is packed with ``compute_global_stats`` over
    the FULL corpus, so the merged ranking is identical to a single-index
    build at any partition count. Lazy hydration is the fleet default
    (``SearchConfig.lazy_hydration=None`` resolves to True here).
    ``device`` (None → the card) is where every partition's searchers live.
    The write path (``POST /index``), ``autoscale`` and the structured tier
    raise ``NotImplementedError``.
    """
    device = resolve_device(device)      # no card: raise before packing
    # keyword sprawl = the flattened fleet shape that FleetSpec replaced.
    # runtime_config / search_config / backend are verbatim FleetSpec
    # fields, fine to pass alongside the bare-int n_parts shorthand.
    sprawl = {k: v for k, v in dict(
        n_parts=n_parts, replicas=replicas, hedge=hedge, autoscale=autoscale,
        routing=routing, window=window, partition_weights=partition_weights,
        merge_policy=merge_policy, asset_prefix=asset_prefix).items()
        if v is not None}
    legacy = dict(sprawl)
    for k, v in dict(runtime_config=runtime_config,
                     search_config=search_config, backend=backend).items():
        if v is not None:
            legacy[k] = v
    if isinstance(spec, FleetSpec):
        if legacy:
            raise TypeError(
                "pass configuration on the FleetSpec, not as legacy "
                f"kwargs: {sorted(legacy)}")
    else:
        if spec is not None:       # positional n_parts shorthand, not sprawl
            legacy.setdefault("n_parts", int(spec))
        if sprawl:
            warnings.warn(
                "build_partitioned_search_app's keyword sprawl is "
                "deprecated; pass a FleetSpec instead",
                DeprecationWarning, stacklevel=2)
        spec = FleetSpec(
            n_parts=legacy.get("n_parts", 4),
            replication=ReplicationSpec(
                replicas=legacy.get("replicas", 1),
                hedge=legacy.get("hedge"),
                autoscale=legacy.get("autoscale")),
            gateway=GatewaySpec(window=legacy.get("window"),
                                routing=legacy.get("routing")),
            index=IndexSpec(
                partition_weights=legacy.get("partition_weights"),
                merge_policy=legacy.get("merge_policy"),
                asset_prefix=legacy.get("asset_prefix", "index")),
            runtime_config=legacy.get("runtime_config"),
            search_config=legacy.get("search_config"),
            backend=legacy.get("backend"))

    rep, gw, ix = spec.replication, spec.gateway, spec.index
    embedder = None
    if ix.vector is not None:
        embedder = ix.vector.embedder or hash_embedder(ix.vector.dim)
    scfg = spec.search_config or SearchConfig()
    if scfg.lazy_hydration is None:
        # the fleet default: cold legs answer from range reads of the
        # superindex + the queried terms' blocks, backfilling off the
        # critical path. Pass lazy_hydration=False to pin the eager profile.
        scfg = dataclasses.replace(scfg, lazy_hydration=True)

    docs = list(docs)
    store = ObjectStore(spec.backend)
    doc_store = KVStore()
    catalog = AssetCatalog(store)
    runtime = FaaSRuntime(spec.runtime_config)
    gstats = compute_global_stats(docs, fields=False)
    # every partition packs against the corpus-global vocab: queries then
    # encode (and idf-truncate, for > max_terms) identically per partition
    gvocab = global_vocab(gstats)
    parts, per = partition_corpus(docs, spec.n_parts,
                                  weights=ix.partition_weights)
    indexer = FleetIndexer(
        catalog, doc_store, runtime, stats=gstats, vocab=gvocab,
        merge_policy=ix.merge_policy, sim_write_s=scfg.sim_write_s,
        sim_write_per_doc_s=scfg.sim_write_per_doc_s,
        stats_asset=f"{ix.asset_prefix}-stats",
        embedder=embedder,
        vec_dim=ix.vector.dim if ix.vector else 16,
        vec_dtype=ix.vector.dtype if ix.vector else "float32")
    assets, fn_groups = [], []
    for p, pdocs in enumerate(parts):
        if not pdocs:        # corpus didn't fill the last partition(s)
            continue
        asset = f"{ix.asset_prefix}-p{p}"
        indexer.add_partition(asset, pdocs)
        group = []
        for r in range(rep.replicas):
            fn = f"search-p{p}" if r == 0 else f"search-p{p}r{r}"
            runtime.register(fn, make_search_handler(
                catalog, doc_store, asset, scfg, device))
            group.append(fn)
        assets.append(asset)
        fn_groups.append(group)
    scatter = ScatterGather(runtime, fn_groups, hedge=rep.hedge,
                            routing=gw.routing or "static",
                            degraded_ok=rep.degraded_ok)
    gateway = Gateway(runtime)
    app = PartitionedSearchApp(
        store=store, catalog=catalog, doc_store=doc_store, runtime=runtime,
        gateway=gateway, scatter=scatter, assets=assets,
        fn_names=scatter.fn_names, n_parts=spec.n_parts, n_docs_local=per,
        search_k=scfg.k, fn_groups=scatter.groups, replicas=rep.replicas,
        indexer=indexer, embedder=embedder)
    gateway.route("GET", "/search", app._search_route)
    gateway.route_batched("GET", "/search", app._search_route_batch,
                          policy=gw.window, admit=app._admit_search)
    gateway.route("POST", "/index", app._index_route)
    return app
