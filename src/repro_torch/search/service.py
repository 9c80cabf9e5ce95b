"""End-to-end Anlessini application assembly (Figure 1 of the paper) — the
port of ``repro/search/service.py``.

``build_search_app`` wires corpus → index → object store → FaaS runtime →
gateway and returns the pieces.

``build_partitioned_search_app`` is the §3 scale-out assembly: the corpus
splits into N partitions, each published as generation 1 of its own asset
(packed with GLOBAL idf/avgdl) and served by its own Lambda function;
``/search`` fans out through ScatterGather and merges per-partition top-k
into a globally-ranked result — sparse (BM25), dense (K4 inner products),
hybrid (both, fused with Reciprocal Rank Fusion) or structured (fielded
BM25, phrases and facets, evaluated on each partition's device). Cold
starts, hydration, refresh, and cost all account per partition in the
shared runtime. With ``replicas=R`` each segment is served by R independent
instance pools and a ``HedgePolicy`` fires backup legs on replicas when a
primary projects cold/queued; an ``AutoscalePolicy`` grows and shrinks
those groups at runtime. ``POST /index`` is the near-real-time write path:
delta segments, generation commits and zero-downtime rollovers.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Iterable

import numpy as np

from repro_torch.core.autoscale import AutoscalePolicy, FleetController
from repro_torch.core.gateway import (BadRequest, Gateway, PendingResponse,
                                      WindowPolicy)
from repro_torch.core.kvstore import KVStore
from repro_torch.core.object_store import Backend, ObjectStore
from repro_torch.core.partition import (FleetSpec, GatewaySpec, HedgePolicy,
                                        IndexSpec, PartitionHit, ReplicationSpec,
                                        ScatterGather, _merge_hits, rrf_fuse)
from repro_torch.core.refresh import (AssetCatalog, GenerationManifest,
                                      PublishConflict, parse_generation,
                                      rollover_fleet)
from repro_torch.core.runtime import FaaSRuntime, InvocationRecord, RuntimeConfig
from repro_torch.data.corpus import hash_embedder
from repro_torch.index.builder import (IndexWriter, MergePolicy,
                                       compute_global_stats, extend_vocab,
                                       field_avgdl, global_vocab, pack_vectors,
                                       read_segment, update_stats, write_segment,
                                       write_vector_segment)
from repro_torch.index.tokenizer import flatten_text, token_counts
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.distributed import partition_corpus
from repro_torch.search.query import Query, QueryParseError, parse_query
from repro_torch.search.searcher import (PREWARM_TOP_TERMS, SearchConfig,
                                         make_search_handler)
from repro_torch.search.structured import make_snippet, merge_facet_counts

SEARCH_MODES = ("sparse", "dense", "hybrid")


def _search_body(q: "str | list[str] | None", k: int, fetch_docs: bool,
                 mode: str = "sparse", vector=None, sq=None,
                 facets=None, snippets: bool = False) -> dict:
    """The ``/search`` body: ``q`` for one query, ``queries`` for a
    micro-batch (one invocation); ``qv``/``qvs`` carry query vectors,
    ``sq``/``sqs`` structured DSL strings."""
    body = {"k": k, "fetch_docs": fetch_docs}
    if mode != "sparse":
        body["mode"] = mode
    if sq is not None:
        # structured DSL: one query string, or a micro-batch of them
        if isinstance(sq, str):
            body["sq"] = sq
        else:
            body["sqs"] = list(sq)
    if facets:
        body["facets"] = list(facets)
    if snippets:
        body["snippets"] = True
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


# -- NRT ingestion: the fleet's writer path ---------------------------------------


ENQUEUE_COST_S = 0.0005    # staging one add/delete batch at the coordinator


def _copy_stats(stats: dict) -> dict:
    """Deep-enough copy of compute_global_stats-shaped stats: ``df`` and
    (on structured fleets) every ``fields`` entry are fresh containers.
    ``update_stats`` mutates the per-field dicts IN PLACE, so a shallow
    ``dict(stats, df=...)`` checkpoint would let a failed commit's
    mutations leak into what gets restored."""
    out = dict(stats, df=dict(stats["df"]))
    if "fields" in stats:
        out["fields"] = {f: dict(e) for f, e in stats["fields"].items()}
    return out


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
    """Near-real-time document ingestion for a partitioned fleet.

    The paper serves a STATIC index — Lin names updates as the key open
    limitation. This closes it with Lucene's own shape, adapted to object
    storage: adds/deletes stage at the coordinator; ``commit`` packs each
    touched partition's staged docs into a small immutable DELTA segment
    (a billed ``indexer-p{i}`` Lambda invocation — the writer's side of
    the cost ledger), CAS-publishes a new generation manifest per
    partition (base + ordered deltas + tombstones + LIVE global stats),
    prewarms every serving pool on the new generation, and only then
    flips the serving generation — a zero-downtime rollover.

    Invariants the tests pin:

    * global stats/vocab are maintained INCREMENTALLY (``update_stats`` /
      ``extend_vocab``) and stay exactly equal to ``compute_global_stats``
      over the live corpus — so a delta-served index ranks identically to
      a from-scratch rebuild, always;
    * every partition gets a manifest at every generation (a delete in
      partition 0 moves idf for ALL partitions — stats refresh is global);
    * deletes are tombstones until the :class:`MergePolicy` folds the
      delta tier back into the base (one full re-pack, purging them).
    """

    def __init__(self, catalog: AssetCatalog, doc_store: KVStore,
                 runtime: FaaSRuntime, *, stats: dict, vocab: dict,
                 merge_policy: MergePolicy | None = None,
                 sim_write_s: float | None = None,
                 sim_write_per_doc_s: float = 2e-5,
                 stats_asset: str = "index-stats",
                 embedder: "Callable | None" = None,
                 vec_dim: int = 16, vec_dtype: str = "float32",
                 structured: bool = False,
                 facet_fields: "tuple[str, ...]" = ()) -> None:
        self.catalog = catalog
        self.doc_store = doc_store
        self.runtime = runtime
        self.stats = stats
        self.vocab = vocab
        self.merge_policy = merge_policy or MergePolicy()
        self.sim_write_s = sim_write_s
        self.sim_write_per_doc_s = sim_write_per_doc_s
        # dense tier (optional): the SAME writer invocation that packs a
        # sparse delta/base also embeds + packs its vector twin, so both
        # tiers always publish under one generation and one CAS flip
        self.embedder = embedder
        self.vec_dim = vec_dim
        self.vec_dtype = vec_dtype
        # structured (format-v2) tier: every segment this writer packs —
        # base, delta, merge — carries field/position/facet data, so a
        # rollover can never demote the fleet's structured surface
        self.structured = structured or bool(facet_fields)
        self.facet_fields = tuple(facet_fields)
        self.stats_asset = stats_asset    # shared per-generation stats/vocab
        self._stats_ref: list | None = None
        self.gen = 0
        self.parts: list[_PartitionState] = []
        self.pending_adds: list[tuple[str, str]] = []
        self.pending_deletes: set[str] = set()
        self._pending_ids: set[str] = set()   # O(1) dedup over pending_adds
        # ext id -> (partition, internal position, text) for LIVE docs
        self._ext_index: dict[str, tuple[int, int, str]] = {}
        self._rr = 0                      # round-robin add assignment
        # segment-id sequence: every writer execution publishes under a
        # FRESH id, so a hedged re-execution (FaaSRuntime.hedge_after_s
        # runs handlers twice) or a post-failure retry can never collide
        # with an already-published segment — orphans (the hedge loser,
        # a failed attempt's uploads) are unreferenced and reclaimed by
        # the reference-based gc. NEVER rolled back by _restore: a retry
        # must keep advancing past the failed attempt's ids.
        self._seg_seq = 0
        self.commits: list[dict] = []     # commit log (gen, merged, counts)
        # multi-writer identity: 0 is the primary; ``fork`` mints clones
        # with nonzero ids (distinct handler names + segment-id tags so two
        # writers racing one generation never collide before the CAS).
        self.writer_id = 0
        self._forked = False    # once True, commits publish writer.json

    # -- bootstrap (the offline batch build, now generation-shaped) ------------

    def add_partition(self, asset: str, docs: list[tuple[str, str]]) -> None:
        """Pack ``docs`` as partition ``len(self.parts)``'s base segment and
        publish generation 1. All partitions must be added before the first
        commit (they share one global generation number)."""
        self.gen = 1
        if self._stats_ref is None:       # once per generation, not per part
            self._stats_ref = self.catalog.publish_generation_state(
                self.stats_asset, self.gen, self.stats, self.vocab)
        i = len(self.parts)
        writer = IndexWriter(global_stats=self.stats, vocab=self.vocab,
                             structured=self.structured,
                             facet_fields=self.facet_fields)
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
        for pos, (ext, text) in enumerate(docs):
            self.doc_store.put(ext, {"id": ext, "contents": text})
            self._ext_index[ext] = (i, pos, text)

    def _manifest(self, st: _PartitionState) -> GenerationManifest:
        return GenerationManifest(
            gen=self.gen, base=st.base_seg, deltas=list(st.deltas),
            tombstones=sorted(st.tombstones), stats_ref=self._stats_ref,
            vec_base=st.vec_base, vec_deltas=list(st.vec_deltas))

    def _pack_vecs(self, docs: list):
        """Embed + pack one segment's docs as its dense twin (row r of the
        vector segment IS doc r of the sparse segment)."""
        if docs:
            # structured corpora carry Mapping texts; the embedder sees the
            # same flattened view the analyzer tokenizes
            vecs = np.stack([self.embedder(flatten_text(text))
                             for _, text in docs]).astype(np.float32)
        else:   # a merge can empty a partition; the tier stays well-formed
            vecs = np.zeros((0, self.vec_dim), dtype=np.float32)
        return pack_vectors(vecs, [ext for ext, _ in docs],
                            dtype=self.vec_dtype)

    # -- staging ---------------------------------------------------------------

    def stage_add(self, docs: Iterable[tuple[str, str]]) -> int:
        """Stage docs for the next commit. The whole batch is validated
        BEFORE anything mutates — a duplicate id rejects the batch without
        half-staging it. An id whose delete is already staged may be
        re-added (delete + add + commit = the update recipe, one commit)."""
        docs = [(ext, text) for ext, text in docs]
        seen: set[str] = set()
        for ext, _ in docs:
            live = ext in self._ext_index and ext not in self.pending_deletes
            if live or ext in self._pending_ids or ext in seen:
                raise ValueError(f"document {ext!r} already indexed "
                                 "(updates = delete + add + commit)")
            seen.add(ext)
        for ext, text in docs:
            self.pending_adds.append((ext, text))
            self._pending_ids.add(ext)
        return len(self.pending_adds)

    def stage_delete(self, ids: Iterable[str]) -> int:
        for ext in ids:
            if ext in self._pending_ids:    # never-committed doc: just unstage
                self.pending_adds = [d for d in self.pending_adds
                                     if d[0] != ext]
                self._pending_ids.discard(ext)
            elif ext in self._ext_index:
                self.pending_deletes.add(ext)
        return len(self.pending_deletes)

    # -- the writer Lambda body -------------------------------------------------

    def _writer_fn(self, i: int) -> str:
        """Handler name for partition ``i``'s writer Lambda. Forked writers
        own distinct pools — two writers racing a commit must not share
        warm instances (their staged inputs differ)."""
        if self.writer_id:
            return f"indexer-w{self.writer_id}-p{i}"
        return f"indexer-p{i}"

    def _seg_tag(self) -> str:
        """Segment-id tag keeping forked writers' same-generation uploads
        disjoint: the create-once segment publish would otherwise conflict
        on BYTES before the manifest CAS even picks a winner. Empty for the
        primary, so single-writer segment ids are bit-identical to the
        pre-fork layout."""
        return f"w{self.writer_id}-" if self.writer_id else ""

    def _make_indexer_handler(self, i: int):
        """Handler for ``indexer-p{i}``: pack this partition's staged docs
        as a delta (or re-pack its live docs as a fresh base, for a merge)
        and publish the segment. Stateless w.r.t. the instance cache; the
        staged inputs live at the coordinator, exactly like the query
        coordinator owns the scatter."""
        st_ref = self.parts

        def handler(cache, payload: dict) -> tuple[dict, float]:
            st = st_ref[i]
            op, gen = payload["op"], payload["gen"]
            t0 = time.perf_counter()
            self._seg_seq += 1
            tag = self._seg_tag()
            if op == "delta":
                docs = list(st.staged_docs)
                packed = IndexWriter.delta(docs, self.stats, vocab=self.vocab,
                                           structured=self.structured,
                                           facet_fields=self.facet_fields)
                seg = f"g{gen:06d}-delta-{tag}{self._seg_seq:04d}"
            elif op == "merge":
                docs = st.live_docs() + list(st.staged_docs)
                writer = IndexWriter(global_stats=self.stats,
                                     vocab=self.vocab,
                                     structured=self.structured,
                                     facet_fields=self.facet_fields)
                writer.add_many(docs)
                packed = writer.pack()
                seg = f"g{gen:06d}-base-{tag}{self._seg_seq:04d}"
            else:
                raise ValueError(f"unknown indexer op {op!r}")
            self.catalog.publish_segment(st.asset, seg, write_segment(packed))
            vec_seg = None
            if self.embedder is not None:
                # the dense twin packs in the SAME invocation over the SAME
                # doc list: rows stay doc-for-doc aligned with the sparse
                # segment, and both tiers flip together at publish
                kind = "vecbase" if op == "merge" else "vecdelta"
                vec_seg = f"g{gen:06d}-{kind}-{tag}{self._seg_seq:04d}"
                self.catalog.publish_segment(
                    st.asset, vec_seg,
                    write_vector_segment(self._pack_vecs(docs)))
            if self.sim_write_s is not None:
                exec_s = self.sim_write_s + self.sim_write_per_doc_s * len(docs)
            else:
                exec_s = time.perf_counter() - t0
            return {"op": op, "seg": seg, "gen": gen, "vec_seg": vec_seg,
                    "n_docs": packed.meta.n_docs}, exec_s

        return handler

    # -- commit: delta pack → CAS publish → prewarmed rollover -------------------

    def _checkpoint(self) -> dict:
        """Everything ``commit`` mutates, cheap-copied. A failed commit
        (handler error, PublishConflict from a racing writer) restores this
        so the staged work is NOT lost and the writer can rebase + retry —
        without it, a partial multi-partition publish would wedge every
        future commit and silently drop the pending batch."""
        return {
            "stats": _copy_stats(self.stats),
            "vocab": self.vocab,        # rebound by extend_vocab, never mutated
            "ext_index": dict(self._ext_index),
            "pending_adds": list(self.pending_adds),
            "pending_ids": set(self._pending_ids),
            "pending_deletes": set(self.pending_deletes),
            "rr": self._rr,
            "gen": self.gen,
            "stats_ref": self._stats_ref,
            "parts": [(list(st.seg_docs), set(st.tombstones), st.base_seg,
                       list(st.deltas), st.base_docs, st.delta_docs,
                       st.vec_base, list(st.vec_deltas))
                      for st in self.parts],
        }

    def _restore(self, cp: dict) -> None:
        # every restored container is a COPY: ``commit``'s conflict-retry
        # loop restores the same checkpoint repeatedly, and handing out
        # the checkpoint's own objects would let attempt N's mutations
        # corrupt what attempt N+1 restores
        self.stats = _copy_stats(cp["stats"])
        self.vocab = cp["vocab"]        # rebound by extend_vocab, never mutated
        self._ext_index = dict(cp["ext_index"])
        self.pending_adds = list(cp["pending_adds"])
        self._pending_ids = set(cp["pending_ids"])
        self.pending_deletes = set(cp["pending_deletes"])
        self._rr, self.gen = cp["rr"], cp["gen"]
        self._stats_ref = cp["stats_ref"]
        for st, (sd, tb, bs, dl, bd, dd, vb, vd) in zip(self.parts,
                                                        cp["parts"]):
            st.seg_docs, st.tombstones, st.base_seg = list(sd), set(tb), bs
            st.deltas, st.base_docs, st.delta_docs = list(dl), bd, dd
            st.vec_base, st.vec_deltas = vb, list(vd)
            st.staged_docs = []

    def _published_gen(self) -> int:
        """Highest generation any partition's manifest currently serves.
        A previous commit that failed AFTER flipping some partitions leaves
        them ahead of ``self.gen``; basing the next generation on the max
        (instead of blindly ``self.gen + 1``) lets the retry publish a
        strictly newer generation everywhere instead of wedging on the
        stale-base check forever."""
        gens = (parse_generation(self.catalog.current_version(st.asset))
                for st in self.parts)
        return max((g for g in gens if g is not None), default=0)

    def _foreign_gen(self) -> int | None:
        """The generation a COMPLETE foreign commit published, if EVERY
        partition has moved past this writer's view (a racing writer won
        the whole flip). ``None`` while any partition still serves
        ``self.gen`` or older — that is this writer's OWN partial flip,
        which ``commit``'s max()+1 leapfrog retry handles instead (a
        rebase there would adopt a half-published generation)."""
        gens = [parse_generation(self.catalog.current_version(st.asset))
                for st in self.parts]
        if gens and all(g is not None and g > self.gen for g in gens):
            return min(gens)
        return None

    def _rebase(self) -> int:
        """Adopt the state a racing writer published past this writer's
        view, keeping the staged batch pending on top of it.

        Without this, a stale writer's commit would CAS-publish a
        generation built WITHOUT the winner's documents — the stale-base
        check only orders generation numbers, it cannot see content, so
        the winner's docs would vanish silently (the classic lost update).

        Rebuilds every partition's tier view from the published manifests
        (segment doc ids re-read from the store, texts from the doc KV —
        tombstoned rows keep an empty placeholder, nothing reads them),
        adopts the winner's live stats/vocab AND its round-robin cursor
        (``writer.json``), so the rebased commit places documents exactly
        where a serialized pair of commits would have. The staged batch is
        revalidated against the new view: deletes of ids the winner
        already removed drop out (delete-of-unknown is a no-op, same as
        ``stage_delete``); an add whose id the winner also added is a
        conflict the caller must resolve — loud error, batch preserved."""
        gen = self._foreign_gen()
        if gen is None:
            return self.gen
        manifests = [self.catalog.read_generation(st.asset)
                     for st in self.parts]
        stats, vocab = self.catalog.resolve_generation_state(manifests[0])
        self.stats = _copy_stats(stats)
        self.vocab = dict(vocab)
        self._ext_index = {}
        for i, (st, m) in enumerate(zip(self.parts, manifests)):
            tombs = set(m.tombstones)
            seg_docs: list[tuple[str, str]] = []
            base_docs = 0
            for seg_i, seg in enumerate(m.segments):
                pack = read_segment(self.catalog.open_segment(st.asset, seg))
                if seg_i == 0:
                    base_docs = len(pack.meta.doc_ids)
                for ext in pack.meta.doc_ids:
                    pos = len(seg_docs)
                    if pos in tombs:
                        # tombstoned rows are never scored, merged, or
                        # looked up — and their doc may be gone from the KV
                        seg_docs.append((ext, ""))
                    else:
                        text = self.doc_store.get(ext)["contents"]
                        seg_docs.append((ext, text))
                        self._ext_index[ext] = (i, pos, text)
            st.seg_docs = seg_docs
            st.tombstones = tombs
            st.base_seg = m.base
            st.deltas = list(m.deltas)
            st.base_docs = base_docs
            st.delta_docs = len(seg_docs) - base_docs
            st.vec_base = m.vec_base
            st.vec_deltas = list(m.vec_deltas)
            st.staged_docs = []
        writer = self.catalog.resolve_generation_writer(manifests[0])
        self._rr = int(writer.get("rr", self._rr))
        ref = manifests[0].stats_ref
        self._stats_ref = list(ref) if ref is not None else None
        self.gen = gen
        # revalidate the still-pending batch against the adopted view
        self.pending_deletes &= set(self._ext_index)
        for ext, _ in self.pending_adds:
            if ext in self._ext_index and ext not in self.pending_deletes:
                raise ValueError(
                    f"rebase conflict: document {ext!r} was also added by "
                    "the racing writer (updates = delete + add + commit)")
        return gen

    def sync(self) -> bool:
        """Adopt a racing writer's published state outside of a commit.
        Returns True if the view moved. Same rollback discipline as
        ``commit``: a rebase conflict restores the pre-sync view."""
        if self._foreign_gen() is None:
            return False
        cp = self._checkpoint()
        try:
            self._rebase()
        except Exception:
            self._restore(cp)
            raise
        return True

    def fork(self, writer_id: int) -> "FleetIndexer":
        """A SECOND writer over the same catalog, doc store, and runtime —
        the multi-writer story. The clone shares the published index (it
        starts from this writer's current view) but stages and commits
        independently; whichever writer publishes a generation first wins
        the CAS, and the other rebases on it inside its own ``commit``.

        Distinct handler names (``indexer-w{id}-p{i}``) and segment-id
        tags keep the two writers' same-generation uploads from colliding
        before the manifest CAS picks a winner; a loser's uploads become
        unreferenced orphans the reference-based gc reclaims after it
        rebases and republishes."""
        if writer_id == self.writer_id:
            raise ValueError("forked writer needs a distinct writer_id")
        w = FleetIndexer(
            self.catalog, self.doc_store, self.runtime,
            stats=_copy_stats(self.stats),
            vocab=self.vocab, merge_policy=self.merge_policy,
            sim_write_s=self.sim_write_s,
            sim_write_per_doc_s=self.sim_write_per_doc_s,
            stats_asset=self.stats_asset, embedder=self.embedder,
            vec_dim=self.vec_dim, vec_dtype=self.vec_dtype,
            structured=self.structured, facet_fields=self.facet_fields)
        w.writer_id = writer_id
        w.gen = self.gen
        w._stats_ref = list(self._stats_ref) if self._stats_ref else None
        w._ext_index = dict(self._ext_index)
        w._rr = self._rr
        w._seg_seq = self._seg_seq
        w.parts = [_PartitionState(
            asset=st.asset, seg_docs=list(st.seg_docs),
            tombstones=set(st.tombstones), base_seg=st.base_seg,
            deltas=list(st.deltas), base_docs=st.base_docs,
            delta_docs=st.delta_docs, vec_base=st.vec_base,
            vec_deltas=list(st.vec_deltas)) for st in self.parts]
        # both writers now publish their round-robin cursor with each
        # generation, so whichever loses a race can adopt the winner's
        self._forked = w._forked = True
        for i in range(len(w.parts)):
            self.runtime.register(w._writer_fn(i),
                                  w._make_indexer_handler(i))
        return w

    def commit(self, fn_groups, *, t_arrival: float | None = None,
               ping_payload: dict | None = None,
               max_publish_retries: int = 3) -> tuple[dict, float]:
        """Make staged adds/deletes searchable, atomically, fleet-wide.

        Returns (result body, simulated latency). Latency = the writer
        fan-out (all touched partitions pack concurrently at one arrival
        instant, like a scatter) plus the rollover prewarm pings. The
        serving pointer (``self.gen``) flips together with the manifests;
        the prewarm pings then hydrate every pool on the new generation
        off the query path, and any query already dispatched keeps its own
        pinned generation (still readable), so nothing is dropped or torn.
        On ANY failure the writer state rolls back to the pre-commit
        checkpoint (already-uploaded segments remain as unreferenced
        orphans for gc) and the staged batch stays pending; queries keep
        pinning the old generation, which every partition still serves.

        CONCURRENT WRITERS (``fork``): if a racing writer published past
        this writer's view, the commit REBASES the staged batch on the
        winner's generation first (``_rebase``) — and when the race is
        lost mid-publish (:class:`PublishConflict` from the CAS or the
        create-once segment upload), it rolls back, rebases on the new
        winner, and retries, up to ``max_publish_retries`` extra attempts.
        Exhaustion re-raises the conflict with the checkpoint restored and
        the batch still staged."""
        t0 = self.runtime.clock if t_arrival is None else t_arrival
        if not self.pending_adds and not self.pending_deletes:
            return {"gen": self.gen, "committed": False}, 0.0
        cp = self._checkpoint()
        conflicts = rebased = 0
        while True:
            try:
                if self._foreign_gen() is not None:
                    self._rebase()
                    rebased += 1
                next_gen = max(self.gen, self._published_gen()) + 1
                result, write_lat = self._commit_locked(next_gen, t0)
                break
            except PublishConflict:
                self._restore(cp)
                conflicts += 1
                if conflicts > max_publish_retries:
                    raise
            except Exception:
                self._restore(cp)
                raise
        result["publish_conflicts"] = conflicts
        result["rebased"] = rebased
        # KV content changes land only AFTER the publishes succeeded — a
        # rolled-back commit must neither lose deleted docs' content nor
        # orphan never-published adds in the doc store. Deletes skip ext
        # ids this same commit re-added (the put below writes the new
        # content); adds become fetchable exactly when they become
        # searchable.
        for ext in result.pop("_deleted_ids"):
            if ext not in self._ext_index:
                self.doc_store.delete(ext)
        for ext, text in result.pop("_added_docs"):
            self.doc_store.put(ext, {"id": ext, "contents": text})

        # zero-downtime rollover: hydrate every pool on the new generation
        # OFF the query path, then gc superseded generations (the serving
        # and previous manifests — and every segment they pin — survive)
        pings = rollover_fleet(
            self.runtime, fn_groups, next_gen,
            ping_payload=ping_payload, t_arrival=t0 + write_lat)
        ping_lat = max((r.latency_s for r in pings), default=0.0)
        for st in self.parts:
            self.catalog.gc(st.asset, keep=2)
        self._gc_state_segments()
        result["pings"] = len(pings)
        self.commits.append(dict(result, t=t0))
        return result, write_lat + ping_lat

    def _gc_state_segments(self) -> None:
        """Reclaim shared stats/vocab segments that NO surviving partition
        manifest references — the same reference-based rule the catalog's
        own segment gc uses. An age cutoff would be wrong: after a partial
        publish failure the generation sequence can skip, leaving a kept
        rollback manifest pointing at a state segment older than the
        naive keep window. Also sweeps orphans failed commits left."""
        live: set[str] = set()
        for st in self.parts:
            for v in self.catalog.versions(st.asset):
                m = self.catalog.read_generation(st.asset, v)
                if m.stats_ref and m.stats_ref[0] == self.stats_asset:
                    live.add(m.stats_ref[1])
        self.catalog.sweep_unreferenced(self.stats_asset, live)

    def _commit_locked(self, next_gen: int, t0: float) -> tuple[dict, float]:
        """The state-mutating half of ``commit``: stats/vocab/tier updates,
        the billed writer fan-out, and the CAS manifest publishes. Runs
        under ``commit``'s checkpoint — any exception here rolls everything
        back."""
        # deletes first: tombstone the internal POSITION (a re-add of the
        # same ext id gets a fresh position the tombstone can't touch) and
        # fold the doc out of the global stats
        new_tombs: list[set] = [set() for _ in self.parts]
        n_del = 0
        deleted_ids = []
        for ext in sorted(self.pending_deletes):
            p, pos, text = self._ext_index.pop(ext)
            new_tombs[p].add(pos)
            update_stats(self.stats, text, sign=-1)
            deleted_ids.append(ext)
            n_del += 1
        # adds: round-robin over partitions, fold INTO the global stats
        # (each doc tokenized ONCE here, shared by stats + vocab growth)
        staged: list[list] = [[] for _ in self.parts]
        new_terms: set[str] = set()
        for ext, text in self.pending_adds:
            p = self._rr % len(self.parts)
            self._rr += 1
            pos = len(self.parts[p].seg_docs) + len(staged[p])
            staged[p].append((ext, text))
            self._ext_index[ext] = (p, pos, text)
            counts = token_counts(text)
            new_terms.update(counts)
            update_stats(self.stats, text, sign=1, counts=counts)
        self.vocab = extend_vocab(self.vocab, new_terms)
        n_add = len(self.pending_adds)
        self.pending_adds, self.pending_deletes = [], set()
        self._pending_ids = set()

        # writer fan-out: every touched partition packs at one arrival
        recs, plans = [], []
        for i, st in enumerate(self.parts):
            st.tombstones |= new_tombs[i]
            do_merge = self.merge_policy.should_merge(
                st.base_docs, st.delta_docs + len(staged[i]),
                len(st.deltas) + (1 if staged[i] else 0),
                len(st.tombstones))
            if not staged[i] and not do_merge:
                plans.append(None)
                continue
            st.staged_docs = staged[i]
            op = "merge" if do_merge else "delta"
            out, rec = self.runtime.invoke(
                self._writer_fn(i), {"op": op, "gen": next_gen},
                t_arrival=t0, write=True)
            recs.append(rec)
            plans.append(out)
        write_lat = max((r.latency_s for r in recs), default=0.0)

        # apply the writers' results, then CAS-publish EVERY partition's
        # manifest at next_gen (global stats moved, so every partition's
        # scoring state did too — untouched segment tiers just re-point)
        merged_parts = []
        for i, (st, out) in enumerate(zip(self.parts, plans)):
            if out is not None and out["op"] == "merge":
                st.seg_docs = st.live_docs() + st.staged_docs
                st.base_seg, st.deltas = out["seg"], []
                st.base_docs, st.delta_docs = len(st.seg_docs), 0
                st.tombstones = set()
                if out.get("vec_seg"):
                    st.vec_base, st.vec_deltas = out["vec_seg"], []
                # a merge renumbers the partition's internal positions
                for pos, (ext, text) in enumerate(st.seg_docs):
                    self._ext_index[ext] = (i, pos, text)
                merged_parts.append(i)
            elif out is not None:
                st.seg_docs = st.seg_docs + st.staged_docs
                st.deltas = st.deltas + [out["seg"]]
                st.delta_docs += len(st.staged_docs)
                if out.get("vec_seg"):
                    st.vec_deltas = st.vec_deltas + [out["vec_seg"]]
            st.staged_docs = []
        self.gen = next_gen
        # ONE shared stats/vocab segment per generation; every partition's
        # manifest references it instead of inlining O(vocab) bytes each
        self._stats_ref = self.catalog.publish_generation_state(
            self.stats_asset, next_gen, self.stats, self.vocab,
            writer={"rr": self._rr} if self._forked else None)
        for st in self.parts:
            self.catalog.publish_generation(st.asset, self._manifest(st))
        return {"gen": next_gen, "committed": True, "indexed": n_add,
                "deleted": n_del, "merged": merged_parts,
                "writers": len(recs), "_deleted_ids": deleted_ids,
                "_added_docs": [d for part in staged for d in part]}, write_lat

    # -- introspection (tests, benches, the oracle) -----------------------------

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
    id. With the (always-attached) :class:`FleetIndexer`, offsets are the
    cumulative ACTUAL tier sizes (``part_doc_offsets()`` — tombstoned
    slots included until a merge purges them), so ids shift as commits
    land; clients should key on ``ext_ids``, which are stable. Only for a
    never-committed fleet does the offset reduce to the bootstrap-uniform
    ``partition * n_docs_local`` the mesh-level path shares.
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
    controller: FleetController | None = None
    indexer: FleetIndexer | None = None
    # text → (dim,) f32 query embedder; non-None iff the fleet serves a
    # dense-vector tier (FleetSpec.index.vector)
    embedder: "Callable | None" = None
    # format-v2 structured tier (IndexSpec.structured/facet_fields):
    # fielded scoring, phrases, facets, snippets via sq/sqs bodies
    structured: bool = False
    facet_fields: tuple = ()

    def query(self, q: "str | list[str] | None" = None, k: int = 10, *,
              t_arrival: float | None = None, fetch_docs: bool = True,
              mode: str = "sparse", vector=None, sq=None, facets=None,
              snippets: bool = False):
        """One query (str) or a micro-batch (list of str) through the
        gateway; batches evaluate as ONE invocation per partition.

        ``mode`` selects the tier(s): ``"sparse"`` (BM25), ``"dense"``
        (embedding inner product), or ``"hybrid"`` (both, fused with
        Reciprocal Rank Fusion). ``vector`` optionally supplies the query
        embedding(s) — one (dim,) sequence per query — otherwise the
        fleet's embedder derives them from the text; dense-mode callers
        may pass ``q=None`` with ``vector`` alone.

        ``sq`` is a STRUCTURED query in the v2 DSL (or a list of them —
        mutually exclusive with ``q``): terms, ``field:term`` scoping,
        quoted phrases, ``^boost``, AND/OR. Parsed ONCE here at admission
        (malformed queries 400 before anything dispatches); partitions
        evaluate the shipped AST. ``facets`` names declared facet fields
        to count over each query's FULL match set, merged at gather like
        top-k. ``snippets=True`` cuts highlighted fragments from the
        fetched docs. All three need a fleet built with
        ``IndexSpec(structured=True, ...)``.

        ``k`` is capped at the per-partition ``SearchConfig.k``: each
        partition returns its top ``search_k`` candidates, so
        merged ranks beyond that are not sound and are never returned."""
        return self.gateway.request(
            "GET", "/search",
            _search_body(q, k, fetch_docs, mode, vector, sq, facets,
                         snippets),
            t_arrival=t_arrival)

    def submit(self, q: "str | list[str] | None" = None, k: int = 10, *,
               t_arrival: float | None = None, fetch_docs: bool = True,
               mode: str = "sparse", vector=None, sq=None, facets=None,
               snippets: bool = False) -> PendingResponse:
        """Admit a query to the gateway's adaptive micro-batch window:
        concurrent arrivals inside one window coalesce into ONE
        ``ScatterGather.search_batch`` dispatch — one batched invocation
        per partition per window — and under sparse traffic the window is
        zero, so the returned handle resolves immediately with exactly the
        latency :meth:`query` would have charged. The serving generation is
        pinned per query AT ADMISSION: a commit landing while the window is
        open splits the flush into per-generation dispatches instead of
        moving an admitted query to an index it didn't arrive under.
        ``mode``/``vector``/``sq``/``facets``/``snippets`` as in
        :meth:`query`; a window groups dispatches by (generation, mode,
        structured), so mixed traffic coalesces per dispatch shape."""
        return self.gateway.submit(
            "GET", "/search",
            _search_body(q, k, fetch_docs, mode, vector, sq, facets,
                         snippets),
            t_arrival=t_arrival)

    def flush(self, now: float | None = None) -> int:
        """Close the search route's due admission window(s) — the window
        timer's analogue for virtual-clock drivers; call once at end of
        run (``now=None`` closes unconditionally)."""
        return self.gateway.flush(now)

    def warm(self, *, t_arrival: float | None = None) -> list[InvocationRecord]:
        """Touch EVERY function — primaries and replicas — once, hydrating
        each pool (replicas otherwise only see traffic when a hedge fires,
        so a backup leg would land as cold as the straggler it covers).
        The paper's "keep the fleet warm" pinger, fleet-wide. Pings are
        capacity maintenance, not queries: they bill to the ledger's idle
        line and stay out of latency percentiles and controller signals."""
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

    # -- the /index coordinator (NRT writes) --------------------------------------

    def add_documents(self, docs: Iterable[tuple[str, str]], *,
                      t_arrival: float | None = None):
        """Stage (ext_id, text) docs for the next commit."""
        return self.gateway.request(
            "POST", "/index", {"op": "add", "docs": [list(d) for d in docs]},
            t_arrival=t_arrival)

    def delete_documents(self, ids: Iterable[str], *,
                         t_arrival: float | None = None):
        """Stage deletes (tombstones) for the next commit."""
        return self.gateway.request(
            "POST", "/index", {"op": "delete", "ids": list(ids)},
            t_arrival=t_arrival)

    def commit(self, *, t_arrival: float | None = None):
        """Pack staged changes into delta segments, publish the next
        generation, and roll the fleet over to it — zero downtime."""
        return self.gateway.request(
            "POST", "/index", {"op": "commit"}, t_arrival=t_arrival)

    def _index_route(self, body: dict, t_arrival: float | None
                     ) -> tuple[dict, float, InvocationRecord | None]:
        ix = self.indexer
        if ix is None:
            raise ValueError("this app was built without an indexer")
        op = body.get("op")
        if op == "add":
            n = ix.stage_add([tuple(d) for d in body["docs"]])
            return {"staged": True, "pending_adds": n}, ENQUEUE_COST_S, None
        if op == "delete":
            n = ix.stage_delete(body["ids"])
            return {"staged": True, "pending_deletes": n}, ENQUEUE_COST_S, None
        if op == "commit":
            # rollover prewarm: partial, term-frequency-ranked — each ping
            # hydrates the new generation's superindex + the top-df terms'
            # blocks (and the dense tier's live rows, when one exists)
            # instead of backfilling the whole partition; the cold tail
            # still lazy-loads on demand. Eager fleets hydrate fully, as
            # before.
            ping = {"q": "", "k": 1, "fetch_docs": False,
                    "prewarm_terms": PREWARM_TOP_TERMS}
            if self.embedder is not None:
                ping["prewarm_dense"] = True
            result, lat = ix.commit(
                self.fn_groups, t_arrival=t_arrival, ping_payload=ping)
            return result, lat, None
        raise ValueError(f"unknown /index op {op!r}")

    # -- the /search coordinator (Gateway → ScatterGather → merge) ---------------

    def _global_id(self, hit: PartitionHit, offsets: list[int] | None) -> int:
        if offsets is not None:
            return offsets[hit.partition] + hit.doc_id
        return hit.partition * self.n_docs_local + hit.doc_id

    def _fetch_raw(self, merged: list[list[PartitionHit]],
                   fetch_docs: bool) -> tuple[dict, float]:
        """ONE batched KV fetch for the union of all merged hits — per-query
        (or per-partition) round trips would defeat the batching. Charged
        per BatchGetItem-sized chunk (the store's own accounting)."""
        ext = dict.fromkeys(
            h.ext_id for hits in merged for h in hits if h.ext_id is not None)
        if not fetch_docs:
            return {}, 0.0
        return self.doc_store.batch_get_billed(ext)

    def _materialize(self, hits: list[PartitionHit], raw: dict, *,
                     terms: "list[str] | None" = None,
                     snippets: bool = False) -> dict:
        offsets = (self.indexer.part_doc_offsets()
                   if self.indexer is not None else None)
        ext_ids = [h.ext_id for h in hits]
        docs = [raw.get(e) for e in ext_ids] if raw else []
        out = {
            "ids": [self._global_id(h, offsets) for h in hits],
            "scores": [h.score for h in hits],
            "ext_ids": ext_ids,
            "docs": docs,
        }
        if snippets:
            # cut from the SAME deduped KV fetch the merge already did —
            # snippets add zero extra round trips (they need fetch_docs)
            out["snippets"] = [
                make_snippet(d["contents"], terms or []) if d else None
                for d in docs]
        return out

    def _merged_facets(self, results: list, qi: int, batched: bool,
                       facet_fields) -> dict:
        """Gather-side facet merge for one query: each partition counted
        its FULL eligible match set per requested field; string-keyed
        summation joins them globally — facets merge at gather exactly
        like top-k, one more reduction over the same scatter results."""
        per_part = [(r["results"][qi] if batched else r) for r in results]
        return {f: merge_facet_counts(
                    [pp.get("facets", {}).get(f, {}) for pp in per_part])
                for f in facet_fields}

    def _field_avgdl(self) -> dict:
        """Live per-field average lengths from the writer's global stats —
        partition-invariant scoring inputs, shipped with every structured
        scatter (resolved at the same instant the generation is pinned,
        so legs never score a field under a different corpus state than
        the generation they serve)."""
        stats = self.indexer.stats
        return {f: field_avgdl(stats, f) for f in stats.get("fields", {})}

    def _structured_plan(self, body: dict, mode: str
                         ) -> tuple[str, bool, list, None, "list[Query]"]:
        """The structured (``sq``/``sqs``) half of :meth:`_query_plan`:
        parse the DSL ONCE here at admission — workers only ever see the
        shipped AST payloads — and reject everything the fleet cannot
        serve (no structured tier, undeclared facet field, malformed
        query) BEFORE anything dispatches."""
        if mode != "sparse":
            raise BadRequest("structured queries are sparse-tier only "
                             f"(got mode={mode!r})")
        if not self.structured:
            raise BadRequest(
                "this fleet serves no structured tier (build it with "
                "FleetSpec(index=IndexSpec(structured=True, ...)))")
        if "q" in body or "queries" in body:
            raise BadRequest("pass either q/queries or sq/sqs, not both")
        batched = "sqs" in body
        raw = list(body["sqs"]) if batched else [body["sq"]]
        if batched and not raw:
            raise BadRequest("sqs=[] — an empty micro-batch has nothing "
                             "to dispatch")
        try:
            asts = [parse_query(s) for s in raw]
        except QueryParseError as e:
            raise BadRequest(str(e)) from None
        for f in body.get("facets", ()):
            if f not in self.facet_fields:
                raise BadRequest(
                    f"facet field {f!r} not declared "
                    f"(declared: {list(self.facet_fields)})")
        return mode, batched, raw, None, asts

    def _query_plan(self, body: dict) -> tuple[str, bool, "list | None",
                                               "list | None",
                                               "list[Query] | None"]:
        """Validate a /search body and resolve its tiers' inputs:
        (mode, batched, texts, vectors, structured ASTs). Texts is None
        for a vector-only dense query; vectors is None for sparse; ASTs
        are non-None iff the body carries ``sq``/``sqs`` (texts then
        holds the raw DSL strings). Embeds text queries at the
        COORDINATOR when the client sent no vectors — every scatter
        leg (and the oracle) then scores identical floats. Raises
        :class:`BadRequest` for anything the fleet cannot serve."""
        mode = body.get("mode", "sparse")
        if mode not in SEARCH_MODES:
            raise BadRequest(f"mode must be one of {SEARCH_MODES}, "
                             f"got {mode!r}")
        if "sq" in body or "sqs" in body:
            return self._structured_plan(body, mode)
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
                # has nothing to scatter, and invoking the fleet for it
                # would bill every partition for zero queries (the gateway
                # maps this to a 400 — the client's error, not a 502)
                raise BadRequest("queries=[] — an empty micro-batch has "
                                 "nothing to dispatch")
            return mode, batched, texts, None, None
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
        return mode, batched, texts, vecs, None

    def _merged_hitlists(self, results: list, n_q: int, batched: bool,
                         mode: str, k: int) -> list[list[PartitionHit]]:
        """Coordinator-side gather: per-query global top-k hit lists from
        the scatter's raw per-partition results.

        Sparse/dense merge exactly like the pre-hybrid path (the handler
        puts the selected tier's hits in the primary result fields).
        Hybrid fuses with Reciprocal Rank Fusion: each tier merges to the
        full per-partition depth (``search_k`` — the deepest sound
        ranking), then ``rrf_fuse`` combines the two rankings by rank
        alone, in fixed (sparse, dense) tier order — the same call the
        oracle fusion makes, so fused scores are bit-identical to it."""
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

    def _search_route(self, body: dict, t_arrival: float | None
                      ) -> tuple[dict, float, InvocationRecord | None]:
        # a partition only surfaces its top search_k candidates — a merged
        # rank past that could silently miss docs, so clamp rather than lie
        k = min(int(body.get("k", self.search_k)), self.search_k)
        fetch_docs = body.get("fetch_docs", True)
        mode, batched, texts, vecs, asts = self._query_plan(body)
        n_q = len(asts) if asts is not None else \
            len(texts) if texts is not None else len(vecs)
        facet_req = list(body.get("facets", ())) if asts is not None else []
        snippets = bool(body.get("snippets")) and asts is not None
        # hybrid legs return their full search_k per tier — RRF ranks are
        # only sound at the deepest per-tier depth; the fused list then
        # truncates to the caller's k
        payload = {"k": self.search_k if mode == "hybrid" else k,
                   "fetch_docs": False}
        if mode != "sparse":
            payload["mode"] = mode
        if self.indexer is not None:
            # pin ONE generation for every leg of this query — primaries,
            # hedged backups, freshly-scaled replicas — so a commit's
            # rollover landing mid-scatter can never tear the merge across
            # generations (ScatterGather additionally asserts this, across
            # BOTH tiers of a hybrid result)
            payload["gen"] = self.indexer.gen
        if asts is not None:
            # ship the admission-parsed ASTs (workers never re-parse) with
            # the per-query facet requests and the live field avgdls —
            # resolved HERE, the same instant the generation was pinned
            if batched:
                payload["sqs"] = [a.to_payload() for a in asts]
            else:
                payload["sq"] = asts[0].to_payload()
            payload["facets"] = [facet_req] * n_q
            payload["favg"] = self._field_avgdl()
        elif batched:
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

        def _mat(qi: int) -> dict:
            r = self._materialize(
                merged[qi], raw,
                terms=asts[qi].terms if asts is not None else None,
                snippets=snippets)
            if facet_req:
                r["facets"] = self._merged_facets(results, qi, batched,
                                                  facet_req)
            return r

        if batched:
            result: dict = {"results": [_mat(qi) for qi in range(n_q)]}
        else:
            result = _mat(0)
        result["partitions"] = [
            {"fn": r.fn, "cold": r.cold, "hydrate_s": r.hydrate_s,
             "backfill_s": r.backfill_s, "latency_s": r.latency_s,
             "hedged": r.hedged} for r in records]
        if "gen" in payload:
            result["generation"] = payload["gen"]
        slowest = max(records, key=lambda r: r.latency_s, default=None) \
            if records else None
        # the control loop rides the request path: the controller ticks at
        # the arrival instant AFTER dispatch — scale decisions see this
        # arrival in their window, and keep-alive pings can never race the
        # request itself for a pool's idle instance (the legs just
        # dispatched hold their instances busy at t0, so their pools are
        # skipped as traffic-warmed)
        if self.controller is not None:
            self.controller.maybe_tick(
                self.runtime.clock if t_arrival is None else t_arrival)
        return result, lat + fetch_s, slowest

    # -- the windowed /search coordinator (adaptive micro-batch dispatch) ---------

    def _admit_search(self, body: dict, t_arrival: float) -> dict:
        """Admission hook for the batched ``/search`` route: validate the
        body before it can occupy the window, and pin the serving
        generation AT ADMISSION — so a commit whose rollover lands while
        the window is still open can never retroactively move an admitted
        query onto an index it didn't arrive under (the flush then splits
        into one scatter per pinned generation; every one of them still
        merges hits from exactly one generation). Dense/hybrid bodies also
        resolve their query vectors here (embedding the text when the
        client sent none), so a flush never has to reject. Structured
        bodies parse their DSL here (malformed → 400 before the window)
        and pin the live field avgdls alongside the generation — the
        scoring state a commit inside the open window must not move."""
        mode, _, texts, vecs, asts = self._query_plan(body)
        body = dict(body)
        body["_texts"], body["_vecs"], body["_mode"] = texts, vecs, mode
        body["_asts"] = asts
        if asts is not None:
            body["_favg"] = self._field_avgdl()
        if self.indexer is not None:
            body["_gen"] = self.indexer.gen
        return body

    def _search_route_batch(self, bodies: list, t_arrivals: list,
                            t_dispatch: float) -> list:
        """Dispatch ONE admission window: every query of every admitted
        body rides a single ``search_batch`` scatter per pinned generation
        — one batched invocation per partition per window — and the merged
        per-query top-k is bit-identical to serial dispatch (per-query
        candidate sets never interact; a window's k is the per-partition
        ``search_k`` ceiling and each body's smaller ``k`` is a prefix of
        that merge). Duplicate query strings across (or within) bodies are
        NOT coalesced: every admitted query gets its own slot in the batch
        and its own full result."""
        # (batched, texts, vecs, mode, n_q, k, fetch_docs, gen, asts,
        #  facets, snippets, favg) per body — _admit_search already
        # validated and resolved _texts/_vecs/_mode/_asts/_favg
        per_body = []
        for body in bodies:
            texts, vecs = body["_texts"], body["_vecs"]
            mode = body["_mode"]
            asts = body.get("_asts")
            per_body.append((
                "queries" in body or "qvs" in body or "sqs" in body,
                texts, vecs, mode,
                len(asts) if asts is not None else
                len(texts) if texts is not None else len(vecs),
                min(int(body.get("k", self.search_k)), self.search_k),
                body.get("fetch_docs", True),
                body.get("_gen"),
                asts,
                list(body.get("facets", ())) if asts is not None else [],
                bool(body.get("snippets")) and asts is not None,
                body.get("_favg")))
        # one scatter per (pinned generation, mode, structured), in
        # admission order — normally exactly one; more when a commit
        # landed inside the open window or dispatch shapes mix (tiers
        # hydrate per leg and structured payloads ship ASTs, so shape is
        # part of the dispatch identity, not a per-query flag)
        group_order: list = []
        group_members: dict = {}
        for bi, pb in enumerate(per_body):
            gkey = (pb[7], pb[3], pb[8] is not None)
            if gkey not in group_members:
                group_order.append(gkey)
                group_members[gkey] = []
            group_members[gkey].append(bi)
        merged_by_body: dict[int, list] = {}
        facets_by_body: dict[int, list] = {}
        lat_by_body: dict[int, float] = {}
        recs_by_body: dict[int, list] = {}
        for gkey in group_order:
            gen, mode, structured = gkey
            idxs = group_members[gkey]
            payload: dict = {"k": self.search_k, "fetch_docs": False}
            if structured:
                # flat AST micro-batch + per-query facet requests; favg is
                # generation-pinned, so any member's pin serves the group
                payload["sqs"] = [a.to_payload() for bi in idxs
                                  for a in per_body[bi][8]]
                payload["facets"] = [per_body[bi][9] for bi in idxs
                                     for _ in per_body[bi][8]]
                payload["favg"] = per_body[idxs[0]][11] or {}
            else:
                if mode != "sparse":
                    payload["mode"] = mode
                    payload["qvs"] = [v for bi in idxs
                                      for v in per_body[bi][2]]
                if mode != "dense":
                    payload["queries"] = [q for bi in idxs
                                          for q in per_body[bi][1]]
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
                freq = per_body[bi][9]
                if freq:
                    facets_by_body[bi] = [
                        self._merged_facets(results, at + j, True, freq)
                        for j in range(n)]
                at += n
                lat_by_body[bi] = lat
                recs_by_body[bi] = records
        # ONE batched KV fetch for the union of every doc-requesting
        # body's hits — the same amortization the handler-side batch does
        need = [hits for bi, pb in enumerate(per_body)
                if pb[6] for hits in merged_by_body[bi]]
        raw, fetch_s = self._fetch_raw(need, True) if need else ({}, 0.0)
        out = []
        for bi, (batched, texts, vecs, mode, n_q, k, fetch_docs, gen,
                 asts, freq, snip, _favg) in enumerate(per_body):
            braw = raw if fetch_docs else {}
            hit_lists = [hits[:k] for hits in merged_by_body[bi]]

            def _mat(j: int) -> dict:
                r = self._materialize(
                    hit_lists[j], braw,
                    terms=asts[j].terms if asts is not None else None,
                    snippets=snip)
                if freq:
                    r["facets"] = facets_by_body[bi][j]
                return r

            if batched:
                result: dict = {"results": [_mat(j) for j in range(n_q)]}
            else:
                result = _mat(0)
            result["partitions"] = [
                {"fn": r.fn, "cold": r.cold, "hydrate_s": r.hydrate_s,
                 "backfill_s": r.backfill_s, "latency_s": r.latency_s,
                 "hedged": r.hedged}
                for r in recs_by_body[bi]]
            if gen is not None:
                result["generation"] = gen
            out.append((result,
                        lat_by_body[bi] + (fetch_s if fetch_docs else 0.0)))
        # same control-loop ride-along as the serial path: tick AFTER the
        # window dispatched, so keep-alive pings never race the batch for
        # a pool's idle instance
        if self.controller is not None:
            self.controller.maybe_tick(t_dispatch)
        return out


def build_partitioned_search_app(
    docs: Iterable[tuple[str, str]],
    spec: "FleetSpec | int | None" = None,
    *,
    n_parts: int | None = None,
    replicas: int | None = None,
    hedge: "HedgePolicy | float | None" = None,
    autoscale: "AutoscalePolicy | bool | None" = None,
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
    ``/search``.

    The configuration surface is :class:`~repro_torch.core.partition.FleetSpec`::

        app = build_partitioned_search_app(docs, FleetSpec(
            n_parts=4,
            replication=ReplicationSpec(replicas=2, hedge=0.05),
            index=IndexSpec(vector=VectorSpec(dim=16)),   # dense tier
        ))

    DEPRECATED: the pre-FleetSpec keyword sprawl (``n_parts=...,
    replicas=..., hedge=..., ...``) still assembles identically through a
    shim — each legacy kwarg maps onto the corresponding spec field, and a
    bare int second positional is ``n_parts`` — but new call sites should
    pass a ``FleetSpec``; mixing both surfaces in one call is an error.

    Every partition's segment is packed with ``compute_global_stats`` over
    the FULL corpus — the distributed-IR invariant that makes the merged
    ranking identical to a single-index build at any partition count.

    ``replicas=R`` publishes each segment ONCE (shared ``AssetCatalog``
    entry) but registers R functions per partition — separate instance
    pools over identical ``PackedIndex``es, so a backup leg returns
    bit-identical hits. ``hedge`` is a :class:`HedgePolicy` (or a float
    shorthand for a fixed ``after_s`` threshold) enabling projection-based
    backup legs; replicas without a policy are standby-only.

    ``autoscale`` (an :class:`AutoscalePolicy`, or ``True`` for defaults)
    attaches a :class:`FleetController`: ``replicas`` then only sets the
    STARTING group size, and the controller grows/shrinks each partition's
    pool count between ``min_replicas`` and ``max_replicas`` against the
    cost ledger, ticking on the request path. ``routing`` selects the
    scatter's primary-choice rule (``"static"`` or ``"aware"``); it
    defaults to ``"aware"`` whenever a controller is attached — a fleet
    whose pools come and go should not pin primaries to pool zero — and to
    the ``"static"`` behaviour otherwise.

    The fleet is WRITABLE: segments publish as generation 1 through a
    :class:`FleetIndexer`, and ``POST /index`` (``add_documents`` /
    ``delete_documents`` / ``commit``) grows the index with delta segments
    + zero-downtime generation rollovers; ``merge_policy`` bounds the
    delta tier. Every query pins the serving generation across all its
    scatter legs, so rollovers can never tear a merged result.

    ``window`` (a :class:`~repro_torch.core.gateway.WindowPolicy`; defaults
    apply when omitted) governs the gateway's adaptive micro-batch window
    behind :meth:`PartitionedSearchApp.submit`: concurrent arrivals
    coalesce into one batched invocation per partition per window, sized
    from the trailing arrival rate and zero under sparse traffic. The
    synchronous :meth:`~PartitionedSearchApp.query` path never waits on a
    window. ``partition_weights`` skews the document split (Zipf-shaped
    fleets: a hot head partition, a cold tail) — global BM25 stats keep
    the merged ranking exact regardless of the split.

    ``device`` (None → the card) is where every partition's searchers live.
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
    autoscale_policy = rep.autoscale
    if autoscale_policy is True:
        autoscale_policy = AutoscalePolicy()
    resolved_routing = gw.routing or ("aware" if autoscale_policy
                                      else "static")
    embedder = None
    if ix.vector is not None:
        embedder = ix.vector.embedder or hash_embedder(ix.vector.dim)
    scfg = spec.search_config or SearchConfig()
    if scfg.lazy_hydration is None:
        # the fleet default: cold legs answer from range reads of the
        # superindex + the queried terms' blocks, backfilling off the
        # critical path. Pass lazy_hydration=False to
        # pin the historical eager profile.
        scfg = dataclasses.replace(scfg, lazy_hydration=True)

    docs = list(docs)
    store = ObjectStore(spec.backend)
    doc_store = KVStore()
    catalog = AssetCatalog(store)
    runtime = FaaSRuntime(spec.runtime_config)
    # structured fleets carry per-field stats for BM25F avgdl; v1 fleets
    # must not grow the stats blob (its bytes feed hydration pricing)
    gstats = compute_global_stats(docs, fields=ix.structured)
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
        vec_dtype=ix.vector.dtype if ix.vector else "float32",
        structured=ix.structured, facet_fields=ix.facet_fields)
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
                            routing=resolved_routing,
                            degraded_ok=rep.degraded_ok)
    gateway = Gateway(runtime)
    controller = None
    if autoscale_policy:
        # one factory per partition: a scale-up registers a fresh handler
        # over the SAME published asset — no re-publish, no new segment
        factories = [
            (lambda a=asset_name: make_search_handler(
                catalog, doc_store, a, scfg, device))
            for asset_name in assets]
        controller = FleetController(
            runtime, scatter, factories, autoscale_policy,
            ping_payload={"q": "", "k": 1, "fetch_docs": False})
    app = PartitionedSearchApp(
        store=store, catalog=catalog, doc_store=doc_store, runtime=runtime,
        gateway=gateway, scatter=scatter, assets=assets,
        fn_names=scatter.fn_names, n_parts=spec.n_parts, n_docs_local=per,
        search_k=scfg.k,
        fn_groups=scatter.groups, replicas=rep.replicas,
        controller=controller, indexer=indexer, embedder=embedder,
        structured=ix.structured, facet_fields=tuple(ix.facet_fields))
    gateway.route("GET", "/search", app._search_route)
    # admission sheds feed the autoscaler: sustained backpressure is a
    # scale-up signal the latency/queue estimators can't see (shed
    # arrivals never reach a pool)
    gateway.route_batched("GET", "/search", app._search_route_batch,
                          policy=gw.window, admit=app._admit_search,
                          on_shed=controller.note_shed if controller
                          else None)
    gateway.route("POST", "/index", app._index_route)
    return app
