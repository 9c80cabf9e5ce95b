"""Versioned asset publishing + atomic switch-over (paper §3).

"Indexes can be built in batch offline, and then bulk loaded into a serving
framework. In such a scenario, new indexes can be placed alongside the old,
and then the Lambda instances can be refreshed to switch over to the new
indexes."

Layout in the object store:

    assets/<name>/versions/<version>/...files...
    assets/<name>/segments/<seg>/...files...   <- immutable segment data (NRT)
    assets/<name>/MANIFEST            <- tiny JSON pointer {"current": version}

Publishing writes the new version's files *alongside* the old, then swaps the
manifest with a conditional put (etag compare-and-set) so concurrent
publishers cannot interleave. Serving instances resolve the manifest on cold
start; ``refresh()`` invalidates hydration caches so the next invocation on
each instance re-resolves — exactly the paper's "Lambda instances can be
refreshed" story, with zero downtime (old version stays readable throughout).

Near-real-time indexing rides the same seam as *generations*: a generation
is a tiny manifest version (``generation.json``) that REFERENCES immutable
segments published under ``segments/`` — one base segment plus an ordered
delta tier — with a tombstone set for deletes and the live corpus-wide BM25
stats/vocab. Committing a batch publishes only the new delta's bytes (the
Airphant-style small-immutable-increment story), then CAS-flips the
manifest; a torn publish between two concurrent writers surfaces as
:class:`PublishConflict` on the loser, never as a half-visible generation.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import jsonutil as orjson   # orjson when installed

from repro_torch.core.directory import (Directory, RamDirectory, StoreDirectory,
                                  copy_directory)
from repro_torch.core.object_store import NoSuchKey, ObjectStore, PreconditionFailed


class PublishConflict(Exception):
    pass


GENERATION_FILE = "generation.json"


def generation_version(gen: int) -> str:
    """Canonical version string for generation ``gen``. Zero-padding makes
    typical listings read in order, but all ORDERING logic must go through
    :func:`parse_generation` — lexical comparison has a cliff at the first
    generation wider than the pad (gen-1000000 sorts before gen-999999)."""
    return f"gen-{gen:06d}"


def parse_generation(version: str) -> int | None:
    """Numeric generation of a ``gen-*`` version string, else None."""
    if version.startswith("gen-"):
        try:
            return int(version[4:])
        except ValueError:
            return None
    return None


@dataclasses.dataclass
class GenerationManifest:
    """One generation of a NRT-updated asset: base + ordered deltas +
    tombstones, plus the LIVE corpus-wide scoring state.

    The scoring state — ``stats`` (n_docs/avgdl/df over live documents)
    and ``vocab`` — is generation-level, not segment-level: segment blocks
    store only tf and doc lengths (stat-independent), and idf/avgdl are
    applied at QUERY time from this state — Lucene's move of computing idf
    from the live IndexReader. That is the invariant that keeps a
    delta-served index exactly rank-identical to a from-scratch rebuild of
    the final corpus; a frozen-idf delta would drift as the corpus grows.

    The state may be INLINE (``stats``/``vocab``) or SHARED
    (``stats_ref = [asset, segment]`` pointing at one stats segment in the
    catalog). Shared is what a partitioned fleet publishes: the global
    df/vocab are identical for every partition, so inlining them would
    store O(partitions × generations) copies of the whole vocabulary —
    the manifest would outweigh the delta it describes. Resolve with
    :meth:`AssetCatalog.resolve_generation_state`.
    """

    gen: int                       # monotonically increasing generation number
    base: str                      # base segment id (under segments/)
    deltas: list[str]              # ordered delta segment ids
    tombstones: list[int]          # deleted INTERNAL doc positions (stable:
    #                                base+delta order; a re-add gets a fresh
    #                                position, so old tombstones can't kill it)
    stats: dict | None = None      # inline live {"n_docs", "avgdl", "df"}
    vocab: dict | None = None      # inline frozen append-only term -> id map
    stats_ref: list | None = None  # OR shared: [asset, segment] in the catalog
    # dense-vector tier (hybrid retrieval): the SAME base+delta shape as the
    # BM25 tier, row positions aligned with it doc-for-doc, so ONE tombstone
    # list and ONE generation number govern both tiers. None = no dense tier
    # (pre-hybrid manifests parse unchanged).
    vec_base: str | None = None
    vec_deltas: list = dataclasses.field(default_factory=list)

    def to_json(self) -> bytes:
        return orjson.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, data: bytes) -> "GenerationManifest":
        return cls(**orjson.loads(data))

    @property
    def segments(self) -> list[str]:
        return [self.base] + list(self.deltas)

    @property
    def vec_segments(self) -> list[str]:
        """Dense-tier segment ids, base first ([] when no dense tier)."""
        if self.vec_base is None:
            return []
        return [self.vec_base] + list(self.vec_deltas)


class AssetCatalog:
    def __init__(self, store: ObjectStore, root: str = "assets") -> None:
        self.store = store
        self.root = root.rstrip("/")

    # -- paths -----------------------------------------------------------------

    def _manifest_key(self, name: str) -> str:
        return f"{self.root}/{name}/MANIFEST"

    def version_prefix(self, name: str, version: str) -> str:
        return f"{self.root}/{name}/versions/{version}/"

    def segment_prefix(self, name: str, seg: str) -> str:
        return f"{self.root}/{name}/segments/{seg}/"

    # -- publish (the offline batch-indexing side) --------------------------------

    def publish(self, name: str, version: str, files: Directory) -> str:
        """Upload `files` as a new version and atomically flip the manifest."""
        prefix = self.version_prefix(name, version)
        copy_directory(files, self.store, prefix)
        # compare-and-set the manifest
        try:
            cur = self.store.head(self._manifest_key(name))
            if_etag = cur.etag
        except NoSuchKey:
            if_etag = ""
        body = orjson.dumps({"current": version})
        try:
            self.store.put(self._manifest_key(name), body, if_etag=if_etag)
        except PreconditionFailed as e:
            raise PublishConflict(f"concurrent publish of {name!r}") from e
        return version

    def versions(self, name: str) -> list[str]:
        prefix = f"{self.root}/{name}/versions/"
        seen = []
        for meta in self.store.list(prefix):
            v = meta.key[len(prefix):].split("/", 1)[0]
            if v not in seen:
                seen.append(v)
        return seen

    def gc(self, name: str, keep: int = 2) -> list[str]:
        """Delete all but the newest `keep` versions (old one kept for
        rollback — the 'new indexes placed alongside the old' invariant).
        The CURRENT (serving) version is never deleted, whatever ``keep``
        says. Generation manifests additionally pin their segments: after
        pruning versions, any segment no surviving generation references is
        reclaimed too (a merged-away delta tier stops costing storage)."""
        current = self.current_version(name)
        # oldest-first, numerically for generations (lexical order has a
        # cliff when the gen number outgrows its zero-pad)
        vs = sorted(self.versions(name),
                    key=lambda v: (0, parse_generation(v))
                    if parse_generation(v) is not None else (1, v))
        doomed = [v for v in vs if v != current][: max(0, len(vs) - keep)]
        for v in doomed:
            for meta in self.store.list(self.version_prefix(name, v)):
                self.store.delete(meta.key)
        self._gc_segments(name)
        return doomed

    def _gc_segments(self, name: str) -> list[str]:
        """Reclaim segments referenced by NO surviving generation manifest.
        No-op for plain-segment assets (no generation manifests)."""
        live: set[str] = set()
        saw_generation = False
        for v in self.versions(name):
            d = StoreDirectory(self.store, self.version_prefix(name, v))
            if GENERATION_FILE not in d.list():
                continue
            saw_generation = True
            m = self.read_generation(name, v)
            live.update(m.segments)
            live.update(m.vec_segments)
        if not saw_generation:
            return []
        return self.sweep_unreferenced(name, live)

    def sweep_unreferenced(self, name: str, live: "set[str]") -> list[str]:
        """Delete every segment of ``name`` whose id is not in ``live``.
        The one segment-sweeping rule — shared by the catalog's own gc and
        any coordinator-level sweep (e.g. the fleet writer's shared
        stats/vocab segments), so key-layout changes can't diverge."""
        doomed = []
        prefix = f"{self.root}/{name}/segments/"
        for meta in self.store.list(prefix):
            seg = meta.key[len(prefix):].split("/", 1)[0]
            if seg not in live:
                self.store.delete(meta.key)
                if seg not in doomed:
                    doomed.append(seg)
        return doomed

    # -- generations (the NRT incremental-indexing side) ---------------------------

    def publish_segment(self, name: str, seg: str, files: Directory) -> str:
        """Upload one immutable segment's files under ``segments/<seg>/``.
        No manifest flip: a segment is invisible until a generation
        manifest referencing it is published.

        Segments are IMMUTABLE — publishing an id that already exists is
        refused as a :class:`PublishConflict`. Without this, two writers
        racing the same generation number would silently overwrite each
        other's segment BYTES before the manifest CAS picks a winner, and
        the winner's manifest could end up serving the loser's documents."""
        prefix = self.segment_prefix(name, seg)
        if self.store.list(prefix):
            raise PublishConflict(
                f"{name!r}: segment {seg!r} already published — segments "
                "are immutable; a racing writer owns this id")
        copy_directory(files, self.store, prefix)
        return seg

    def open_segment(self, name: str, seg: str, *,
                     block_size: int = 1 << 20) -> StoreDirectory:
        return StoreDirectory(self.store, self.segment_prefix(name, seg),
                              block_size=block_size)

    def publish_generation(self, name: str,
                           manifest: GenerationManifest) -> str:
        """Publish ``manifest`` as version ``gen-<gen>`` and CAS-flip the
        asset manifest to it.

        Two conflict classes, both surfaced as :class:`PublishConflict`:

        * a STALE BASE — the asset already serves ``manifest.gen`` or newer,
          so this writer built its delta against a superseded generation
          (checked against the manifest read below, not at an earlier
          instant, so sequential lost-update races are caught too);
        * a TORN PUBLISH — the asset manifest changed between that read and
          our conditional put (two writers racing the same flip); the etag
          compare-and-set lets exactly one land.

        The loser's generation files are cleaned up (no phantom generation
        for gc to mistake for live state); it must re-read the current
        generation, rebase its delta, and retry."""
        version = generation_version(manifest.gen)
        key = self._manifest_key(name)
        try:
            if_etag = self.store.head(key).etag
            current = orjson.loads(self.store.get(key))["current"]
        except NoSuchKey:
            if_etag, current = "", None
        cur_gen = parse_generation(current) if current is not None else None
        if cur_gen is not None and cur_gen >= manifest.gen:
            raise PublishConflict(
                f"{name!r}: generation {version} is not newer than the "
                f"published {current} — rebase the delta and retry")
        # create-once: two writers racing the SAME generation number would
        # otherwise write the same key, and the CAS loser's cleanup would
        # delete the file the WINNER's flip now serves. The conditional
        # create makes the generation directory exclusively ours — losing
        # THIS race is a conflict before anything else is touched.
        gen_key = self.version_prefix(name, version) + GENERATION_FILE
        try:
            self.store.put(gen_key, manifest.to_json(), if_etag="")
        except PreconditionFailed as e:
            raise PublishConflict(
                f"{name!r}: generation {version} already published by a "
                "concurrent writer — rebase the delta and retry") from e
        try:
            self.store.put(key, orjson.dumps({"current": version}),
                           if_etag=if_etag)
        except PreconditionFailed as e:
            # we exclusively own gen_key (create-once above), so deleting
            # it cannot destroy another writer's published generation
            self.store.delete(gen_key)
            raise PublishConflict(
                f"concurrent publish of {name!r} (lost the {version} "
                "manifest race)") from e
        return version

    def read_generation(self, name: str,
                        version: str | None = None) -> GenerationManifest:
        """Load the generation manifest for ``version`` (default: current)."""
        v = version if version is not None else self.current_version(name)
        d = StoreDirectory(self.store, self.version_prefix(name, v))
        return GenerationManifest.from_json(
            d.open_input(GENERATION_FILE).read_all())

    def current_generation(self, name: str) -> GenerationManifest:
        return self.read_generation(name)

    def publish_generation_state(self, name: str, gen: int, stats: dict,
                                 vocab: dict,
                                 writer: dict | None = None) -> list:
        """Publish one generation's SHARED scoring state (live stats +
        vocab) as a segment; returns the ``stats_ref`` the partition
        manifests should carry. One copy per generation, however many
        partitions reference it.

        ``writer`` optionally rides along as ``writer.json`` — coordinator
        bookkeeping (e.g. the round-robin placement cursor) a SECOND writer
        must adopt when it rebases on this generation, so a raced commit
        converges on the same document placement a serialized pair of
        commits would have produced."""
        seg = f"g{gen:06d}-state"
        files = {"stats.json": orjson.dumps(stats),
                 "vocab.json": orjson.dumps(vocab)}
        if writer is not None:
            files["writer.json"] = orjson.dumps(writer)
        self.publish_segment(name, seg, RamDirectory(files))
        return [name, seg]

    def resolve_generation_writer(self, manifest: GenerationManifest) -> dict:
        """The coordinator bookkeeping published with a generation's shared
        state ({} for inline-state or pre-writer-state generations)."""
        if manifest.stats_ref is None:
            return {}
        asset, seg = manifest.stats_ref
        d = self.open_segment(asset, seg)
        if "writer.json" not in d.list():
            return {}
        return orjson.loads(d.open_input("writer.json").read_all())

    def resolve_generation_state(self,
                                 manifest: GenerationManifest) -> tuple[dict, dict]:
        """(stats, vocab) for a manifest — inline, or read through the
        shared ``stats_ref`` segment (a billed store read)."""
        if manifest.stats is not None and manifest.vocab is not None:
            return manifest.stats, manifest.vocab
        if manifest.stats_ref is None:
            raise ValueError(
                f"generation {manifest.gen} manifest carries neither inline "
                "stats/vocab nor a stats_ref")
        asset, seg = manifest.stats_ref
        d = self.open_segment(asset, seg)
        return (orjson.loads(d.open_input("stats.json").read_all()),
                orjson.loads(d.open_input("vocab.json").read_all()))

    # -- resolve (the serving side) ------------------------------------------------

    def current_version(self, name: str) -> str:
        data = self.store.get(self._manifest_key(name))
        return orjson.loads(data)["current"]

    def open(self, name: str, version: str | None = None, *,
             block_size: int = 1 << 20) -> tuple[str, StoreDirectory]:
        v = version if version is not None else self.current_version(name)
        return v, StoreDirectory(self.store, self.version_prefix(name, v),
                                 block_size=block_size)


def refresh_fleet(runtime, asset_name: str) -> int:
    """Invalidate `asset_name` in every instance's hydration cache. The next
    invocation per instance re-resolves the manifest and re-hydrates — a
    rolling, zero-downtime switch-over."""
    dropped = 0
    for inst in runtime._instances:
        dropped += inst.cache.invalidate(asset_name)
    return dropped


def rollover_fleet(runtime, fn_groups, gen: int, *,
                   ping_payload: dict | None = None,
                   t_arrival: float | None = None,
                   stagger: bool = True) -> list:
    """Swap every pool of every replica group to generation ``gen`` with
    zero downtime: ping each function ONCE with the new generation pinned
    in the payload (keepalive — billed to the idle line, excluded from
    latency percentiles and policy history), so every pool hydrates — and
    jit-specializes on — the new generation OFF the query path.

    Pools within one replica group roll over STAGGERED (``stagger=True``,
    the default): pool *r+1*'s pings dispatch at the instant pool *r*'s
    pings complete, so at most ONE of a group's pools is ever busy
    hydrating — a query landing mid-rollover always finds the group's
    other pools idle (already re-warmed, or still warm on the old
    generation, which stays readable until gc), instead of every pool
    going busy at the same instant and forcing the query to queue behind
    a hydration or cold-boot a fresh instance. Replica groups themselves
    roll in parallel at ``t_arrival`` — a query fans out to EVERY
    partition, so serializing across groups would stretch the rollover
    without sheltering anyone. A single-pool group (R=1) has nothing to
    stagger; its behaviour is bit-identical either way.

    In-flight queries are never dropped: a query dispatched before the
    swap carries its own pinned generation and any instance can still
    re-hydrate that older generation (old versions stay readable until
    gc), so the coordinator may flip its serving generation the moment
    these pings return. Retired/unregistered functions are skipped (a
    rollover racing a scale-down must not resurrect a draining pool).

    EVERY idle instance of a pool gets its own ping (concurrent pings at
    one arrival instant land on distinct instances): a pool grown to N by
    concurrent traffic would otherwise prewarm only its MRU instance and
    the other N-1 would hydrate the new generation IN-BAND on their next
    query — exactly the p99 spike the prewarm exists to prevent. Busy
    instances can't be prewarmed (FaaS can't interrupt a running
    invocation); they pay their re-hydration on first touch, like any
    cold start."""
    t0 = runtime.clock if t_arrival is None else t_arrival
    payload = dict(ping_payload or {})
    payload["gen"] = gen
    recs = []
    for group in fn_groups:
        t_pool = t0
        for fn in (group if isinstance(group, (list, tuple)) else [group]):
            if not runtime.registered(fn):
                continue
            idle = sum(1 for i in runtime._instances
                       if i.fn == fn and i.alive and i.busy_until <= t_pool)
            pool_recs = []
            for _ in range(max(1, idle)):
                _, rec = runtime.invoke(fn, dict(payload), t_arrival=t_pool,
                                        keepalive=True)
                pool_recs.append(rec)
            recs.extend(pool_recs)
            if stagger and pool_recs:
                t_pool = max(r.t_done for r in pool_recs)
    return recs
