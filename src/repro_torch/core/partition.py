"""Document partitioning + global top-k merge (paper §3's scaling path) —
the port of ``repro/core/partition.py``.

"This barrier to scalability ... can be straightforwardly solved by standard
document partitioning practices, where separate Lambda instances are assigned
to different partitions of the document collection."

Two realizations, same math:

* **Mesh-level** (``partitioned_topk``, ``shard_topk_merge``): shards of the
  candidate/document axis live on the partitions of a mesh
  (:mod:`repro_torch.parallel.compat`: one per rank, or all stacked on one
  card); each computes its local top-k; the k·P survivors are all-gathered
  and reduced to the global top-k. k ≪ N/P makes the collective tiny. Every
  top-k is K2's (:func:`repro_torch.kernels.topk.topk`: the kernel on the
  card, its twin on the CPU), ties to the lower position in the row, as
  ``lax.top_k``.

* **Fleet-level** (``ScatterGather``): one FaaS function per partition; the
  coordinator fans out a query to every partition's function and merges the
  per-partition hits. Latency = max over partitions (+merge), i.e. the
  straggler profile the runtime's hedging targets. Partitions may be
  REPLICATED: a replica group serves one segment from R independent instance
  pools, and a ``HedgePolicy`` fires a backup leg on a replica whenever the
  primary's projected completion (queue + cold boot) exceeds a quantile of
  recent warm latencies.
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable, Sequence

import torch

from repro_torch.core.runtime import RetriesExhausted, nearest_rank_percentiles
from repro_torch.kernels.topk import topk
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P

if TYPE_CHECKING:   # type-only: autoscale/gateway/index/search import upward
    from repro_torch.core.autoscale import AutoscalePolicy
    from repro_torch.core.gateway import WindowPolicy
    from repro_torch.core.object_store import Backend
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.index.builder import MergePolicy
    from repro_torch.search.searcher import SearchConfig


def local_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of (scores, ids) along the last axis: K2 over the rows, ties to
    the lower position in the row, then each winner's id. ``ids`` broadcasts
    against ``scores``."""
    n = scores.shape[-1]
    vals, pos = topk(scores.reshape(-1, n), k)
    lead = scores.shape[:-1]
    pos = pos.long().clamp(max=n - 1).view(*lead, -1)   # K2 marks a -inf slot n
    ids = torch.gather(torch.broadcast_to(ids, scores.shape), -1, pos)
    return vals.view(*lead, -1), ids


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Merge candidate sets along the last axis into top-k (ties → the lower
    position in the gathered row, which is not the lower id; scores ordering
    only, like Lucene's by-score)."""
    return local_topk(scores, ids, k)


def shard_topk_merge(scores: torch.Tensor, ids: torch.Tensor, k: int, axis_name: str):
    """Inside shard_map: local top-k, all-gather survivors, global top-k.

    scores/ids: (L, ..., n_local). Returns (L, ..., k) replicated across
    axis_name."""
    lv, li = local_topk(scores, ids, k)
    gv = compat.all_gather(lv, axis_name)          # (L, ..., k·P)
    gi = compat.all_gather(li, axis_name)
    return merge_topk(gv, gi, k)


def partitioned_topk(score_fn: Callable[..., torch.Tensor], mesh: "compat.Mesh | None",
                     axis_name: str, k: int, *, in_specs: Any, query_spec: Any = None):
    """Build a shard_map'd global-top-k scorer.

    ``score_fn(query, *state_shards) -> (L, ..., n_local) scores`` runs per
    partition (the leading L of :mod:`repro_torch.parallel.compat`); doc ids
    are reconstructed as partition-local offsets shifted by the partition
    index so returned ids are global."""

    def per_shard(query, *state):
        scores = score_fn(query, *state)
        n_local = scores.shape[-1]
        p = compat.axis_index(axis_name)
        base = (p * n_local).to(torch.int32).view(-1, *[1] * (scores.dim() - 1))
        ids = base + torch.arange(n_local, dtype=torch.int32, device=scores.device)
        return shard_topk_merge(scores, ids, k, axis_name)

    qspec = query_spec if query_spec is not None else P()
    return compat.shard_map(per_shard, mesh, in_specs=(qspec,) + tuple(in_specs),
                            out_specs=(P(), P()))


# -- fleet-level scatter/gather ------------------------------------------------


# Gather-side work per scatter: collecting R×k candidate lists, the sort/merge
# in _merge_hits, and re-serialization at the coordinator. Constant and small,
# but charging it keeps end-to-end latency honest (B6/B7 were systematically
# optimistic without it).
MERGE_COST_S = 0.001


class GenerationMismatch(Exception):
    """A scatter's legs answered from DIFFERENT index generations.

    Merging such hits would be silently wrong — partition A scored under
    generation N's stats while partition B scored under N+1's (different
    idf/avgdl, different tombstones), so the merged ranking corresponds to
    no index that ever existed. The coordinator pins one generation per
    query precisely so this cannot happen; this guard turns any future
    regression (an unpinned payload, a handler ignoring the pin) into a
    loud failure instead of a subtly-torn result."""


@dataclasses.dataclass
class HedgePolicy:
    """When does a scatter leg deserve a backup on a replica?

    The decision is made AT DISPATCH from ``FaaSRuntime.probe``'s projection
    (queue wait + cold boot under the virtual clock) — not after waiting for
    the primary to run long, which would put the projected cold start itself
    on the critical path. A leg hedges when its projected overhead exceeds

    * ``after_s``, a fixed threshold, if set; otherwise
    * ``scale`` × the ``percentile`` quantile of the replica group's recent
      WARM latencies (``FaaSRuntime.latency_percentiles(group,
      warm_only=True)``), once at least ``min_history`` warm records exist.
      The default is 2× the MEDIAN, not a raw p95: with a handful of
      records one jit-compile or hydration spike IS the p95 and would quietly
      disarm hedging, while the median shrugs it off (the same robustness
      argument as tail-at-scale's "hedge after ~2× expected latency").

    With no fixed threshold and too little history the leg never hedges —
    the initial all-cold fan-out would otherwise double-bill every partition
    for backups that are just as cold as their primaries.
    """

    after_s: float | None = None
    percentile: float = 0.5
    scale: float = 2.0
    min_history: int = 4
    window: int = 256        # most-recent warm records considered

    @classmethod
    def from_cold_profile(cls, cold_overhead_s: float, warm_p50_s: float,
                          **kw) -> "HedgePolicy":
        """Derive ``scale`` from a measured cold profile.

        The 2× default encodes the FULL-hydration regime, where a cold leg
        costs ~10-20× a warm query and any projected overhead past 2× warm
        is worth a backup. Lazy hydration shrinks the cold penalty several
        fold (B13 measures it), which moves the break-even: hedging a leg
        whose worst case is only a few warm-medians buys little latency for
        a guaranteed double bill. The rule — backup when projected overhead
        exceeds about a TENTH of the cold penalty, expressed in warm
        medians, clamped to [1.25, 4]:

            scale = clamp(1 + cold_overhead_s / (10 × warm_p50_s), 1.25, 4.0)

        Full profile (cold ≈ 0.47 s, warm ≈ 0.025 s) → scale ≈ 2.9; the
        lazy profile (cold ≈ 0.2 s) → scale ≈ 1.8 — hedging gets MORE eager
        per warm-median because a backup is now cheap to be wrong about.
        Defaults stay the full-regime 2.0; fleets opting into lazy
        hydration re-derive explicitly."""
        if warm_p50_s <= 0 or math.isnan(warm_p50_s):
            return cls(**kw)
        scale = min(4.0, max(1.25, 1.0 + cold_overhead_s / (10.0 * warm_p50_s)))
        return cls(scale=scale, **kw)

    def threshold_s(self, runtime, group: Sequence[str]) -> float | None:
        """The projected-overhead threshold for this group, or None if the
        policy has no basis to hedge yet.

        One newest-first scan of the record log
        (``FaaSRuntime.recent_latencies``), stopping at ``window`` matches —
        "recent" by construction, per-query work bounded instead of growing
        with the run length, and the SAME windowing the fleet controller
        reads its warm quantiles through (``latency_percentiles(...,
        window=...)``): hedging and scaling must judge one latency regime,
        not hedge on recent behaviour while scaling on stale history."""
        if self.after_s is not None:
            return self.after_s
        warm = runtime.recent_latencies(group, warm_only=True,
                                        window=self.window)
        if len(warm) < self.min_history:
            return None
        q = nearest_rank_percentiles(warm, qs=(self.percentile,))
        return self.scale * q[self.percentile]


@dataclasses.dataclass
class PartitionHit:
    doc_id: int              # partition-LOCAL internal id
    score: float
    partition: int
    ext_id: str | None = None


def _merge_hits(per_part: list[dict], k: int) -> list[PartitionHit]:
    """Merge one query's per-partition result dicts into global top-k.

    Ties break by (partition, local id) — i.e. ascending global id under
    contiguous partitioning, matching the oracle's ordering."""
    hits: list[PartitionHit] = []
    for p, result in enumerate(per_part):
        ext = result.get("ext_ids") or [None] * len(result["ids"])
        for doc_id, score, e in zip(result["ids"], result["scores"], ext):
            hits.append(PartitionHit(int(doc_id), float(score), p, e))
    hits.sort(key=lambda h: (-h.score, h.partition, h.doc_id))
    return hits[:k]


# Reciprocal Rank Fusion constant (Cormack et al. '09's k=60): large enough
# that a doc ranked ~60 in one tier cannot outvote a doc ranked first in the
# other, small enough that agreement across tiers still dominates.
RRF_C = 60.0


def rrf_fuse(rankings: Sequence[Sequence[Any]], k: int, *,
             c: float = RRF_C) -> list[tuple[Any, float]]:
    """Reciprocal Rank Fusion over ranked key lists →
    top-k ``[(key, score)]`` with ``score = Σ_tiers 1 / (c + rank)``
    (rank is 1-based; a key absent from a tier contributes nothing).

    Rank-only fusion is what makes hybrid merge sound across tiers whose
    scores live on incomparable scales (BM25 impacts vs inner products).
    Deterministic by construction: ties break ascending on the key, and a
    key's per-tier contributions accumulate in tier order — the fleet
    coordinator and the oracle fusion call THIS function with tiers in the
    same (sparse, dense) order, so their fused floats are bit-identical,
    not merely close."""
    scores: dict[Any, float] = {}
    for ranking in rankings:
        for rank, key in enumerate(ranking, start=1):
            scores[key] = scores.get(key, 0.0) + 1.0 / (c + rank)
    fused = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    return fused[:k]


# -- the fleet's typed assembly spec ------------------------------------------
#
# ``build_partitioned_search_app`` grew one keyword per PR until it was a
# 12-kwarg sprawl; these dataclasses are the redesigned surface. Groups
# mirror the fleet's actual seams — who serves (replication), how requests
# enter (gateway), what is served (index, including the dense-vector tier),
# and the runtime/search knobs. Validation happens ONCE at construction
# (``FleetSpec.__post_init__``), not scattered through assembly code.
# Imports are type-only (``TYPE_CHECKING``): core.autoscale imports this
# module, so the spec duck-types its policy fields at runtime.


@dataclasses.dataclass
class ReplicationSpec:
    """Who serves each partition: pool count, hedging, autoscaling."""

    replicas: int = 1
    # HedgePolicy, or a float shorthand for a fixed after_s threshold
    hedge: "HedgePolicy | float | None" = None
    # AutoscalePolicy, or True for defaults (resolved at assembly — the
    # policy class lives in core.autoscale, which imports this module)
    autoscale: "AutoscalePolicy | bool | None" = None
    # when a partition leg exhausts its retries: True merges the surviving
    # partitions' hits (a degraded but fast answer, flagged in the result);
    # False (default) surfaces the typed 503 — correctness over availability
    degraded_ok: bool = False

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if isinstance(self.hedge, (int, float)) and not isinstance(
                self.hedge, bool):
            self.hedge = HedgePolicy(after_s=float(self.hedge))


@dataclasses.dataclass
class GatewaySpec:
    """How requests enter: admission window + scatter routing."""

    window: "WindowPolicy | None" = None
    routing: str | None = None     # None → "aware" iff autoscaling, "static" else

    def __post_init__(self) -> None:
        if self.routing not in (None, "static", "aware"):
            raise ValueError("routing must be None, 'static' or 'aware', "
                             f"got {self.routing!r}")


@dataclasses.dataclass
class VectorSpec:
    """The dense-vector tier: embedding shape + storage + embedder.

    ``embedder`` maps text → (dim,) f32; None resolves to the deterministic
    ``repro_torch.data.corpus.hash_embedder(dim)`` at assembly. The same embedder
    derives doc vectors at indexing time and query vectors at the
    coordinator, so a text query needs no client-side vector."""

    dim: int = 16
    dtype: str = "float32"         # "float32" | "int8" (scalar-quantized)
    embedder: "Callable[[str], Any] | None" = None

    def __post_init__(self) -> None:
        if self.dim < 1:
            raise ValueError(f"vector dim must be >= 1, got {self.dim}")
        if self.dtype not in ("float32", "int8"):
            raise ValueError("vector dtype must be 'float32' or 'int8', "
                             f"got {self.dtype!r}")


@dataclasses.dataclass
class IndexSpec:
    """What is served: the document split, compaction policy, dense tier,
    and the structured (format-v2) tier.

    ``structured=True`` packs every segment in format v2 — per-posting
    stored occurrences, per-field lengths, and per-doc values for each
    ``facet_fields`` entry — which is what lets the fleet serve fielded
    scoring, positional phrases, facets, and snippets (``sq``/``sqs``
    bodies). Declaring any ``facet_fields`` implies ``structured``.
    Fleets that leave both defaulted publish byte-identical v1 segments
    and reject structured queries at admission (HTTP 400)."""

    partition_weights: "list[float] | None" = None
    merge_policy: "MergePolicy | None" = None
    vector: VectorSpec | None = None
    asset_prefix: str = "index"
    structured: bool = False
    facet_fields: "tuple[str, ...] | list[str]" = ()

    def __post_init__(self) -> None:
        self.facet_fields = tuple(self.facet_fields)
        self.structured = self.structured or bool(self.facet_fields)


@dataclasses.dataclass
class FleetSpec:
    """The whole fleet, validated at construction.

    ``build_partitioned_search_app(docs, FleetSpec(...))`` replaces the
    legacy kwarg sprawl (which still works through a deprecation shim)."""

    n_parts: int = 4
    replication: ReplicationSpec = dataclasses.field(
        default_factory=ReplicationSpec)
    gateway: GatewaySpec = dataclasses.field(default_factory=GatewaySpec)
    index: IndexSpec = dataclasses.field(default_factory=IndexSpec)
    runtime_config: "RuntimeConfig | None" = None
    search_config: "SearchConfig | None" = None
    backend: "Backend | None" = None

    def __post_init__(self) -> None:
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        w = self.index.partition_weights
        if w is not None:
            if len(w) != self.n_parts:
                raise ValueError(
                    f"partition_weights has {len(w)} entries for "
                    f"{self.n_parts} partitions")
            if any(x <= 0 for x in w):
                raise ValueError("partition_weights must be positive")


class ScatterGather:
    """Fan a query out to one FaaS function per partition and merge hits.

    Each entry of ``fn_names`` is either one function name (unreplicated
    partition) or a replica GROUP ``[primary, backup, ...]`` — every member
    serves the same published segment from its own instance pool. With a
    :class:`HedgePolicy`, a leg whose primary projects a completion past the
    policy threshold fires a backup on the group's best-projected replica at
    the same arrival instant; the first completion wins (bit-identical
    results either way) and both legs bill.

    ``routing`` picks the primary per dispatch:

    * ``"static"`` (default): the group's first member is
      always primary; replicas only ever see hedge traffic.
    * ``"aware"``: the primary ROTATES to the member with the best projected
      overhead (``FaaSRuntime.probe``) plus a penalty per recent
      ``kill_instance`` event in its pool — so after a pool loses an
      instance, the next queries route around it instead of hedging against
      it, and a backup leg never lands on the same struggling pool the
      policy is trying to escape. Ties break by group order, keeping
      dispatch deterministic (results are bit-identical either way: every
      member serves the same ``PackedIndex``).

    Groups are MUTABLE: a fleet controller may :meth:`add_replica` /
    :meth:`remove_replica` between dispatches to scale a partition's
    capacity against the cost ledger — the published segment never moves.
    """

    def __init__(self, runtime, fn_names: Sequence, *,
                 hedge: "HedgePolicy | None" = None,
                 merge_cost_s: float = MERGE_COST_S,
                 routing: str = "static",
                 kill_window_s: float = 30.0,
                 degraded_ok: bool = False) -> None:
        if routing not in ("static", "aware"):
            raise ValueError(f"routing must be 'static' or 'aware', got {routing!r}")
        self.runtime = runtime
        self.groups: list[list[str]] = [
            [g] if isinstance(g, str) else list(g) for g in fn_names]
        self.fn_names = [g[0] for g in self.groups]   # base primaries
        self.hedge = hedge
        self.merge_cost_s = merge_cost_s
        self.routing = routing
        self.kill_window_s = kill_window_s
        self.degraded_ok = degraded_ok
        self.last_versions: list[str] = []   # index versions of the last scatter
        self.last_degraded: list[int] = []   # partitions dropped (degraded_ok)

    # -- mutable replica groups (the autoscaler's levers) ---------------------

    def add_replica(self, partition: int, fn: str) -> None:
        """Grow ``partition``'s group with an already-registered function
        serving the same segment (scale-up: new pool, same asset)."""
        group = self.groups[partition]
        if fn in group:
            raise ValueError(f"{fn!r} already in partition {partition}'s group")
        group.append(fn)

    def remove_replica(self, partition: int, fn: str) -> None:
        """Shrink ``partition``'s group (scale-down). The last member can
        never be removed — a partition must keep one serving pool, or the
        fan-out would silently drop its documents from every result."""
        group = self.groups[partition]
        if fn not in group:
            raise ValueError(f"{fn!r} not in partition {partition}'s group")
        if len(group) == 1:
            raise ValueError(
                f"cannot remove {fn!r}: partition {partition}'s last replica")
        group.remove(fn)

    # -- dispatch -------------------------------------------------------------

    def _projected_overhead(self, fn: str, t0: float) -> float:
        return sum(self.runtime.probe(fn, t0))

    def _choose_primary(self, group: list[str], t0: float) -> str:
        """Pick this dispatch's primary. Aware routing scores each member by
        projected overhead plus one cold boot per recent kill in its pool
        (a kill the probe can't see yet — e.g. a pool with surviving idle
        instances — still deserves suspicion), lowest score wins."""
        if self.routing != "aware" or len(group) == 1:
            return group[0]
        provision = self.runtime.config.provision_s

        def score(fn: str) -> float:
            kills = self.runtime.recent_kills(
                fn, now=t0, window_s=self.kill_window_s)
            return self._projected_overhead(fn, t0) + provision * kills

        return min(enumerate(group), key=lambda p: (score(p[1]), p[0]))[1]

    def _invoke_leg(self, group: list[str], payload: Any, t0: float):
        """One partition leg: primary, plus a projection-triggered backup."""
        primary = self._choose_primary(group, t0)
        rest = [f for f in group if f != primary]
        if self.hedge is not None and rest:
            thresh = self.hedge.threshold_s(self.runtime, group)
            if thresh is not None:
                projected = self._projected_overhead(primary, t0)
                if projected > thresh:
                    backup = min(rest,
                                 key=lambda f: self._projected_overhead(f, t0))
                    # a replica projecting no better than the primary (both
                    # cold, or its queue just as deep) cannot win the race —
                    # firing it would double-bill for zero latency gain
                    if self._projected_overhead(backup, t0) < projected:
                        return self.runtime.invoke_hedged(
                            primary, backup, payload, t_arrival=t0)
        return self.runtime.invoke(primary, payload, t_arrival=t0)

    def scatter(self, payload: Any, *, t_arrival: float | None = None):
        """Invoke every partition leg at the SAME arrival instant.

        Partitions execute concurrently on separate instances, so every
        fan-out leg sees the fleet as it was at t_arrival — the runtime's
        shared virtual clock advances only after the whole scatter — and
        end-to-end latency is the max over partitions plus the gather/merge
        term ``merge_cost_s`` (charged identically on the single-query and
        batched paths). Returns (per-partition results, latency_s, records).

        A leg whose retries run out (:class:`~repro_torch.core.runtime.
        RetriesExhausted`) either aborts the whole scatter (``degraded_ok=
        False`` — the gateway maps it to a typed 503) or, with
        ``degraded_ok=True``, is replaced by an EMPTY result so the
        surviving partitions still merge: a degraded answer, recorded in
        ``last_degraded``, never a silently-partial one masquerading as
        complete. If every leg dies there is nothing to degrade TO, and the
        first leg's error propagates."""
        t0 = self.runtime.clock if t_arrival is None else t_arrival
        results, records = [], []
        self.last_degraded = []
        first_err: RetriesExhausted | None = None
        for p, group in enumerate(self.groups):
            try:
                result, rec = self._invoke_leg(group, payload, t0)
            except RetriesExhausted as e:
                if not self.degraded_ok:
                    raise
                first_err = first_err or e
                self.last_degraded.append(p)
                results.append(self._degraded_result(payload))
                continue
            results.append(result)
            records.append(rec)
        if first_err is not None and not records:
            raise first_err             # nothing survived to answer from
        self._check_generations(results)
        lat = max((r.latency_s for r in records), default=0.0)
        return results, lat + self.merge_cost_s, records

    @staticmethod
    def _empty_hits() -> dict:
        return {"ids": [], "scores": [], "ext_ids": [],
                "dense": {"ids": [], "scores": [], "ext_ids": []}}

    def _degraded_result(self, payload: Any) -> dict:
        """A well-formed empty stand-in for a dead leg: contributes no hits
        to the merge and no version to the generation check (the dead leg
        answered from NO generation)."""
        if isinstance(payload, dict) and "queries" in payload:
            return {"results": [self._empty_hits()
                                for _ in payload["queries"]]}
        return self._empty_hits()

    def _check_generations(self, results: list) -> None:
        """Every leg that reports an index version must report the SAME one
        — hedged replicas and freshly-scaled pools included, and BOTH tiers
        of a hybrid leg (``vec_version`` is the dense tier's): a sparse
        tier at generation N fused with a dense tier at N+1 would rank
        under two different tombstone sets in one result. See
        :class:`GenerationMismatch`."""
        versions = set()
        for r in results:
            if not isinstance(r, dict):
                continue
            if "version" in r:
                versions.add(r["version"])
            if "vec_version" in r:
                versions.add(r["vec_version"])
        self.last_versions = sorted(versions)
        if len(versions) > 1:
            raise GenerationMismatch(
                f"scatter legs answered from {sorted(versions)} — a query "
                "may never merge hits across index generations (nor across "
                "tiers of different generations)")

    def search(self, payload: Any, k: int, *, t_arrival: float | None = None):
        """Single-query scatter-gather: merged top-k hits."""
        results, lat, records = self.scatter(payload, t_arrival=t_arrival)
        return _merge_hits(results, k), lat, records

    def search_batch(self, payload: Any, k: int, *,
                     t_arrival: float | None = None):
        """Micro-batched scatter-gather: ``payload["queries"]`` is a list;
        every partition evaluates the whole batch in one invocation and the
        per-query candidate sets merge independently. Returns
        (list of per-query top-k hit lists, latency_s, records)."""
        results, lat, records = self.scatter(payload, t_arrival=t_arrival)
        n_q = len(payload["queries"])
        merged = [
            _merge_hits([r["results"][qi] for r in results], k)
            for qi in range(n_q)
        ]
        return merged, lat, records
