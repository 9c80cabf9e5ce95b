"""Document-partitioned BM25 query evaluation over a mesh — the port of
``repro/search/distributed.py``.

Paper §3: "separate Lambda instances are assigned to different partitions of
the document collection. Given the prototype presented here, building out
this design is mostly a matter of software engineering." — here it is, as a
shard_map program: every partition of the mesh owns one document
partition's packed index arrays (leading partition axis sharded over the
whole mesh); a query fans out to all partitions, each evaluates BM25 locally
(the SAME scoring core, ``repro_torch.search.bm25.score_dense``, as the
single-partition searcher), and the k·P survivors are all-gathered and
merged — the scatter-gather of repro_torch.core.partition, on-device.

The mesh (:mod:`repro_torch.parallel.compat`) is either a ``torch.distributed``
world, one partition per rank, or every partition stacked on one card, the
partitions folded into the batch of one scoring call. Both run the one body
below and give the same bits. Every top-k is K2's (the local top-k over
(P·Q, n_docs_local) and one merge of the (Q, k·P) gathered survivors),
ties to the lower position in the gathered row, as ``lax.top_k``.

This module contains no BM25 math and no packing code of its own: scoring
lives in ``search/bm25.py``, impact-ordered block packing in
``index/builder.py`` (one ``IndexWriter`` per partition with global stats),
and this file only wires partitions to mesh axes.

idf is GLOBAL (computed over the whole corpus before partitioning), matching
a correctly-built distributed index; doc ids return globally offset.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.partition import local_topk, merge_topk
from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P
from repro_torch.search.bm25 import SearchState, _pad_k, score_dense, score_pruned


# Gathered postings (query rows × T × M × B) one scoring call of the body
# takes: the plain core holds ~64 B of temporaries a posting, so a stacked
# mesh's partitions go through it this many at a time (one card, 2^27 ≈ 8 GB).
POSTINGS_PER_CALL = 1 << 27


@dataclasses.dataclass(frozen=True)
class DistSearchConfig:
    """Static geometry of the partitioned index (per partition)."""

    n_parts: int             # total partitions = product of mesh axes used
    n_docs_local: int
    n_blocks_local: int      # NB per partition
    vocab: int
    block: int = 128
    max_terms: int = 16
    max_blocks: int = 32     # impact-ordered truncation per term
    k: int = 100
    accumulator: str = "dense"  # "dense" | "pruned" (block-max WAND)
    compact_ids: bool = False   # uint16 partition-local doc ids (perf)
    fused_gather: bool = False  # one all-gather over (data,model) vs two


def abstract_dist_state(cfg: DistSearchConfig) -> dict:
    """``meta``-device stand-ins for the partitioned index arrays."""
    if cfg.compact_ids and cfg.n_docs_local >= 65535:
        raise ValueError("compact_ids needs n_docs_local < 2^16 - 1")
    Pn, NB, B = cfg.n_parts, cfg.n_blocks_local, cfg.block
    did = torch.uint16 if cfg.compact_ids else torch.int32

    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "term_offsets": S((Pn, cfg.vocab + 1), torch.int32),
        "block_docs": S((Pn, NB, B), did),
        "block_tf": S((Pn, NB, B), torch.uint8),
        "block_max": S((Pn, NB), torch.float32),
        "doc_len": S((Pn, cfg.n_docs_local + 1), torch.float32),
        "idf": S((cfg.vocab,), torch.float32),
        "params": S((3,), torch.float32),          # k1, b, avgdl
    }


def dist_state_specs(axes: tuple[str, ...]) -> dict:
    part = axes[0] if len(axes) == 1 else tuple(axes)
    return {
        "term_offsets": P(part, None),
        "block_docs": P(part, None, None),
        "block_tf": P(part, None, None),
        "block_max": P(part, None),
        "doc_len": P(part, None),
        "idf": P(None),
        "params": P(None),
    }


def stacked_search_state(parts: dict, idf: torch.Tensor, params: torch.Tensor,
                         cfg: DistSearchConfig) -> SearchState:
    """The scoring core's stacked state over L partitions' arrays (``parts``:
    term_offsets (L, V+1), block_docs/block_tf (L, NB, B), block_max (L, NB),
    doc_len (L, n_docs_local+1)) and the shared idf and (k1, b, avgdl)."""
    return SearchState(
        term_offsets=parts["term_offsets"], block_docs=parts["block_docs"],
        block_tf=parts["block_tf"], block_max=parts["block_max"],
        doc_len=parts["doc_len"], idf=idf,
        avgdl=params[2], k1=params[0], b=params[1],
        n_docs=cfg.n_docs_local,
        params=_host_params(params),
    )


def _host_params(params: torch.Tensor) -> tuple:
    """(k1, b, avgdl) on the host, read back once; on meta tensors (the dry
    run's trace, which holds no values) the three 0-d meta tensors, which
    only a wrapper's shape rule receives."""
    if params.device.type == "meta":
        return tuple(params.unbind())
    return tuple(params.tolist())


def partitions_per_call(cfg: DistSearchConfig, Q: int, T: int) -> int:
    """Partitions of a stacked body that one scoring call takes."""
    return max(1, POSTINGS_PER_CALL // (Q * T * cfg.max_blocks * cfg.block))


def _local_search(state: dict, term_ids, qtf, cfg: DistSearchConfig,
                  axes: tuple[str, ...]):
    """Per-partition body: local BM25 over each partition held here (the
    leading L) and its top-k survivors, (L, Q, k) values and global ids.

    The scoring itself is the unified core (``bm25.score_dense``) applied to
    the partitions' slices, stacked: the query rows of
    :func:`partitions_per_call` partitions go through one call,
    partition-major. Each row takes the same steps in any grouping, so the
    bits do not depend on it. Only the global-id offset is mesh-specific.
    """
    L, Q, T = term_ids.shape
    pid = compat.flat_axis_index(axes)             # (L,) flattened partition ids
    per = partitions_per_call(cfg, Q, T)
    out = [_score_partitions(
        stacked_search_state({k: v[lo:lo + per, 0] for k, v in state.items()
                              if k not in ("idf", "params")},
                             state["idf"][0], state["params"][0], cfg),
        term_ids[lo:lo + per], qtf[lo:lo + per], pid[lo:lo + per], cfg)
        for lo in range(0, L, per)]
    return torch.cat([v for v, _ in out]), torch.cat([i for _, i in out])


def _score_partitions(local: SearchState, term_ids, qtf, pid, cfg: DistSearchConfig):
    """(L, Q, T) queries against a stacked state of L partitions → their
    (L, Q, k) top-k values and global ids."""
    L, Q, T = term_ids.shape
    tids = term_ids.reshape(L * Q, T)
    w = qtf.reshape(L * Q, T)
    base = (pid * cfg.n_docs_local).to(torch.int32).view(L, 1, 1)
    if cfg.accumulator == "pruned":
        # block-max pruned local scoring: top-k comes straight out of
        # score_pruned (K2 over the pruned accumulator — same tie order as
        # local_topk over the dense accumulator, and bit-identical scores
        # since pruning only skips blocks that cannot enter top-k)
        kk = min(cfg.k, cfg.n_docs_local)
        lv, li, _ = score_pruned(local, tids, w, max_blocks=cfg.max_blocks, k=kk,
                                 use_topk_kernel=True)
        lv, li = _pad_k(lv, li, cfg.k, cfg.n_docs_local)   # pad to the (Q, k) merge
        lv = lv.view(L, Q, cfg.k)
        li = base + li.view(L, Q, cfg.k)
    else:
        scores = score_dense(local, tids, w, max_blocks=cfg.max_blocks)
        scores = scores.view(L, Q, cfg.n_docs_local)
        ids = base + torch.arange(cfg.n_docs_local, dtype=torch.int32, device=scores.device)
        lv, li = local_topk(scores, ids, cfg.k)
    return lv, li


def gather_axes(axes: tuple[str, ...], fused: bool) -> tuple[str, ...]:
    """The mesh axes, row-major, along which the survivors' all-gather lays
    partitions out: one collective over ``axes`` (fused), or one per axis,
    the first named innermost (hierarchical: on a (4, 2) ("data", "model")
    mesh the partitions come out 0, 2, 4, 6, 1, 3, 5, 7)."""
    return tuple(axes) if fused else tuple(reversed(axes))


def make_dist_search_fn(cfg: DistSearchConfig,
                        axes: tuple[str, ...] = ("data", "model"),
                        mesh: "compat.Mesh | None" = None):
    """Build the shard_map'd global search fn.

    fn(state, term_ids (Q,T) i32, qtf (Q,T) f32) -> (scores (Q,k), ids (Q,k)),
    replicated, on the mesh's device. Either pass ``mesh`` explicitly, or
    enter one via ``compat.use_mesh``; the mesh extent over `axes` must
    equal cfg.n_parts — one partition per mesh position.

    The body's (Q, k) survivors leave the shard_map concatenated over the
    partitions (its out-spec is the all-gather: on a rank mesh one
    collective, or one per axis, as ``cfg.fused_gather`` says), and one
    K2 merge of the (Q, k·P) gathered row follows, the same on every
    process — on a stacked mesh once, not once a partition."""
    sspecs = dist_state_specs(axes)
    body = functools.partial(_local_search, cfg=cfg, axes=axes)
    gathered = P(None, gather_axes(axes, cfg.fused_gather))
    inner = compat.shard_map(
        body, mesh,
        in_specs=(sspecs, P(None, None), P(None, None)),
        out_specs=(gathered, gathered),
    )

    def _check_extent(shape: dict) -> None:
        n_dev = 1
        for ax in axes:
            n_dev *= shape[ax]
        if cfg.n_parts != n_dev:
            raise ValueError(
                f"DistSearchConfig.n_parts={cfg.n_parts} must equal the mesh "
                f"extent over {axes} ({n_dev}) — one partition per device")

    def fn(state, term_ids, qtf):
        m = mesh if mesh is not None else compat.ambient_mesh()
        if m is not None:                 # else compat.shard_map raises
            _check_extent(m.shape)
        gv, gi = inner(state, torch.as_tensor(term_ids, dtype=torch.int32),
                       torch.as_tensor(qtf, dtype=torch.float32))
        return merge_topk(gv, gi, cfg.k)

    return fn


# -- host-side partitioned build (real arrays, for tests/examples) ----------------


def partition_corpus(docs: list[tuple[str, str]], n_parts: int,
                     weights: "list[float] | None" = None):
    """Contiguous-chunk document partitioning; returns per-partition doc
    lists plus ``per``, the uniform per-partition size (global id =
    part * per + local id — the mesh path's id map).

    ``weights`` skews the split: partition ``p`` receives a share of the
    corpus proportional to ``weights[p]`` (largest-remainder rounding, so
    sizes sum exactly to the corpus). This is how a benchmark builds the
    Zipf-skewed fleet real collections look like — a head partition with
    most of the documents, a long cold tail — while every partition still
    packs against the same global stats. Weighted splits have no uniform
    ``per``; the returned ``per`` is the LARGEST partition (the fleet app
    maps global ids through actual per-partition offsets, never ``per``,
    whenever an indexer is attached — i.e. always)."""
    if weights is None:
        per = -(-len(docs) // n_parts)
        return [docs[p * per: (p + 1) * per] for p in range(n_parts)], per
    if len(weights) != n_parts or any(w < 0 for w in weights) \
            or sum(weights) <= 0:
        raise ValueError(f"need {n_parts} nonnegative weights with a "
                         f"positive sum, got {weights!r}")
    total = float(sum(weights))
    quotas = [len(docs) * w / total for w in weights]
    sizes = [int(q) for q in quotas]
    # largest remainder: hand leftover docs to the most-shortchanged parts
    for p in sorted(range(n_parts), key=lambda p: quotas[p] - sizes[p],
                    reverse=True)[: len(docs) - sum(sizes)]:
        sizes[p] += 1
    parts, at = [], 0
    for n in sizes:
        parts.append(docs[at: at + n])
        at += n
    return parts, max(sizes)


def stack_partitions(packs: list, n_docs_local: int,
                     cfg_hint: dict | None = None, *,
                     device=None) -> tuple[dict, "DistSearchConfig"]:
    """PackedIndex-per-partition → stacked partitioned-state adapter.

    Stacks per-partition :class:`repro_torch.index.builder.PackedIndex`
    arrays (all built against one global vocab + global stats) along a
    leading partition axis, padding each partition's blocks/doc_len to the
    common NB / n_docs_local extents. Padding entries carry tf=0 so the
    scoring core masks them; the packing itself (impact ordering, block
    layout, BM25 constants) has exactly one source of truth:
    ``IndexWriter.pack``. The state's tensors land on ``device`` (the card
    when None).
    """
    dev = resolve_device(device)
    hint = cfg_hint or {}
    V = packs[0].term_offsets.shape[0] - 1
    B = packs[0].meta.block
    m0 = packs[0].meta
    for p in packs[1:]:       # packs must share vocab + global BM25 stats,
        m = p.meta            # or partition 0's idf/params silently win
        if (p.term_offsets.shape[0] - 1 != V or m.block != B
                or (m.k1, m.b, m.avgdl) != (m0.k1, m0.b, m0.avgdl)
                or not np.array_equal(p.idf, packs[0].idf)):
            raise ValueError(
                "heterogeneous partition packs — build every partition with "
                "the same IndexWriter(vocab=global_vocab(stats), "
                "global_stats=stats)")
    NB = max(max(p.meta.n_blocks for p in packs), 1)
    compact = bool(hint.get("compact_ids")) and n_docs_local < 65535
    did = np.uint16 if compact else np.int32

    block_docs = np.stack([
        np.concatenate([
            p.block_docs,
            np.full((NB - p.meta.n_blocks, B), p.meta.n_docs, np.int32)])
        for p in packs]).astype(did)
    block_tf = np.stack([
        np.concatenate([
            p.block_tf, np.zeros((NB - p.meta.n_blocks, B), np.uint8)])
        for p in packs])
    block_max = np.stack([
        np.concatenate([
            np.asarray(p.block_max, np.float32),
            np.zeros(NB - p.meta.n_blocks, np.float32)])
        for p in packs])
    doc_len = np.ones((len(packs), n_docs_local + 1), np.float32)
    for i, p in enumerate(packs):
        doc_len[i, :p.meta.n_docs] = p.doc_len[:p.meta.n_docs]

    meta = packs[0].meta
    state = {
        "term_offsets": np.stack([p.term_offsets for p in packs]),
        "block_docs": block_docs,
        "block_tf": block_tf,
        "block_max": block_max,
        "doc_len": doc_len,
        "idf": np.asarray(packs[0].idf),   # global stats ⇒ identical per part
        "params": np.asarray([meta.k1, meta.b, meta.avgdl], np.float32),
    }
    state = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in state.items()}
    cfg = DistSearchConfig(
        n_parts=len(packs), n_docs_local=n_docs_local, n_blocks_local=NB,
        vocab=V, block=B, k=hint.get("k", 10),
        accumulator=hint.get("accumulator", "dense"),
        max_terms=hint.get("max_terms", 16),
        max_blocks=hint.get("max_blocks", 32),
        compact_ids=compact,
        fused_gather=bool(hint.get("fused_gather", False)))
    return state, cfg


def build_partitioned_state(docs: list[tuple[str, str]], n_parts: int,
                            cfg_hint: dict | None = None, *, device=None):
    """Build real partitioned arrays (small corpora — tests/examples).

    Per partition: one ``IndexWriter`` packing against the corpus-global
    vocab and ``compute_global_stats`` (idf/avgdl), then
    :func:`stack_partitions` adapts the PackedIndexes to the shard_map
    state layout. Returns (state dict of tensors on ``device``, the card
    when None; DistSearchConfig; vocab)."""
    from repro_torch.index.builder import (IndexWriter, compute_global_stats,
                                           global_vocab)

    dev = resolve_device(device)
    hint = cfg_hint or {}
    parts, per = partition_corpus(docs, n_parts)
    gstats = compute_global_stats(docs)
    vocab = global_vocab(gstats)
    packs = []
    for pdocs in parts:
        writer = IndexWriter(
            k1=hint.get("k1", 0.9), b=hint.get("b", 0.4),
            block=hint.get("block", 128),
            global_stats=gstats, vocab=vocab)
        writer.add_many(pdocs)
        packs.append(writer.pack())
    state, cfg = stack_partitions(packs, per, hint, device=dev)
    return state, cfg, vocab
