"""PyTorch BM25 query evaluation over the packed blocked index — the port of
``repro/search/bm25.py``.

Score-at-a-time evaluation, batched over a leading Q dimension (no vmap, no
Python loop over queries on the card):

* gather the first M (impact-ordered) blocks of each of the query's T terms,
* compute per-posting BM25 impacts (the K3 kernel, doc_len gather and
  mask fused in, or its twin),
* accumulate per-document scores:
    - ``dense``  : add into a (Q, n_docs+1) accumulator, one term at a time
                   in term order — the reference's flat scatter-add order,
                   deterministic on the card.
    - ``sorted`` : sort the (doc, impact) pairs and segment-sum with the
                   cummax prefix trick — memory scales with T·M·B.
    - ``pruned`` : block-max WAND — skip whole blocks whose score ceiling
                   cannot reach a k-th-best lower bound θ taken from the
                   always-scored first blocks (the K1 kernel, or a plain
                   path with the identical keep mask).
* top-k over accumulated scores (the K2 kernel, or a stable sort).

``pruned`` is BIT-identical to ``dense``: it only skips blocks that provably
cannot enter the top-k, and ties go to the lowest doc id as in
``lax.top_k``. ``torch.topk`` is never used: its tie order is unspecified.

A state may stack L partitions (the mesh path's, on one device): its query
rows then come partition-major, row r reading partition r // (R / L), each
row through the same operations as on that partition's own state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.index.builder import PackedIndex
from repro_torch.kernels import ref
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bm25_pruned import keep_mask


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if not a.flags.writeable:       # segment arrays are read-only views
        a = a.copy()
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass
class SearchState:
    """Device-resident index tensors (the hydrated 'warm' state), the
    reference's dtypes and shapes on one device. A stacked state holds L
    partitions' ``term_offsets`` (L, V+1), ``block_docs``/``block_tf`` (L,
    NB, B), ``block_max`` (L, NB) and ``doc_len`` (L, n_docs+1) under one
    ``idf`` and one set of scalars."""

    term_offsets: torch.Tensor   # (V+1,) int32
    block_docs: torch.Tensor     # (NB, B) int32 (uint16 when compact)
    block_tf: torch.Tensor       # (NB, B) uint8
    block_max: torch.Tensor      # (NB,) float32 — per-block max impact
    doc_len: torch.Tensor        # (n_docs+1,) float32
    idf: torch.Tensor            # (V,) float32
    avgdl: torch.Tensor          # () float32
    k1: torch.Tensor             # () float32
    b: torch.Tensor              # () float32
    n_docs: int
    params: tuple[float, float, float]   # (k1, b, avgdl) as f32 values, host-side

    @classmethod
    def from_packed(cls, idx: PackedIndex, device=None) -> "SearchState":
        """A :class:`PackedIndex` of numpy arrays (from either package's
        builder: the layout is the same) → tensors on ``device`` (the card
        when None)."""
        dev = resolve_device(device)
        m = idx.meta
        scalars = [np.float32(x) for x in (m.k1, m.b, m.avgdl)]
        k1, b, avgdl = (torch.tensor(x, device=dev) for x in scalars)
        return cls(
            term_offsets=_tensor(idx.term_offsets, dev),
            block_docs=_tensor(idx.block_docs, dev),
            block_tf=_tensor(idx.block_tf, dev),
            block_max=_tensor(np.asarray(idx.block_max, np.float32), dev),
            doc_len=_tensor(idx.doc_len, dev),
            idf=_tensor(idx.idf, dev),
            avgdl=avgdl, k1=k1, b=b,
            n_docs=m.n_docs,
            params=tuple(float(x) for x in scalars),
        )

    @property
    def device(self) -> torch.device:
        return self.term_offsets.device

    @property
    def stacked(self) -> bool:
        return self.term_offsets.dim() == 2

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in (
            self.term_offsets, self.block_docs, self.block_tf, self.block_max,
            self.doc_len, self.idf, self.avgdl, self.k1, self.b))


def gather_query_blocks(state: SearchState, term_ids: torch.Tensor, max_blocks: int):
    """Gather (Q, T, M) block indices + validity for a batch of queries.

    term_ids: (Q, T) int32, -1 = pad. Returns docs (Q,T,M,B) int32, tf
    (Q,T,M,B) u8, bmax (Q,T,M) f32 (0 where invalid), valid (Q,T,M,1) bool.
    Invalid rows alias block 0 (with validity false), as in the reference;
    on a stacked state, block 0 of the row's own partition.
    """
    tid = torch.clamp(term_ids, min=0).long()
    offsets, docs_t, tf_t, bmax_t = (state.term_offsets, state.block_docs, state.block_tf,
                                     state.block_max)
    first = None
    if state.stacked:
        part = _row_parts(state, term_ids.shape[0])[:, None]    # (Q, 1)
        tid = (part * offsets.shape[1] + tid).view(-1)
        first = (part * docs_t.shape[1])[..., None]             # (Q, 1, 1)
        offsets, docs_t, tf_t, bmax_t = (offsets.flatten(), docs_t.flatten(0, 1),
                                         tf_t.flatten(0, 1), bmax_t.flatten())
    off = offsets[tid].view(term_ids.shape)                     # (Q, T)
    n_blk = offsets[tid + 1].view(term_ids.shape) - off         # (Q, T)
    m = torch.arange(max_blocks, dtype=torch.int32, device=term_ids.device)
    blk = off[..., None] + m                                    # (Q, T, M)
    valid = (m < n_blk[..., None]) & (term_ids[..., None] >= 0)
    blk = torch.where(valid, blk, 0).long()
    if first is not None:
        blk = blk + first
    docs = docs_t[blk]                                          # (Q, T, M, B)
    if docs.dtype != torch.int32:      # compact uint16 ids widen here
        docs = docs.to(torch.int32)
    tf = tf_t[blk]
    bmax = torch.where(valid, bmax_t[blk], 0.0)
    return docs, tf, bmax, valid[..., None]


def _row_parts(state: SearchState, rows: int) -> torch.Tensor:
    """(rows,) int64: the partition each query row of a stacked state reads."""
    L = state.term_offsets.shape[0]
    if rows % L:
        raise ValueError(f"{rows} query rows do not split over {L} stacked partitions")
    return torch.arange(rows, device=state.device) // (rows // L)


def _doc_len(state: SearchState, docs: torch.Tensor) -> torch.Tensor:
    """Each gathered posting's doc length (pads read the dump slot)."""
    d = torch.clamp(docs, max=state.n_docs).long()
    if not state.stacked:
        return state.doc_len[d]
    return torch.gather(state.doc_len, 1, d.reshape(state.doc_len.shape[0], -1)).view(d.shape)


def bm25_impacts(state: SearchState, term_ids: torch.Tensor, qtf: torch.Tensor,
                 docs: torch.Tensor, tf: torch.Tensor, valid: torch.Tensor,
                 *, use_kernel: bool = False) -> torch.Tensor:
    """Per-posting BM25 partial scores. (Q,T,M,B) float32. ``use_kernel``
    runs K3's fused entry point: the doc_len gather and the mask happen in
    its one launch, with the plain branch's bits."""
    tid = torch.clamp(term_ids, min=0).long()
    idf = state.idf[tid] * qtf                                  # (Q, T)
    if use_kernel:
        if state.stacked:
            raise ValueError("K3's fused call reads one partition's doc_len: a stacked "
                             "state takes use_kernel=False")
        return kops.bm25_block_impacts(tf, docs, valid, state.doc_len, idf, *state.params,
                                  state.n_docs)
    dl = _doc_len(state, docs)
    imp = ref.bm25_block_scores_ref(tf, dl, idf, state.k1, state.b, state.avgdl)
    pad = docs >= state.n_docs
    return torch.where(valid & ~pad & (tf > 0), imp, 0.0)


def score_dense(state: SearchState, term_ids: torch.Tensor, qtf: torch.Tensor,
                *, max_blocks: int, use_kernel: bool = False) -> torch.Tensor:
    """A batch's dense (Q, n_docs) BM25 scores — THE scoring core:
    gather → impacts → term-ordered dense accumulation."""
    docs, tf, _, valid = gather_query_blocks(state, term_ids, max_blocks)
    imp = bm25_impacts(state, term_ids, qtf, docs, tf, valid, use_kernel=use_kernel)
    return accumulate_dense(docs, imp, state.n_docs)


def pruned_keep(docs: torch.Tensor, imp: torch.Tensor, ub: torch.Tensor,
                valid: torch.Tensor, *, k: int, n_docs: int) -> torch.Tensor:
    """(Q, T, M) bool keep mask for block-max pruning — the plain twin of the
    mask the K1 kernel computes, sharing its θ and bound helpers. ``ub`` is
    (Q, T, M) ``qtf·block_max`` zeroed where invalid; ``imp`` the full
    impacts (only m = 0 is read); ``valid`` (Q, T, M, 1)."""
    return keep_mask(docs, imp, ub, valid[..., 0], k=k, n_docs=n_docs)


def score_pruned(state: SearchState, term_ids: torch.Tensor, qtf: torch.Tensor,
                 *, max_blocks: int, k: int, use_kernel: bool = False,
                 use_topk_kernel: bool = False):
    """A batch's block-max pruned top-k: (vals (Q,k), ids (Q,k) int32,
    touched (Q,) int32 = blocks actually scored). Requires k ≤ n_docs.

    ``use_kernel=True`` runs K1 (impacts + pruning + accumulation + top-k);
    otherwise the plain path zeroes skipped blocks' impacts before the
    dense accumulation — adding 0.0 is a bitwise no-op for these
    non-negative sums, so both equal the dense path for every top-k doc.
    """
    docs, tf, bmax, valid = gather_query_blocks(state, term_ids, max_blocks)
    tf = torch.where(valid, tf, 0)                # invalid rows alias block 0
    ub = torch.where(valid[..., 0], qtf[..., None] * bmax, 0.0)     # (Q, T, M)
    if use_kernel:
        tid = torch.clamp(term_ids, min=0).long()
        idf_q = state.idf[tid] * qtf                                 # (Q, T)
        dl = _doc_len(state, docs)
        return kops.bm25_pruned_topk(tf, dl, docs, idf_q, ub, valid[..., 0],
                                *state.params, k=k, n_docs=state.n_docs)
    imp = bm25_impacts(state, term_ids, qtf, docs, tf, valid)
    keep = pruned_keep(docs, imp, ub, valid, k=k, n_docs=state.n_docs)
    acc = accumulate_dense(docs, torch.where(keep[..., None], imp, 0.0), state.n_docs)
    if use_topk_kernel:
        vals, ids = kops.topk(acc, k)
    else:
        vals, ids = ref.topk_ref(acc, k)
    return vals, ids.to(torch.int32), keep.sum(dim=(1, 2), dtype=torch.int32)


# -- accumulation strategies ----------------------------------------------------


def accumulate_dense(docs: torch.Tensor, impacts: torch.Tensor, n_docs: int) -> torch.Tensor:
    """Add into a dense (Q, n_docs+1) accumulator, one term at a time in
    term order; the last slot is the dump. Returns the (Q, n_docs) view."""
    return ref.scatter_add_terms(docs, impacts, n_docs)[:, :n_docs]


def accumulate_sorted(docs: torch.Tensor, impacts: torch.Tensor, n_docs: int,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-and-segment-sum accumulation, returning top-k directly.

    The cummax prefix trick: after sorting pairs by doc id, the group total
    for the run ending at i is c[i] - p[start(i)] where c = inclusive cumsum
    and p = exclusive cumsum; p at group starts is recovered with a running
    max of p masked to starts (p is nondecreasing, impacts >= 0).
    """
    Q = docs.shape[0]
    d = docs.reshape(Q, -1)
    v = impacts.reshape(Q, -1)
    order = torch.argsort(d, dim=-1, stable=True)
    d = torch.gather(d, -1, order)
    v = torch.gather(v, -1, order)
    c = ref.cumsum_f32(v)
    p = c - v                                            # exclusive prefix
    change = d[:, 1:] != d[:, :-1]
    edge = torch.ones(Q, 1, dtype=torch.bool, device=d.device)
    is_start = torch.cat([edge, change], dim=1)
    is_end = torch.cat([change, edge], dim=1)
    start_p = torch.cummax(torch.where(is_start, p, float("-inf")), dim=-1).values
    totals = torch.where(is_end & (d < n_docs), c - start_p, float("-inf"))
    vals, pos = ref.topk_ref(totals, k)     # fewer postings than k: -inf pads
    finite = torch.isfinite(vals)
    pos = torch.clamp(pos, max=d.shape[1] - 1).long()
    ids = torch.where(finite, torch.gather(d, -1, pos), n_docs)
    vals = torch.where(finite, vals, 0.0)
    return vals, ids.to(torch.int32)


# -- end-to-end search fns -------------------------------------------------------


def _pad_k(vals: torch.Tensor, ids: torch.Tensor, k: int, n_docs: int):
    """Pad (Q, kk) results to the (Q, k) contract: vals 0, ids n_docs."""
    Q, kk = vals.shape
    if kk == k:
        return vals, ids.to(torch.int32)
    vals = torch.cat([vals, vals.new_zeros(Q, k - kk)], dim=1)
    ids = torch.cat([ids.to(torch.int32),
                     torch.full((Q, k - kk), n_docs, dtype=torch.int32, device=ids.device)],
                    dim=1)
    return vals, ids


def make_search_fn(n_docs: int, *, max_terms: int, max_blocks: int, k: int,
                   accumulator: str = "dense", use_kernel: bool = False,
                   use_topk_kernel: bool = False):
    """Build the stateless query-evaluation function (the 'Lambda body').

    Returns fn(state, term_ids (Q,T) int32, qtf (Q,T) f32) ->
    (scores (Q,k) f32, ids (Q,k) int32), tensors on the state's device;
    term_ids and qtf may be numpy arrays.
    """

    def search(state: SearchState, term_ids, qtf):
        dev = state.device
        term_ids = torch.as_tensor(term_ids, dtype=torch.int32).to(dev)
        qtf = torch.as_tensor(qtf, dtype=torch.float32).to(dev)
        if accumulator == "dense":
            acc = score_dense(state, term_ids, qtf, max_blocks=max_blocks,
                              use_kernel=use_kernel)
            kk = min(k, n_docs)          # a tiny partition may hold < k docs
            if use_topk_kernel:
                vals, ids = kops.topk(acc, kk)
            else:
                vals, ids = ref.topk_ref(acc, kk)
            return _pad_k(vals, ids, k, n_docs)
        elif accumulator == "sorted":
            docs, tf, _, valid = gather_query_blocks(state, term_ids, max_blocks)
            imp = bm25_impacts(state, term_ids, qtf, docs, tf, valid,
                               use_kernel=use_kernel)
            return accumulate_sorted(docs, imp, n_docs, k)
        elif accumulator == "pruned":
            kk = min(k, n_docs)          # θ needs "missing doc = score 0"
            vals, ids, _ = score_pruned(
                state, term_ids, qtf, max_blocks=max_blocks, k=kk,
                use_kernel=use_kernel, use_topk_kernel=use_topk_kernel)
            return _pad_k(vals, ids, k, n_docs)
        raise ValueError(f"unknown accumulator {accumulator!r}")

    return search


# -- host-side query encoding ------------------------------------------------------


def encode_queries(vocab: dict[str, int], queries: list[str], *,
                   max_terms: int,
                   idf: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize + map to term ids + qtf weights, padded to (Q, T).

    When a query has more than ``max_terms`` distinct terms, pass ``idf`` to
    keep the highest-idf (most selective) terms — long queries then degrade
    by shedding stopword-ish terms instead of whatever dict order gives.
    """
    from collections import Counter

    from repro_torch.index.tokenizer import tokenize

    Q = len(queries)
    tids = np.full((Q, max_terms), -1, dtype=np.int32)
    qtf = np.zeros((Q, max_terms), dtype=np.float32)
    for qi, q in enumerate(queries):
        counts = Counter(tokenize(q))
        items = [(vocab[t], c) for t, c in counts.items() if t in vocab]
        if idf is not None and len(items) > max_terms:
            items.sort(key=lambda tc: -float(idf[tc[0]]))
        items = items[:max_terms]
        for j, (tid, c) in enumerate(items):
            tids[qi, j] = tid
            qtf[qi, j] = c
    return tids, qtf
