"""K1: fused block-max pruned BM25 scoring + top-k — wrapper of
``csrc/bm25_pruned.cu``, the port of ``repro/kernels/bm25_pruned.py``.

A block (t, m) is skipped when its score ceiling

    bound(t, m) = qtf_t·block_max(t, m) + Σ_{t'≠t} qtf_{t'}·block_max(t', 0)

times ``PRUNE_SAFETY`` falls below θ, the k-th best per-doc total over
every term's always-scored first block. Every top-k doc keeps all of its
blocks, so the result equals the dense path bit for bit (the losslessness
argument of the reference module docstring).

On the card a call is four launches of one C entry point, and no
(Q, n_docs) array exists: ``pruned_theta_kernel`` (one block a query)
computes the first-block impacts, θ and the keep mask;
``pruned_count_kernel`` and ``pruned_scatter_kernel`` (one block a (query,
term)) bucket the kept postings by range of R docs and term;
``pruned_range_kernel`` (one block a (query, range)) accumulates its
bucket's impacts in shared memory, term by term, selects the range's top
k, and the query's last range block to finish merges the ranges'
survivors, which lie in id order. The bucket, (Q, T·M·B) entries of 8 B,
is the largest scratch in device memory. Where a query's T·P (term, range)
counts do not fit in one block's shared memory (64 terms over ~50M docs
and more), a fifth launch, ``pruned_starts_kernel``, scans them into the
bucket's starts in device memory and the scatter takes its cursors from
there.
:func:`repro_torch.kernels.ref.bm25_pruned_ranges_ref` is that algorithm
in plain PyTorch. The helpers below are the twin's θ and bounds, in the
same arithmetic order as the kernels.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import backend, ref

# Relative widening of the keep test (bound * PRUNE_SAFETY >= θ): absorbs
# float rounding between the builder's f64 block_max and the query-time f32
# impact sums.
PRUNE_SAFETY = 1.0 + 1e-4
MAX_SMEM = 227 * 1024
# Shared memory the count and scatter kernels may give their (term, range)
# counts or cursors; past it they go to device memory. All a block can
# have; the tests lower it to drive the device-memory paths at small sizes.
SMEM_BUDGET = MAX_SMEM


def theta_lower_bound(d: torch.Tensor, v: torch.Tensor, k: int,
                      n_docs: int) -> torch.Tensor:
    """(Q, L) postings (doc ids ``d``, impacts ``v``) → (Q,) k-th best per-doc
    total, a lower bound on the k-th best final score; 0 (prune nothing)
    when L < k. The reference's segment-sum: stable sort by doc, inclusive
    cumsum c, p = c − v, start_p = cummax of p at group starts, totals =
    c − start_p at group ends — with the cumsum in :func:`ref.cumsum_f32`'s
    pinned order, whose rounding θ (and so ``touched``) depends on."""
    Q, L = d.shape
    if L < k:
        return torch.zeros(Q, dtype=torch.float32, device=v.device)
    order = torch.argsort(d, dim=-1, stable=True)
    d = torch.gather(d, -1, order)
    v = torch.gather(v, -1, order)
    c = ref.cumsum_f32(v)
    p = c - v
    change = d[:, 1:] != d[:, :-1]
    edge = torch.ones(Q, 1, dtype=torch.bool, device=d.device)
    is_start = torch.cat([edge, change], dim=1)
    is_end = torch.cat([change, edge], dim=1)
    start_p = torch.cummax(torch.where(is_start, p, float("-inf")), dim=-1).values
    totals = torch.where(is_end & (d < n_docs), c - start_p, 0.0)
    return torch.sort(totals, dim=-1, descending=True).values[:, k - 1]


def block_bounds(ub: torch.Tensor) -> torch.Tensor:
    """(Q, T, M) per-block ceilings ``qtf·block_max`` (0 where invalid) →
    (Q, T, M) whole-score bounds ``ub + (Σ_t ub[t, 0] − ub[t, 0])``, the sum
    taken left to right."""
    first = ub[..., 0]
    total = first[..., 0]
    for t in range(1, first.shape[-1]):
        total = total + first[..., t]
    return ub + (total[..., None] - first)[..., None]


def keep_mask(docs: torch.Tensor, imp: torch.Tensor, ub: torch.Tensor,
              valid: torch.Tensor, *, k: int, n_docs: int) -> torch.Tensor:
    """(Q, T, M) keep mask: valid, and a first block or ``bound · SAFETY ≥ θ``.
    ``imp`` are the (Q, T, M, B) impacts (only m = 0 is read)."""
    Q, T, M, B = docs.shape
    theta = theta_lower_bound(docs[:, :, 0].reshape(Q, T * B),
                              imp[:, :, 0].reshape(Q, T * B), k, n_docs)
    first = torch.arange(M, device=docs.device) == 0
    return valid & (first | (block_bounds(ub) * PRUNE_SAFETY >= theta[:, None, None]))


def bm25_pruned_topk(tf, dl, docs, idf_q, ub, valid, k1, b, avgdl, *,
                     k: int, n_docs: int):
    """Fused pruned scoring + top-k for one query or a batch.

    tf (…, T, M, B) uint8, pre-zeroed on invalid blocks; dl (…, T, M, B) f32;
    docs (…, T, M, B) int32 (pad = n_docs); idf_q (…, T) f32 = idf·qtf;
    ub (…, T, M) f32 = qtf·block_max, 0 where invalid; valid (…, T, M) bool;
    the leading … is nothing or Q. Requires k ≤ n_docs (callers clamp).
    Returns (vals (…, k) f32, ids (…, k) int32, touched (…,) int32 — the
    blocks scored).
    """
    tensors = (tf, dl, docs, idf_q, ub, valid)
    if not backend.use_kernel(*tensors):
        return ref.bm25_pruned_topk_ref(*tensors, k1, b, avgdl, k=k, n_docs=n_docs)
    backend.refuse_grad("bm25_pruned_topk", *tensors)
    single = tf.dim() == 3
    if single:
        tensors = tuple(x.unsqueeze(0) for x in tensors)
    tf, dl, docs, idf_q, ub, valid = (x.contiguous() for x in tensors)
    want = (torch.uint8, torch.float32, torch.int32, torch.float32, torch.float32, torch.bool)
    got = tuple(x.dtype for x in (tf, dl, docs, idf_q, ub, valid))
    if got != want:
        raise ValueError(f"bm25_pruned_topk takes dtypes {want}, got {got}")
    Q, T, M, B = tf.shape
    if dl.shape != tf.shape or docs.shape != tf.shape or idf_q.shape != (Q, T) \
            or ub.shape != (Q, T, M) or valid.shape != (Q, T, M):
        raise ValueError("bm25_pruned_topk: inconsistent shapes")
    lib = backend.library("bm25_pruned")
    R, P = _plan(T, B, k, n_docs)
    dev = tf.device
    # scratch — the bucket (8-byte entries, first so that they are aligned),
    # kept blocks, term starts, (term, range) counts, bucket starts, the
    # ranges' survivors, the merge's count — and the outputs: one
    # allocation each
    sizes = (T * M * B * 2, T * M, T + 1, T * P, P * T + 1, P * k, P * k, 1)
    bucket, kept, term_start, counts, starts, surv_vals, surv_ids, done = torch.empty(
        Q * sum(sizes), dtype=torch.int32, device=dev).split([Q * n for n in sizes])
    touched, vals, ids = torch.empty(Q * (1 + 2 * k), dtype=torch.int32, device=dev).split(
        [Q, Q * k, Q * k])
    vals = vals.view(torch.float32).view(Q, k)
    ids = ids.view(Q, k)
    with torch.cuda.device(dev):
        err = lib.bm25_pruned_launch(
            *(x.data_ptr() for x in (tf, dl, docs, idf_q, ub, valid, kept, term_start, counts,
                                     bucket, starts, surv_vals, surv_ids, done, touched, vals,
                                     ids)),
            Q, T, M, B, k, n_docs, R, SMEM_BUDGET, backend.f32(k1), backend.f32(b),
            backend.f32(avgdl), backend.f32(PRUNE_SAFETY), backend.stream(tf))
    backend.check(lib, err, "bm25_pruned_launch")
    bm25_pruned_topk.launches += 1
    if single:
        return vals[0], ids[0], touched[0]
    return vals, ids, touched


@functools.lru_cache(maxsize=None)
def range_docs(T: int, k: int) -> int:
    """R, the docs one range block of the card's kernel owns for T terms and
    k: as many as fit in its shared memory, a multiple of 32."""
    return backend.library("bm25_pruned").bm25_pruned_range_docs(T, k)


@functools.lru_cache(maxsize=None)
def _plan(T: int, B: int, k: int, n_docs: int) -> tuple[int, int]:
    """(R, P) of a call, after checking that θ's kernel and one range fit in
    shared memory."""
    lib = backend.library("bm25_pruned")
    R = range_docs(T, k)
    if R < 32:
        raise ValueError(f"k = {k} leaves no shared memory for a range of docs")
    P = -(-n_docs // R)
    theta = lib.bm25_pruned_theta_smem_bytes(T, B, k)
    if theta > MAX_SMEM:
        raise ValueError(f"T·B = {T * B} first-block postings need {theta} B of shared memory")
    return R, P


bm25_pruned_topk.launches = 0
