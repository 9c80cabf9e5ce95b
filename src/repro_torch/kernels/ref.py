"""Plain PyTorch twins of the hand-written kernels.

The CPU tests run these, any CPU tensor takes them, and ``chip_smoke.py``
holds each kernel against its twin on the card. Each twin keeps the
reduction order of the JAX reference, written one eager op per arithmetic
step (no ``addcmul``, no ``alpha=``, no ``torch.compile``): every op then
rounds once, which is what the kernels — built without FMA contraction and
with IEEE division — reproduce bit for bit. The one fused multiply-add the
reference's compiler makes is written out on both sides (:func:`fma_f32`).

Two orders are pinned explicitly because the library's own differ by device:

* sums of one doc's impacts go term by term, in term order
  (:func:`scatter_add_terms`) — one ``index_add_`` per term, whose live docs
  are distinct, so the card's float atomics never see two real addends on
  one address;
* a cumulative sum (:func:`cumsum_f32`) goes in rows of 16 left to right,
  the row totals scanned the same way and added back — the order XLA's CPU
  backend gives ``jnp.cumsum``, so θ and the sorted accumulator agree with
  the reference to the bit. ``torch.cumsum`` is a parallel scan on the card
  and accumulates in float64 on the CPU.

Top-k ties go to the lowest index (a stable descending sort), never
``torch.topk``, whose tie order is unspecified.
"""

from __future__ import annotations

import torch

SCAN_ROW = 16


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A BM25 parameter as a 0-d float32 tensor on ``like``'s device. Kept
    on the device on purpose: dividing a CUDA tensor by a CPU scalar makes
    PyTorch multiply by its reciprocal, one rounding more than the kernel."""
    return torch.as_tensor(x, dtype=torch.float32).to(like.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` with ONE rounding, as a fused multiply-add gives
    it (``fmaf`` in the kernels). In float64 the product is exact and TwoSum
    recovers the sum's rounding error ``e``; rounding the float64 sum to
    float32 is then correct except when it sits exactly on a float32
    midpoint, where ``e`` says which way the exact value lies."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    mid = (bits & 0x1FFFFFFF) == 0x10000000      # low 29 of 52 bits: 1000…0
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.full_like(s, float("-inf")))
    s = torch.where(mid & (e > 0), up, torch.where(mid & (e < 0), down, s))
    return s.float()


def bm25_block_scores_ref(tf, dl, idf, k1, b, avgdl):
    """tf (..., T, M, B) uint8, dl (..., T, M, B) f32, idf (..., T) f32 →
    impacts (..., T, M, B) f32: ``(idf·tf) / fma(k1, (1 − b) + (b·dl)/avgdl, tf)``.
    The reference's XLA CPU build contracts ``tf + k1·norm`` into one fused
    multiply-add, and the port does the same, so impacts agree to the bit."""
    k1, b, avgdl = (_scalar(x, dl) for x in (k1, b, avgdl))
    tff = tf.to(torch.float32)
    norm = b * dl
    norm = norm / avgdl
    norm = (1.0 - b) + norm
    denom = fma_f32(k1.expand_as(norm), norm, tff)
    num = idf[..., None, None] * tff
    return num / denom


def cumsum_f32(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 cumsum along the last dim in the pinned order: rows
    of ``SCAN_ROW`` summed left to right, the row totals scanned recursively
    the same way, then each later row plus the scanned total before it."""
    n = v.shape[-1]
    if n == 0:
        return v
    if n <= SCAN_ROW:
        cols = [v[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + v[..., j])
        return torch.stack(cols, dim=-1)
    rows = -(-n // SCAN_ROW)
    w = torch.nn.functional.pad(v, (0, rows * SCAN_ROW - n))
    w = cumsum_f32(w.reshape(*v.shape[:-1], rows, SCAN_ROW))
    s = cumsum_f32(w[..., -1])
    w = torch.cat([w[..., :1, :], w[..., 1:, :] + s[..., :-1, None]], dim=-2)
    return w.reshape(*v.shape[:-1], rows * SCAN_ROW)[..., :n]


def scatter_add_terms(docs: torch.Tensor, impacts: torch.Tensor,
                      n_docs: int) -> torch.Tensor:
    """docs / impacts (Q, T, ...) → the (Q, n_docs + 1) accumulator, the last
    slot the dump for pads. Adds one term at a time in term order — each doc
    once per term — so every doc's sum is ((0 + x_t0) + x_t1) + …, the order
    of the reference's flat scatter-add, on every device."""
    Q, T = docs.shape[:2]
    acc = torch.zeros(Q * (n_docs + 1), dtype=torch.float32, device=impacts.device)
    rows = torch.arange(Q, device=docs.device, dtype=torch.int64)[:, None] * (n_docs + 1)
    d = torch.clamp(docs.reshape(Q, T, -1).to(torch.int64), max=n_docs)
    imp = impacts.reshape(Q, T, -1)
    for t in range(T):
        acc.index_add_(0, (d[:, t] + rows).reshape(-1), imp[:, t].reshape(-1))
    return acc.reshape(Q, n_docs + 1)


def topk_ref(scores: torch.Tensor, k: int):
    """scores (..., N) f32 → (vals, ids int32) (..., k), descending, ties to
    the lowest index; slots whose value is -inf (and slots past N when
    k > N) return (-inf, N) — the K2 kernel's contract."""
    N = scores.shape[-1]
    if k > N:
        scores = torch.nn.functional.pad(scores, (0, k - N), value=float("-inf"))
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    ids = torch.where(vals == float("-inf"), N, pos).to(torch.int32)
    return vals, ids


def bm25_pruned_topk_ref(tf, dl, docs, idf_q, ub, valid, k1, b, avgdl, *,
                         k: int, n_docs: int):
    """Twin of the K1 kernel: impacts, θ, keep mask, term-ordered
    accumulation of the kept impacts and K2's top-k. Inputs as for
    :func:`repro_torch.kernels.bm25_pruned.bm25_pruned_topk`, one query
    (T, M, B) or a batch (Q, T, M, B). Returns (vals, ids, touched)."""
    from repro_torch.kernels.bm25_pruned import keep_mask

    single = tf.dim() == 3
    if single:
        tf, dl, docs, idf_q, ub, valid = (
            x.unsqueeze(0) for x in (tf, dl, docs, idf_q, ub, valid))
    imp = bm25_block_scores_ref(tf, dl, idf_q, k1, b, avgdl)
    imp = torch.where(docs < n_docs, imp, 0.0)
    keep = keep_mask(docs, imp, ub, valid, k=k, n_docs=n_docs)
    acc = scatter_add_terms(docs, torch.where(keep[..., None], imp, 0.0), n_docs)
    vals, ids = topk_ref(acc[:, :n_docs], k)
    touched = keep.sum(dim=(1, 2), dtype=torch.int32)
    if single:
        return vals[0], ids[0], touched[0]
    return vals, ids, touched
