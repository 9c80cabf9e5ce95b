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

A third is pinned because the library's depends on the shape:

* a dense-tier score (:func:`dot_scores_f32`) is a chain of fused
  multiply-adds over d from 0 to D − 1, ``acc = fma(c_d, q_d, acc)`` from
  +0.0, one rounding a step (:func:`fma_f32`) — the order K4 computes, and
  one that depends on D alone, so a query's bits depend neither on its
  batch neighbours nor on the size of the partition. ``torch.matmul``
  blocks its sums by shape.

Top-k ties go to the lowest index (a stable descending sort), never
``torch.topk``, whose tie order is unspecified.

K5's twin (:func:`flash_attention_ref`) pins the attention kernel's order
the same way: each score a sum over d from +0, then Σp and Σp·v over each
64-key tile's keys in order, one rounding a step. K6's
(:func:`embedding_bag_ref`) sums each bag's weighted rows slot by slot.
"""

from __future__ import annotations

import torch

SCAN_ROW = 16
DOT_CHUNK = 1024     # rows per K4 chunk, as the reference's DEFAULT_CHUNK


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


def bm25_block_impacts_ref(tf, docs, valid, doc_len, idf, k1, b, avgdl, n_docs: int):
    """Twin of K3's fused entry point: tf (..., T, M, B) uint8, docs (..., T,
    M, B) int32, valid (..., T, M, 1) bool, doc_len (n_docs + 1,) f32, idf
    (..., T) f32 → (..., T, M, B) f32. :func:`bm25_block_scores_ref` over
    ``dl = doc_len[min(docs, n_docs)]``, +0.0 where the row is invalid, the
    doc a pad or tf 0 — the steps of the reference's ``bm25_impacts``."""
    dl = doc_len[torch.clamp(docs, max=n_docs).long()]
    imp = bm25_block_scores_ref(tf, dl, idf, k1, b, avgdl)
    return torch.where(valid & (docs < n_docs) & (tf > 0), imp, 0.0)


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


def bm25_pruned_ranges_ref(tf, dl, docs, idf_q, ub, valid, k1, b, avgdl, *,
                           k: int, n_docs: int, range_docs: int):
    """K1's algorithm on the card, in plain PyTorch, for the tests only:
    the same impacts, θ and keep mask as :func:`bm25_pruned_topk_ref`, the
    accumulator cut into ranges of ``range_docs`` docs (the last one
    shorter), each range's top k by :func:`topk_ref` — fewer than k docs pad
    with (-inf, n_docs) — and the ranges' survivors, in id order, merged by
    :func:`topk_ref` again. Returns (vals, ids, touched) as the twin does."""
    from repro_torch.kernels.bm25_pruned import keep_mask

    single = tf.dim() == 3
    if single:
        tf, dl, docs, idf_q, ub, valid = (
            x.unsqueeze(0) for x in (tf, dl, docs, idf_q, ub, valid))
    imp = bm25_block_scores_ref(tf, dl, idf_q, k1, b, avgdl)
    imp = torch.where(docs < n_docs, imp, 0.0)
    keep = keep_mask(docs, imp, ub, valid, k=k, n_docs=n_docs)
    acc = scatter_add_terms(docs, torch.where(keep[..., None], imp, 0.0), n_docs)
    parts_v, parts_i = [], []
    for lo in range(0, n_docs, range_docs):
        v, i = topk_ref(acc[:, lo:min(lo + range_docs, n_docs)], k)
        parts_v.append(v)
        parts_i.append(torch.where(v == float("-inf"), n_docs, i + lo).to(torch.int32))
    sv, si = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
    vals, pos = topk_ref(sv, k)
    ids = torch.gather(si, 1, pos.clamp(max=si.shape[1] - 1).long())
    ids = torch.where(vals == float("-inf"), n_docs, ids).to(torch.int32)
    touched = keep.sum(dim=(1, 2), dtype=torch.int32)
    if single:
        return vals[0], ids[0], touched[0]
    return vals, ids, touched


def dot_scores_f32(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """queries (Q, D), cands (N, D) f32 → (Q, N) f32 inner products in the
    pinned order: ``acc = +0.0``, then ``acc = fma(c_d, q_d, acc)`` for
    d = 0 … D − 1, each step one fused multiply-add rounded once."""
    Q, D = queries.shape
    cT = cands.t().contiguous()                       # (D, N): one row per step
    acc = torch.zeros(Q, cands.shape[0], dtype=torch.float32, device=cands.device)
    for d in range(D):
        acc = fma_f32(queries[:, d, None], cT[d][None, :], acc)
    return acc


def dot_topk_batch_ref(queries: torch.Tensor, cands: torch.Tensor, k: int, *,
                       chunk: int = DOT_CHUNK):
    """Twin of K4: queries (Q, D), cands (N, D) f32 → (vals, ids int32)
    (Q, k). Scores as :func:`dot_scores_f32`; rows past N are -inf; each
    ``chunk``-row chunk keeps its top k (ties to the lowest row), and the
    survivors, in chunk order, merge with ties to the lowest id. Slots with
    no live row come back as (-inf, N). ``chunk`` is never shrunk to N."""
    Q = queries.shape[0]
    N = cands.shape[0]
    if Q == 0:
        return (torch.zeros(0, k, dtype=torch.float32, device=cands.device),
                torch.zeros(0, k, dtype=torch.int32, device=cands.device))
    chunk = max(chunk, k)
    n_chunks = max(1, -(-N // chunk))
    scores = dot_scores_f32(queries, cands)
    scores = torch.nn.functional.pad(scores, (0, n_chunks * chunk - N), value=float("-inf"))
    vals, pos = topk_ref(scores.reshape(Q, n_chunks, chunk), k)
    base = torch.arange(n_chunks, device=cands.device, dtype=torch.int64)[:, None] * chunk
    ids = torch.where(vals == float("-inf"), N, pos.long() + base)
    vals, ids = vals.reshape(Q, n_chunks * k), ids.reshape(Q, n_chunks * k)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices[:, :k]
    return vals.gather(1, order), ids.gather(1, order).to(torch.int32)


def dot_topk_ref(query: torch.Tensor, cands: torch.Tensor, k: int, *,
                 chunk: int = DOT_CHUNK):
    """query (D,), cands (N, D) → (vals (k,), ids (k,) int32): one row of
    :func:`dot_topk_batch_ref`."""
    vals, ids = dot_topk_batch_ref(query[None, :], cands, k, chunk=chunk)
    return vals[0], ids[0]


FLASH_BK = 64        # keys per K5 tile (csrc/flash_attention.cu's BK)


def attention_mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
                window: "int | None", kv_len: int) -> torch.Tensor:
    """(rows, keys) bool: which keys each query row sees (query positions
    ``qpos``, key positions ``kpos``)."""
    m = (kpos < kv_len)[None, :].expand(qpos.shape[0], kpos.shape[0])
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, window: "int | None" = None,
                        kv_len: "int | None" = None, sm_scale: "float | None" = None,
                        return_lse: bool = False):
    """Twin of K5: q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v (B,Hkv,Skv,Dv) →
    (B,Hq,Sq,Dv) in q's dtype, queries at the end of the kv axis; with
    ``return_lse`` also each row's log-sum-exp ``m + log(l)`` (B,Hq,Sq) f32
    from the final running max and denominator, −inf for a row that sees
    no key.

    The kernel's steps, one eager op each, in f32: the G query heads of a
    kv head fold into rows (row r sits at position ``r % Sq + Skv − Sq``);
    kv tiles of 64 keys in order, each key's score summed over d from +0,
    scaled, masked to -inf; the online softmax's running max, denominator
    and accumulator, with ``Σ_j p_j`` and ``Σ_j p_j·v_j`` summed over the
    tile's keys in order from +0. A tile that no row sees is skipped, which
    changes no bit. Rows are independent, so all rows of all heads go
    through each tile together."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    BH, rows, dev = B * Hkv, G * Sq, q.device
    scale = torch.tensor(sm_scale if sm_scale is not None else float(D) ** -0.5,
                         dtype=torch.float32, device=dev)
    qT = q.reshape(BH, rows, D).float().permute(2, 0, 1).contiguous()   # (D, BH, rows)
    kT = k.reshape(BH, Skv, D).float().permute(2, 0, 1).contiguous()    # (D, BH, Skv)
    vf = v.reshape(BH, Skv, Dv).float()
    kv_len = Skv if kv_len is None else min(int(kv_len), Skv)
    qpos = torch.arange(rows, device=dev) % Sq + (Skv - Sq)
    neg = torch.tensor(float("-inf"), device=dev)
    zero = torch.tensor(0.0, device=dev)
    m = torch.full((BH, rows), float("-inf"), device=dev)
    l = torch.zeros(BH, rows, device=dev)
    acc = torch.zeros(BH, rows, Dv, device=dev)
    # the keys some row sees: [k_lo, kv_len), the union of the rows' windows
    # (the last row sits at Skv − 1, so causality cuts nothing off the end)
    k_lo = max(0, Skv - Sq - window + 1) if window is not None else 0
    for k0 in range(k_lo // FLASH_BK * FLASH_BK, kv_len, FLASH_BK):
        bk = min(FLASH_BK, Skv - k0)
        mask = attention_mask(qpos, torch.arange(k0, k0 + bk, device=dev), causal=causal,
                           window=window, kv_len=kv_len)
        s = torch.zeros(BH, rows, bk, device=dev)
        for d in range(D):
            s = s + qT[d][:, :, None] * kT[d][:, None, k0:k0 + bk]
        s = torch.where(mask, s * scale, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
        alpha = torch.where(m == float("-inf"), zero, torch.exp(m - m_safe))
        pT = p.permute(2, 0, 1).contiguous()                             # (bk, BH, rows)
        psum = torch.zeros(BH, rows, device=dev)
        pv = torch.zeros(BH, rows, Dv, device=dev)
        for j in range(bk):
            psum = psum + pT[j]
            pv = pv + pT[j][..., None] * vf[:, None, k0 + j, :]
        l = alpha * l + psum
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l[..., None], zero)
    out = out.reshape(B, Hq, Sq, Dv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = False, window: "int | None" = None,
                              kv_len: "int | None" = None, sm_scale: "float | None" = None,
                              k_begin: int, split: int, return_lse: bool = False):
    """Split-KV attention — the algorithm of K5's bf16 decode kernel — in
    plain f32 PyTorch, for the tests and the smoke only. The keys
    [k_begin, kv_len), ``k_begin`` from the kernel's own plan
    (``flash_attention.split_plan``), are cut into splits of ``split`` keys;
    each split gives each row a partial (m, l, acc) from its own max,
    m = −inf where the row sees none of the split's keys; then the splits
    merge in split order by the log-sum-exp rule, M = max m_s,
    l = Σ e^(m_s − M)·l_s, acc = Σ e^(m_s − M)·acc_s, out = acc / l, and 0
    where l = 0; with ``return_lse`` also M + log(l) (B,Hq,Sq), −inf where
    l = 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    BH, rows, dev = B * Hkv, Hq // Hkv * Sq, q.device
    scale = sm_scale if sm_scale is not None else float(D) ** -0.5
    kv_end = Skv if kv_len is None else max(0, min(int(kv_len), Skv))
    qf = q.reshape(BH, rows, D).float()
    kf = k.reshape(BH, Skv, D).float()
    vf = v.reshape(BH, Skv, Dv).float()
    qpos = torch.arange(rows, device=dev) % Sq + (Skv - Sq)
    l = torch.zeros(BH, rows, device=dev)
    acc = torch.zeros(BH, rows, Dv, device=dev)
    parts = []
    M_safe = torch.zeros(BH, rows, device=dev)
    for s0 in range(k_begin, kv_end, split):
        s1 = min(s0 + split, kv_end)
        mask = attention_mask(qpos, torch.arange(s0, s1, device=dev), causal=causal,
                              window=window, kv_len=kv_end)
        s = torch.einsum("brd,bkd->brk", qf, kf[:, s0:s1]) * scale
        s = torch.where(mask, s, float("-inf"))
        m = s.amax(dim=-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("brk,bkd->brd", p, vf[:, s0:s1])))
    if parts:
        M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        M_safe = torch.where(torch.isfinite(M), M, 0.0)
        for m, ls, accs in parts:                        # split order
            w = torch.exp(m - M_safe)                    # 0 for a split the row never saw
            l = l + w * ls
            acc = acc + w[..., None] * accs
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    out = out.reshape(B, Hq, Sq, Dv).to(q.dtype)
    if return_lse:
        return out, (M_safe + torch.log(l)).reshape(B, Hq, Sq)
    return out


def mha_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, window: "int | None" = None,
                      sm_scale: "float | None" = None,
                      kv_len: "int | None" = None) -> torch.Tensor:
    """Dense attention oracle: q (B,Hq,Sq,D), k (B,Hkv,Skv,D), v
    (B,Hkv,Skv,Dv); Hq % Hkv == 0. ``window``: key j visible to query i iff
    i − W < j ≤ i, positions aligned at the sequence end; ``kv_len``: the
    number of valid kv positions. Fully masked rows give 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(D) ** 0.5
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    mask = attention_mask(qpos, torch.arange(Skv, device=q.device), causal=causal,
                       window=window, kv_len=Skv if kv_len is None else int(kv_len))
    s = torch.where(mask, s, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Twin of K6: table (V, D) f32 or bf16, idx (B, L) int (< 0: padding),
    weights (B, L) → (B, D) f32, ``out[b] = Σ_l w[b,l]·f32(table[idx[b,l]])``.

    The kernel's order: ``acc = +0.0``, then slot by slot in l order
    ``acc = acc + row·w``, the product and the sum each rounded once. A pad
    slot leaves ``acc`` as it was (``where``, not a zero weight), as the
    kernel skips it: the row a pad gathers (row 0) can change no bit, not
    even turn the sum into NaN. The reference's own twin is an ``einsum``,
    whose order is unspecified."""
    B, L = idx.shape
    valid = idx >= 0
    safe = torch.clamp(idx, min=0).long()
    w = weights.float()
    acc = torch.zeros(B, table.shape[1], dtype=torch.float32, device=table.device)
    for l in range(L):
        row = table[safe[:, l]].float()
        acc = torch.where(valid[:, l, None], acc + row * w[:, l, None], acc)
    return acc
