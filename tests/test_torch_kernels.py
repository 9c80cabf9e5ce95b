"""The port's kernel twins (CPU) against the JAX package's Pallas kernels
(interpret mode). The CUDA kernels against the twins on the card are in
``test_torch_cuda.py``, which imports no JAX.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance across packages: ids and ``touched`` equal, values at
``rtol=1e-6, atol=0`` (ids may differ only inside a group of reference
scores tied within that tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.corpus import synth_pruned_blocks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bm25_pruned import theta_lower_bound as j_theta
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bm25_block import bm25_block_impacts, bm25_block_scores
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk, theta_lower_bound
from repro_torch.kernels.topk import order_keys, topk
from test_torch_cuda import impacts_case, ranges_case


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-6
_F32 = (np.float32(0.9), np.float32(0.4), np.float32(12.0))


def assert_topk_close(got_v, got_i, want_v, want_i):
    """Values at RTOL; ids equal unless the reference's scores at that rank
    are tied (within RTOL) with another returned score."""
    gv, gi = np.asarray(got_v), np.asarray(got_i)
    wv, wi = np.asarray(want_v), np.asarray(want_i)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0)
    for r in np.flatnonzero(gi != wi):
        tied = np.isclose(wv, wv[r], rtol=RTOL, atol=0)
        assert tied.sum() > 1, f"rank {r}: id {gi[r]} != {wi[r]} (score {wv[r]})"
        assert gi[r] in wi[tied], f"rank {r}: id {gi[r]} outside the tied group"


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _bm25_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    tf = rng.integers(0, 20, shape).astype(np.uint8)
    dl = rng.uniform(1.0, 200.0, shape).astype(np.float32)
    idf = rng.uniform(0.1, 8.0, shape[:-2]).astype(np.float32)
    return tf, dl, idf


# -- K3: BM25 impacts ---------------------------------------------------------------


@pytest.mark.parametrize("T,M,B", [(1, 1, 128), (4, 8, 128), (16, 3, 128),
                                   (7, 5, 128), (5, 7, 128)])
def test_bm25_block_scores_twin_vs_pallas(T, M, B):
    tf, dl, idf = _bm25_inputs(T * 100 + M, (T, M, B))
    want = jops.bm25_block_scores(tf, dl, idf, 0.9, 0.4, 60.0, interpret=True)
    got = bm25_block_scores(*_t(tf, dl, idf), 0.9, 0.4, 60.0)
    assert got.dtype == torch.float32 and got.shape == (T, M, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0)


def test_bm25_block_scores_leading_q():
    """A (Q, T, M, B) batch row by row equals the one-query reference."""
    tf, dl, idf = _bm25_inputs(5, (3, 4, 6, 128))
    got = bm25_block_scores(*_t(tf, dl, idf), 1.2, 0.75, 40.0).numpy()
    for q in range(3):
        want = jref.bm25_block_scores_ref(tf[q], dl[q], idf[q], np.float32(1.2),
                                          np.float32(0.75), np.float32(40.0))
        np.testing.assert_allclose(got[q], np.asarray(want), rtol=RTOL, atol=0)


@pytest.mark.parametrize("shape,invalid", [((2, 4, 8, 128), 0.3), ((3, 5, 7, 100), 0.3),
                                           ((1, 2, 3, 128), 1.0)])
def test_bm25_block_impacts_twin_vs_pallas(shape, invalid):
    """K3's fused entry point (its twin on the CPU) against the reference's
    steps around the Pallas K3 in interpret mode — ``doc_len[min(docs,
    n)]``, the kernel, the mask — query by query, with pads, zero tf and
    invalid rows (all of them in the last case)."""
    n_docs = 3000
    tf, docs, valid, doc_len, idf = impacts_case(sum(shape), shape, n_docs, invalid)
    got = bm25_block_impacts(*_t(tf, docs, valid, doc_len, idf), *_F32, n_docs).numpy()
    for q in range(shape[0]):
        dl = doc_len[np.minimum(docs[q], n_docs)]
        imp = jops.bm25_block_scores(tf[q], dl, idf[q], *_F32, interpret=True)
        want = jnp.where(valid[q] & (docs[q] < n_docs) & (tf[q] > 0), imp, 0.0)
        np.testing.assert_allclose(got[q], np.asarray(want), rtol=RTOL, atol=0)
    if invalid == 1.0:
        assert not got.any()


def test_fma_f32_is_correctly_rounded():
    """The twin's fused multiply-add against exact rational arithmetic,
    midpoint-adjacent cases included."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    n = 3000
    a = rng.uniform(0.5, 1.0, n).astype(np.float32)
    b = rng.uniform(0.5, 4.0, n).astype(np.float32)
    c = rng.integers(0, 256, n).astype(np.float32)
    c[:1000] = (-(a[:1000].astype(np.float64) * b[:1000])
                + rng.integers(-3, 3, 1000) * 2.0 ** -20).astype(np.float32)
    got = tref.fma_f32(*_t(a, b, c)).numpy()
    for i in range(n):
        r = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        x = np.float32(float(r))
        cands = [x, np.nextafter(x, np.float32(np.inf)), np.nextafter(x, np.float32(-np.inf))]
        best = min(cands, key=lambda y: (abs(Fraction(float(y)) - r),
                                         int(np.float32(y).view(np.uint32)) & 1))
        assert got[i] == best, (a[i], b[i], c[i], got[i], best)


# -- pinned cumsum and θ ---------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 16, 17, 100, 2048, 5000])
def test_cumsum_f32_matches_xla_cpu_bitwise(n):
    rng = np.random.default_rng(n)
    v = (rng.random((3, n)) * rng.random((3, n)) * 5).astype(np.float32)
    v[rng.random((3, n)) < 0.3] = 0.0
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(v))
    got = tref.cumsum_f32(torch.from_numpy(v)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,T,k", [(1, 4, 10), (2, 16, 10), (3, 8, 25), (4, 2, 300)])
def test_theta_lower_bound_matches_reference(seed, T, k):
    tf, dl, docs, idf_q, ub, valid = synth_pruned_blocks(
        seed, n_terms=T, max_blocks=4, n_docs=1000)
    imp = np.asarray(jref.bm25_block_scores_ref(tf, dl, idf_q, *_F32))
    imp = np.where(docs < 1000, imp, 0.0).astype(np.float32)
    d0, v0 = docs[:, 0].reshape(-1), imp[:, 0].reshape(-1)
    want = np.asarray(jax.jit(j_theta, static_argnums=(2, 3))(d0, v0, k, 1000))
    got = theta_lower_bound(*_t(d0[None], v0[None]), k, 1000).numpy()[0]
    assert np.float32(got).view(np.uint32) == np.float32(want).view(np.uint32)


# -- K2: streaming top-k ---------------------------------------------------------------


def _scores(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("N,k,chunk", [(1000, 10, 256), (16384, 100, 4096),
                                       (777, 5, 128), (128, 128, 128)])
def test_topk_twin_vs_pallas(N, k, chunk):
    s = _scores(N, N)
    wv, wi = jops.topk(s, k, chunk=chunk, interpret=True)
    gv, gi = topk(torch.from_numpy(s), k, chunk=chunk)
    assert gi.dtype == torch.int32
    assert_topk_close(gv, gi, wv, wi)


def test_topk_with_ties_and_negatives():
    s = np.concatenate([np.full(100, -5.0), np.full(50, 2.0),
                        np.arange(20)]).astype(np.float32)
    wv, wi = jops.topk(s, 30, chunk=64, interpret=True)
    gv, gi = topk(torch.from_numpy(s), 30, chunk=64)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))   # lowest id first


@pytest.mark.parametrize("N,k,chunk", [(13, 6, 8), (5, 8, 4), (100, 40, 64), (129, 3, 128)])
def test_topk_pad_never_leaks(N, k, chunk):
    s = _scores(N * 7 + k, N)
    wv, wi = jops.topk(s, k, chunk=chunk, interpret=True)
    gv, gi = topk(torch.from_numpy(s), k, chunk=chunk)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    live = min(k, N)
    assert np.all(gi.numpy()[:live] < N)
    if k > N:
        assert np.all(gi.numpy()[N:] == N) and np.all(gv.numpy()[N:] == -np.inf)


def test_topk_k_exceeds_live_with_neg_inf_inputs():
    s = np.asarray([-np.inf, 2.0, -np.inf, 1.0, 3.0, -np.inf, -np.inf], np.float32)
    wv, wi = jops.topk(s, 6, chunk=4, interpret=True)
    gv, gi = topk(torch.from_numpy(s), 6, chunk=4)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert list(gi.numpy()) == [4, 1, 3, 7, 7, 7]


def test_topk_leading_q():
    rows = np.stack([_scores(s, 3000) for s in range(4)])
    rows[2, 100:400] = 1.5                                   # ties in one row
    gv, gi = topk(torch.from_numpy(rows), 20, chunk=512)
    for q in range(4):
        wv, wi = jops.topk(rows[q], 20, chunk=512, interpret=True)
        np.testing.assert_array_equal(gv[q].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi[q].numpy(), np.asarray(wi))


def _select_model(keys: np.ndarray, k: int) -> np.ndarray:
    """``csrc/select.cuh`` step by step on one row of keys: 8-bit histogram
    passes from the top until the bin holding rank ``need`` is taken whole
    or the key is complete, then everything above the prefix and the first
    ``need`` positions equal to it, ranked by (key desc, position asc)."""
    prefix, bits, need, done = 0, 0, k, False
    while not done and bits < 32:
        part = np.ones(len(keys), bool) if bits == 0 else (keys >> (32 - bits)) == prefix
        hist = np.bincount((keys[part] >> (24 - bits)) & 0xFF, minlength=256)
        above, d = 0, 255
        while above + hist[d] < need:
            above += hist[d]
            d -= 1
        prefix, need, bits = (prefix << 8) | d, need - above, bits + 8
        done = hist[d] == need
    top = keys >> (32 - bits)
    surv = np.concatenate([np.flatnonzero(top > prefix), np.flatnonzero(top == prefix)[:need]])
    assert len(surv) == k
    return np.array(sorted(surv, key=lambda p: (-int(keys[p]), p)), dtype=np.int64)


def _k2_model(s: np.ndarray, k: int, chunk: int):
    """K2's launches on one row: each chunk's select (padded with -inf up to
    k), then merges over the survivors until k are left; a -inf value
    carries the id N."""
    n = len(s)
    vals, ids = s, np.arange(n)
    width, cut = n, max(chunk, k)
    while True:
        out_v, out_i = [], []
        for c0 in range(0, max(width, 1), cut):
            v = np.concatenate([vals[c0:c0 + cut],
                                np.full(max(0, k - len(vals[c0:c0 + cut])), -np.inf, np.float32)])
            pos = _select_model(order_keys(torch.from_numpy(v)).numpy(), k)
            out_v.append(v[pos])
            out_i.append(np.where(v[pos] == -np.inf, n, ids[np.minimum(c0 + pos, width - 1)]))
        vals, ids = np.concatenate(out_v), np.concatenate(out_i)
        width, cut = len(vals), max(chunk, 2 * k)
        if width == k:
            return vals, ids


def test_select_keys_tie_signed_zeros_and_mark_neg_inf():
    """The select's keys order floats as floats and key -0.0 as +0.0, so the
    radix select (modelled step by step) ties the two zeros by index, keeps
    each zero's own sign bit, and gives -inf slots (-inf, N) — bitwise the
    twin's stable sort, across chunks and merges."""
    f = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    keys = order_keys(torch.from_numpy(f)).numpy()
    assert keys[3] == keys[4] and (np.diff(np.delete(keys, 3)) > 0).all()
    rng = np.random.default_rng(17)
    zeros = np.where(rng.random(3000) < 0.5, np.float32(-0.0), np.float32(0.0))
    zeros[rng.integers(0, 3000, 4)] = 1.25
    skewed = rng.standard_normal(3000).astype(np.float32)
    skewed[::3] = skewed[7]
    sparse = np.full(3000, -np.inf, np.float32)
    sparse[rng.integers(0, 3000, 6)] = rng.standard_normal(6).astype(np.float32)
    sparse[5] = -0.0
    for row in (zeros, skewed, sparse):
        for k, chunk in ((1, 256), (10, 256), (30, 64), (100, 1024)):
            gv, gi = _k2_model(row, k, chunk)
            wv, wi = tref.topk_ref(torch.from_numpy(row), k)
            assert (gv.view(np.uint32) == wv.numpy().view(np.uint32)).all(), (k, chunk)
            assert (gi == wi.numpy()).all(), (k, chunk)
    assert list(_k2_model(sparse, 10, 64)[1][7:]) == [3000] * 3


# -- K1: fused block-max pruned scoring + top-k -----------------------------------------


def _pruned(seed, T, M, n_docs, zipf_a=2.0):
    return synth_pruned_blocks(seed, n_terms=T, max_blocks=M, n_docs=n_docs, zipf_a=zipf_a)


def _check_pruned(args, k, n_docs):
    """Port twin vs the Pallas kernel (vals, ids, touched) and vs the JAX
    UNPRUNED oracle (vals, ids). Returns the port's touched."""
    jv, ji, jt = jops.bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs, interpret=True)
    ov, oi = jref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    gv, gi, gt = bm25_pruned_topk(*_t(*args), *_F32, k=k, n_docs=n_docs)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32 and gt.dtype == torch.int32
    assert_topk_close(gv, gi, jv, ji)
    assert_topk_close(gv, gi, ov, oi)
    assert int(gt) == int(jt)
    return int(gt)


@pytest.mark.parametrize("T,M,n_docs,k", [
    (1, 1, 200, 10), (4, 6, 900, 10), (8, 4, 2000, 25), (2, 8, 1024, 5),
    (5, 8, 4000, 50),
])
@pytest.mark.parametrize("zipf_a", [1.3, 4.0])
def test_bm25_pruned_topk_twin_vs_pallas(T, M, n_docs, k, zipf_a):
    _check_pruned(_pruned(T * 31 + M, T, M, n_docs, zipf_a), k, n_docs)


def test_bm25_pruned_actually_prunes():
    args = _pruned(13, 1, 8, 4000, zipf_a=1.3)
    touched = _check_pruned(args, 10, 4000)
    assert 0 < touched < int(args[5].sum())


def test_bm25_pruned_uniform_ties_and_exact_threshold():
    T, M, B, n_docs, k = 1, 8, 128, 1024, 16
    docs = np.arange(T * M * B, dtype=np.int32).reshape(T, M, B) % n_docs
    tf = np.ones((T, M, B), np.uint8)
    dl = np.full((T, M, B), 12.0, np.float32)
    idf_q = np.ones(T, np.float32)
    valid = np.ones((T, M), bool)
    one = np.float32(1.0) / (np.float32(1.0) + np.float32(0.9))
    ub = np.full((T, M), one, np.float32)
    touched = _check_pruned((tf, dl, docs, idf_q, ub, valid), k, n_docs)
    assert touched == T * M


def test_bm25_pruned_tombstone_zeroed_blocks():
    tf, dl, docs, idf_q, ub, valid = _pruned(11, 4, 6, 900, 2.0)
    tf[1, 2] = 0
    ub[1, 2] = 0.0
    tf[3, 0] = 0
    ub[3, 0] = 0.0
    _check_pruned((tf, dl, docs, idf_q, ub, valid), 10, 900)


def test_bm25_pruned_fewer_postings_than_k():
    args = _pruned(3, 1, 2, 300, 2.0)
    assert _check_pruned(args, 200, 300) == int(args[5].sum())


def test_bm25_pruned_leading_q():
    """A (Q, T, M, B) batch row by row equals the one-query Pallas kernel."""
    batch = [_pruned(40 + q, 4, 6, 900, 1.3 + q) for q in range(3)]
    stacked = [np.stack(parts) for parts in zip(*batch)]
    gv, gi, gt = bm25_pruned_topk(*_t(*stacked), *_F32, k=10, n_docs=900)
    for q, args in enumerate(batch):
        jv, ji, jt = jops.bm25_pruned_topk(*args, *_F32, k=10, n_docs=900, interpret=True)
        assert_topk_close(gv[q], gi[q], jv, ji)
        assert int(gt[q]) == int(jt)


RANGE = 64                          # range_docs of the range-split cases below


def _ranges_case(case, n_docs):
    """:func:`test_torch_cuda.ranges_case` at ``RANGE`` docs a range."""
    return ranges_case(case, n_docs, RANGE)


@pytest.mark.parametrize("n_docs", [RANGE - 1, RANGE, RANGE + 1, 3 * RANGE + 7])
@pytest.mark.parametrize("case", ["synth", "tie_edge", "few_positive", "short"])
def test_bm25_pruned_ranges_twin_equals_dense_twin(case, n_docs):
    """The card's algorithm — per-range top k, then a merge — bitwise equal
    to the twin's top k over the whole accumulator (values, ids, touched)."""
    args, k = _ranges_case(case, n_docs)
    args = _t(*args)
    want = tref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    got = tref.bm25_pruned_ranges_ref(*args, *_F32, k=k, n_docs=n_docs, range_docs=RANGE)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.numpy().view(np.uint32 if g.dtype == torch.float32 else np.int32),
                              w.numpy().view(np.uint32 if w.dtype == torch.float32 else np.int32))
    vals, ids = want[0].numpy(), want[1].numpy()
    if case == "tie_edge" and n_docs > RANGE:   # the k-th score ties with the next range's
        assert (vals == vals[:, :1]).all() and (ids[:, -1] < RANGE).all()
        full = tref.bm25_pruned_topk_ref(*args, *_F32, k=k + 1, n_docs=n_docs)
        assert (full[0][:, -1] == vals[:, -1]).all() and (full[1][:, -1] >= RANGE).all()
    if case == "few_positive":                             # zero-score ids fill the top k
        assert ((vals > 0).sum(1) < k).all() and (vals[:, -1] == 0).all()
        if n_docs > RANGE:
            assert (ids.max(1) >= RANGE).all()
    if case == "short":                                    # θ = 0: nothing pruned
        assert (want[2].numpy() == args[5].numpy().sum((1, 2))).all()


def test_kernel_wrappers_refuse_mixed_devices():
    tf, dl, idf = _bm25_inputs(1, (2, 2, 128))
    with pytest.raises(ValueError, match="several devices"):
        bm25_block_scores(*_t(tf, dl), torch.zeros(2, device="meta"), 0.9, 0.4, 1.0)


# -- K5's log-sum-exp (return_lse) ------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, Dv, kwargs): causal, window, kv_len, GQA, Dv != D,
# a decode row; kv_len=0 and a window past a short kv_len leave rows that see
# no key (lse −inf)
LSE_CASES = [
    (2, 4, 4, 9, 9, 8, 8, dict(causal=True)),
    (1, 4, 2, 12, 12, 8, 8, dict(causal=True, window=4)),
    (2, 6, 2, 1, 70, 16, 16, dict(kv_len=50)),
    (1, 4, 1, 5, 20, 8, 12, dict(kv_len=17)),
    (1, 2, 2, 3, 10, 4, 6, dict(kv_len=0)),
    (1, 2, 1, 6, 6, 8, 8, dict(causal=True, window=2, kv_len=3)),
]


def _lse_oracle(q, k, kw) -> torch.Tensor:
    """``torch.logsumexp`` over each row's masked, scaled scores (f64)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qpos = torch.arange(Sq) + (Skv - Sq)
    mask = tref.attention_mask(qpos, torch.arange(Skv), causal=kw.get("causal", False),
                               window=kw.get("window"), kv_len=kw.get("kv_len", Skv))
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.double().reshape(B, Hkv, Hq // Hkv, Sq, D),
                     k.double()) * float(D) ** -0.5
    return torch.logsumexp(torch.where(mask, s, float("-inf")), -1).reshape(B, Hq, Sq)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,Dv,kw", LSE_CASES)
def test_flash_attention_twins_lse_match_logsumexp(B, Hq, Hkv, Sq, Skv, D, Dv, kw):
    """Both twins' lse is the log-sum-exp of the row's visible scaled scores
    (2⁻²⁰ of max(1, |lse|): f32 against f64), −inf exactly where a row sees
    no key; their outputs are those of the calls without ``return_lse``, and
    the wrapper on the CPU is the twin."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(B * 100 + Sq * 10 + Skv)
    q, k, v = _t(rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
                 rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
                 rng.standard_normal((B, Hkv, Skv, Dv)).astype(np.float32))
    want = _lse_oracle(q, k, kw)
    dead = torch.isinf(want)
    assert bool(dead.any()) == (kw.get("kv_len") == 0 or "window" in kw and "kv_len" in kw)
    split = dict(k_begin=0, split=16)
    runs = {"twin": lambda **x: tref.flash_attention_ref(q, k, v, **kw, **x),
            "split twin": lambda **x: tref.flash_attention_split_ref(q, k, v, **kw, **split, **x),
            "wrapper": lambda **x: flash_attention(q, k, v, **kw, **x)}
    for name, run in runs.items():
        out, lse = run(return_lse=True)
        assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32, name
        assert torch.equal(out, run()), name
        assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] < 0).all()), name
        tol = 2.0 ** -20 * torch.clamp(want.abs(), min=1.0)
        assert bool(((lse.double() - want).abs() <= tol)[~dead].all()), name
    assert torch.equal(runs["wrapper"](return_lse=True)[1], runs["twin"](return_lse=True)[1])


def test_flash_attention_without_lse_keeps_its_bits():
    """``return_lse=False`` (the default) returns the tensor alone, the
    twin's bits, as before the flag: bf16 in, bf16 out."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(5)
    q, k, v = (t.bfloat16() for t in _t(rng.standard_normal((1, 4, 7, 8)).astype(np.float32),
                                        rng.standard_normal((1, 2, 7, 8)).astype(np.float32),
                                        rng.standard_normal((1, 2, 7, 8)).astype(np.float32)))
    got = flash_attention(q, k, v, causal=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       tref.flash_attention_ref(q, k, v, causal=True).view(torch.int16))
    assert torch.equal(got, flash_attention(q, k, v, causal=True, return_lse=True)[0])
