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
from repro_torch.kernels.bm25_block import bm25_block_scores
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk, theta_lower_bound
from repro_torch.kernels.topk import topk

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


def test_kernel_wrappers_refuse_mixed_devices():
    tf, dl, idf = _bm25_inputs(1, (2, 2, 128))
    with pytest.raises(ValueError, match="several devices"):
        bm25_block_scores(*_t(tf, dl), torch.zeros(2, device="meta"), 0.9, 0.4, 1.0)
