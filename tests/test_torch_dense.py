"""The dense tier in both packages: K4's plain twin against the JAX
package's ``dot_topk`` (the Pallas kernel in interpret mode, and its pure-JAX
reference), the port's bitwise invariants, ``DenseSearcher`` and the
oracles.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance across packages: the reference's dot is an XLA ``dot_general``
whose f32 order cannot be reproduced, so a score may differ by
``|port − ref| ≤ 1e-6 · Σ_d |c_d·q_d|``, and ids are equal except where the
reference's own scores lie within that tolerance of each other. Inside the
port the twin is bitwise Q-invariant and partition-size-invariant.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro.core.partition import rrf_fuse as j_rrf_fuse
from repro.data.corpus import hash_embedder as j_hash_embedder
from repro.data.corpus import synth_corpus, synth_queries
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.search.oracle import DenseOracleSearcher as JDenseOracle
from repro.search.oracle import OracleSearcher as JOracle
from repro.search.oracle import hybrid_oracle_fuse as j_hybrid_fuse
from repro.search.searcher import DenseSearcher as JDenseSearcher
from repro.search.searcher import SearchConfig as JSearchConfig
from repro_torch.core.partition import rrf_fuse
from repro_torch.data.corpus import hash_embedder
from repro_torch.kernels import ref
from repro_torch.kernels.dot_topk import dot_topk, dot_topk_batch
from repro_torch.search.oracle import (DenseOracleSearcher, OracleSearcher,
                                       hybrid_oracle_fuse)
from repro_torch.search.searcher import DenseSearcher, SearchConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DIM = 16
TOL = 1e-6
JAX_FNS = {"pallas": jops.dot_topk_batch, "jax_ref": jref.dot_topk_batch_ref}


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def assert_dense_close(q, c, got_v, got_i, want_v, want_i):
    """Per query and rank: |port − ref| ≤ TOL · Σ_d |c_d·q_d| of the row the
    reference returned; ids equal unless the reference's score at that rank
    lies within that tolerance of another of its scores."""
    gv, gi = np.asarray(got_v, np.float64), np.asarray(got_i)
    wv, wi = np.asarray(want_v, np.float64), np.asarray(want_i)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    for qi in range(wv.shape[0]):
        scale = np.abs(c.astype(np.float64)[wi[qi]] * q.astype(np.float64)[qi]).sum(-1)
        tol = TOL * scale
        assert (np.abs(gv[qi] - wv[qi]) <= tol).all(), (qi, gv[qi] - wv[qi], tol)
        for r in np.flatnonzero(gi[qi] != wi[qi]):
            near = np.abs(wv[qi] - wv[qi, r]) <= tol[r]
            assert near.sum() > 1, f"query {qi} rank {r}: id {gi[qi, r]} != {wi[qi, r]}"
            assert gi[qi, r] in wi[qi][near]


@pytest.mark.parametrize("jax_fn", sorted(JAX_FNS))
@pytest.mark.parametrize("N,D,k,Q", [(53, 16, 10, 1), (53, 16, 10, 5),
                                     (136, 16, 10, 7), (1000, 16, 10, 3),
                                     (1091, 16, 10, 8), (4096, 64, 50, 2),
                                     (5, 8, 3, 1), (300, 13, 1, 3),
                                     (1091, 100, 100, 4)])
def test_dot_topk_twin_vs_reference(jax_fn, N, D, k, Q):
    rng = np.random.default_rng(N * 7 + D)
    c = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    before = dot_topk_batch.launches
    gv, gi = dot_topk_batch(*_t(q, c), k)
    assert dot_topk_batch.launches == before          # the CPU takes the twin
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    wv, wi = JAX_FNS[jax_fn](q, c, k)
    assert_dense_close(q, c, gv.numpy(), gi.numpy(), np.asarray(wv), np.asarray(wi))


@pytest.mark.parametrize("N", [136, 137, 1091])
def test_dot_topk_batch_q_invariant(N):
    """A query's score bits may not depend on how many neighbours shared
    its micro-batch: batched row 0 == the Q=1 call, exactly."""
    rng = np.random.default_rng(N)
    c, q = _t(rng.standard_normal((N, DIM)).astype(np.float32),
              rng.standard_normal((8, DIM)).astype(np.float32))
    v1, i1 = dot_topk_batch(q[:1], c, 10)
    for Q in (2, 3, 7, 8):
        vq, iq = dot_topk_batch(q[:Q], c, 10)
        assert (_bits(vq[0]) == _bits(v1[0])).all(), Q
        assert torch.equal(iq[0], i1[0]), Q


def test_partition_bits_match_full_corpus_bits():
    """A row scores to the same bits whether it sits in a 53-row partition
    or a 200-row corpus (and at D=768, a 1091-row one against 2300)."""
    for n_full, tail, dim in ((200, 147, DIM), (2300, 1209, 768)):
        rng = np.random.default_rng(9)
        c, q = _t(rng.standard_normal((n_full, dim)).astype(np.float32),
                  rng.standard_normal((1, dim)).astype(np.float32))
        fv, fi = dot_topk_batch(q, c, n_full if n_full <= 1024 else 1024)
        full = {int(i): b for b, i in zip(_bits(fv[0]), fi[0].tolist())}
        pv, pi = dot_topk_batch(q, c[tail:], min(n_full - tail, 1024))
        for b, i in zip(_bits(pv[0]), pi[0].tolist()):
            if tail + i in full:
                assert b == full[tail + i]
        assert len(set(full) & {tail + i for i in pi[0].tolist()}) > 0


def _fma_exact(a, b, c) -> np.float32:
    """float32 ``a·b + c`` rounded once (to nearest, ties to even), from
    exact rationals: independent of ``ref.fma_f32``'s float64 emulation.
    An exact zero comes back as +0.0 (the chains below start from +0.0 and
    have no zero products)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    near = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.float32(y).view(np.uint32)) & 1))


def test_dot_scores_are_one_fma_a_column():
    """K4's pinned order: ``acc = fma(c_d, q_d, acc)`` for d = 0 … D − 1 from
    +0.0, one rounding a step — bitwise, against an exact-rational chain;
    and not the earlier order of two roundings a step (product, then sum)."""
    rng = np.random.default_rng(21)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    c = rng.standard_normal((40, 24)).astype(np.float32)
    got = ref.dot_scores_f32(*_t(q, c)).numpy()
    want = np.zeros((3, 40), np.float32)
    two = np.zeros((3, 40), np.float32)
    for i in range(3):
        for r in range(40):
            acc = np.float32(0.0)
            for d in range(24):
                acc = _fma_exact(c[r, d], q[i, d], acc)
                two[i, r] = np.float32(two[i, r] + np.float32(c[r, d] * q[i, d]))
            want[i, r] = acc
    assert (_bits(got) == _bits(want)).all()
    assert (_bits(got) != _bits(two)).any()


def test_twin_pads_chunks_and_marks_empty_slots():
    """k > N: slots past the live rows are (-inf, N); a tie spanning two
    chunks resolves to the lower row; ``dot_topk`` is one row of the batch."""
    rng = np.random.default_rng(4)
    c = rng.standard_normal((1500, 8)).astype(np.float32)
    c[1400] = c[3]
    q = c[3:4].copy()
    vals, ids = dot_topk_batch(*_t(q, c), 4)
    assert ids[0, :2].tolist() == [3, 1400]
    v, i = dot_topk(*_t(q[0], c[:2]), 5)
    assert i.tolist()[2:] == [2, 2, 2] and torch.isinf(v[2:]).all()
    assert (_bits(v[:2]) == _bits(ref.dot_topk_ref(*_t(q[0], c[:2]), 2)[0])).all()
    e_v, e_i = dot_topk_batch(torch.zeros(0, 8), torch.from_numpy(c), 3)
    assert e_v.shape == (0, 3) and e_i.dtype == torch.int32


def test_dot_topk_refuses_k_beyond_one_chunk():
    """``k`` may not exceed one chunk's 1024 rows — refused on the CPU as
    on the card, so one call cannot answer on one device and fail on the
    other."""
    c, q = torch.zeros(2000, 8), torch.zeros(2, 8)
    assert dot_topk_batch(q, c, 1024)[1].shape == (2, 1024)
    with pytest.raises(ValueError, match="exceeds the 1024 rows"):
        dot_topk_batch(q, c, 1025)
    with pytest.raises(ValueError, match="exceeds the 1024 rows"):
        dot_topk(q[0], c, 1025)


# -- the dense searcher and the oracles -------------------------------------------


@pytest.mark.parametrize("k", [None, 4, 50])
def test_dense_searcher_matches_reference(k):
    """Tombstoned rows are compacted out and live rows keep their order:
    the hits map back to the same internal ids as the reference's."""
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((300, DIM)).astype(np.float32)
    live = np.ones(300, bool)
    live[[0, 7, 150, 299]] = False
    ids = [f"d{i}" for i in range(300)]
    qs = rng.standard_normal((5, DIM)).astype(np.float32)
    port = DenseSearcher(vecs, ids, live, SearchConfig(k=12), device="cpu")
    want = JDenseSearcher(vecs, ids, live, JSearchConfig(k=12)).search_batch(list(qs), k)
    got = port.search_batch(list(qs), k)
    assert port.nbytes == 296 * DIM * 4 and port.rows.device.type == "cpu"
    for qi, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == min(12, k or 12)
        assert_dense_close(qs[qi:qi + 1], vecs,
                           [[s for _, s in g]], [[i for i, _ in g]],
                           [[s for _, s in w]], [[i for i, _ in w]])
        assert all(live[i] for i, _ in g)
    assert DenseSearcher(vecs[:0], [], live[:0], device="cpu").search_batch(list(qs)) \
        == [[] for _ in qs]


def test_oracles_match_reference():
    docs = synth_corpus(120, vocab=200, seed=3)
    queries = synth_queries(docs, 6, seed=4)
    so, jso = OracleSearcher(docs), JOracle(docs)
    do = DenseOracleSearcher(docs, hash_embedder(DIM), device="cpu")
    jdo = JDenseOracle(docs, j_hash_embedder(DIM))
    assert (do.vectors.numpy() == jdo.vectors).all()
    for q in queries:
        s = so.search(q, k=10)
        assert s == jso.search(q, k=10)            # pure Python, same code
        d, jd = do.search(q, k=10), jdo.search(q, k=10)
        qv = hash_embedder(DIM)(q)
        assert_dense_close(qv[None], jdo.vectors, [[v for _, v in d]], [[i for i, _ in d]],
                           [[v for _, v in jd]], [[i for i, _ in jd]])
        assert d == do.search(list(map(float, qv)), k=10)   # vector == text query
        if [i for i, _ in d] == [i for i, _ in jd]:
            assert hybrid_oracle_fuse(s, d, 10) == j_hybrid_fuse(s, jd, 10)
    keys = [["a", "b", "c"], ["c", "d", "a", "e"]]
    assert rrf_fuse(keys, 4) == j_rrf_fuse(keys, 4)
    assert DenseOracleSearcher([], hash_embedder(DIM), device="cpu").search("x") == []
