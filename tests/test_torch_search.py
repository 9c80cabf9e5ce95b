"""The port's scoring core against ``repro.search.bm25`` on the same packed
index, and the reference's bitwise invariants re-pinned inside the port.

Both packages score the reference ``IndexWriter.pack`` output. Across
packages: ids equal (except inside a group of reference scores tied within
the tolerance), scores at ``rtol=1e-6, atol=0``. Inside the port, pruned ==
dense bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.corpus import synth_corpus, synth_queries
from repro.index.builder import IndexWriter
from repro.search import bm25 as jbm25
from repro_torch.search import bm25 as tbm25
from repro_torch.search.searcher import SearchConfig, Searcher
from test_torch_kernels import assert_topk_close

K = 10


@pytest.fixture(scope="module")
def corpus():
    # 300 docs / vocab 500: every term's postings fit 64 blocks × 128 lanes
    return synth_corpus(300, vocab=500, seed=21)


@pytest.fixture(scope="module")
def packed(corpus):
    w = IndexWriter()
    w.add_many(corpus)
    return w.pack()


@pytest.fixture(scope="module")
def encoded(corpus, packed):
    queries = synth_queries(corpus, 12, seed=23) + ["", "zzz unknown"]
    return jbm25.encode_queries(packed.vocab, queries, max_terms=16, idf=packed.idf)


def _both(packed, tids, qtf, **kw):
    n = packed.meta.n_docs
    jfn = jax.jit(jbm25.make_search_fn(n, max_terms=16, **kw))
    want = tuple(map(np.asarray, jfn(jbm25.SearchState.from_packed(packed), tids, qtf)))
    tfn = tbm25.make_search_fn(n, max_terms=16, **kw)
    got = tuple(x.numpy() for x in tfn(tbm25.SearchState.from_packed(packed, "cpu"), tids, qtf))
    return got, want


@pytest.mark.parametrize("accumulator", ["dense", "sorted", "pruned"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("use_topk_kernel", [False, True])
def test_make_search_fn_matches_reference(packed, encoded, accumulator, use_kernel,
                                          use_topk_kernel):
    (gv, gi), (wv, wi) = _both(packed, *encoded, max_blocks=64, k=K,
                               accumulator=accumulator, use_kernel=use_kernel,
                               use_topk_kernel=use_topk_kernel)
    assert gv.dtype == np.float32 and gi.dtype == np.int32 and gv.shape == wv.shape
    for q in range(len(gv)):
        assert_topk_close(gv[q], gi[q], wv[q], wi[q])


@pytest.mark.parametrize("accumulator", ["dense", "sorted", "pruned"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_k_exceeds_n_docs_clamp_and_pad(accumulator, use_kernel):
    """k = 12 over a 7-doc index: both packages clamp to 7, then pad."""
    docs = synth_corpus(7, vocab=30, seed=4)
    w = IndexWriter()
    w.add_many(docs)
    p = w.pack()
    tids, qtf = jbm25.encode_queries(p.vocab, synth_queries(docs, 3, seed=5), max_terms=16)
    (gv, gi), (wv, wi) = _both(p, tids, qtf, max_blocks=4, k=12, accumulator=accumulator,
                               use_kernel=use_kernel, use_topk_kernel=use_kernel)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=0)
    assert gv.shape == (3, 12)
    if accumulator != "sorted":                 # clamp to n_docs, then pad
        assert np.all(gi[:, 7:] == 7) and np.all(gv[:, 7:] == 0.0)


def _search_bits(searcher, queries):
    vals, ids = searcher.search(queries)
    return vals.view(np.uint32), ids


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("max_blocks", [64, 2])
def test_pruned_bit_identical_to_dense(packed, corpus, use_kernel, max_blocks):
    """Inside the port: ``accumulator="pruned"`` (plain path and kernel twin)
    returns the dense path's exact bits, also when M truncates some terms."""
    queries = synth_queries(corpus, 12, seed=23)
    dense = Searcher(packed, SearchConfig(max_blocks=max_blocks, k=K), device="cpu")
    pruned = Searcher(packed, SearchConfig(max_blocks=max_blocks, k=K, accumulator="pruned",
                                           use_kernel=use_kernel,
                                           use_topk_kernel=use_kernel), device="cpu")
    dv, di = _search_bits(dense, queries)
    pv, pi = _search_bits(pruned, queries)
    np.testing.assert_array_equal(dv, pv)
    np.testing.assert_array_equal(di, pi)


def test_dense_scores_independent_of_batch(packed, corpus):
    """A query's bits do not depend on its batch neighbours or batch size."""
    queries = synth_queries(corpus, 9, seed=31)
    s = Searcher(packed, SearchConfig(k=K), device="cpu")
    bv, bi = _search_bits(s, queries)
    for q in range(len(queries)):
        v, i = _search_bits(s, [queries[q]])
        np.testing.assert_array_equal(v[0], bv[q])
        np.testing.assert_array_equal(i[0], bi[q])


def test_search_state_from_reference_pack(packed):
    """``SearchState.from_packed`` takes the JAX package's PackedIndex and
    keeps its dtypes and shapes."""
    st = tbm25.SearchState.from_packed(packed, "cpu")
    for name in ("term_offsets", "block_docs", "block_tf", "block_max", "doc_len", "idf"):
        a = getattr(packed, name)
        t = getattr(st, name)
        assert t.device.type == "cpu" and tuple(t.shape) == a.shape
        assert t.numpy().dtype == a.dtype
        np.testing.assert_array_equal(t.numpy(), a)
    assert st.n_docs == packed.meta.n_docs
    assert st.params == tuple(float(np.float32(x)) for x in
                              (packed.meta.k1, packed.meta.b, packed.meta.avgdl))


def test_compact_uint16_doc_ids_widen_at_gather(packed, encoded):
    """uint16 block_docs gather to the same int32 ids as int32 storage."""
    st = tbm25.SearchState.from_packed(packed, "cpu")
    tids = torch.as_tensor(encoded[0])
    want = tbm25.gather_query_blocks(st, tids, 8)[0]
    st.block_docs = st.block_docs.to(torch.uint16)
    got = tbm25.gather_query_blocks(st, tids, 8)[0]
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_unknown_accumulator_raises(packed, encoded):
    fn = tbm25.make_search_fn(packed.meta.n_docs, max_terms=16, max_blocks=4, k=K,
                              accumulator="nope")
    with pytest.raises(ValueError, match="unknown accumulator"):
        fn(tbm25.SearchState.from_packed(packed, "cpu"), *encoded)


def test_encode_queries_matches_reference(packed, corpus):
    queries = synth_queries(corpus, 20, terms_per_query=20, seed=3)
    for max_terms in (4, 16):
        want = jbm25.encode_queries(packed.vocab, queries, max_terms=max_terms, idf=packed.idf)
        got = tbm25.encode_queries(packed.vocab, queries, max_terms=max_terms, idf=packed.idf)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
