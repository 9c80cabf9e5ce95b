"""The port's Crane & Lin baseline (``repro_torch.baselines.kvstore_search``)
against the JAX package's: on the same ``synth_corpus`` the built KV items
are equal, and every query's hits (doc ids and float scores) and modeled
latency ``sim_s`` are equal exactly — the same Python floats in the same
order, since both are plain Python over the same tokens."""

import dataclasses

import pytest

from repro.baselines import kvstore_search as jkv
from repro.core.kvstore import KVModel as JKVModel, KVStore as JKVStore
from repro.data.corpus import synth_corpus, synth_queries
from repro_torch.baselines import kvstore_search as tkv
from repro_torch.core.kvstore import KVModel, KVStore
from repro_torch.data import corpus as tcorpus

N_DOCS, VOCAB, N_QUERIES = 600, 1_000, 40


@pytest.fixture(scope="module")
def corpus():
    docs = synth_corpus(N_DOCS, vocab=VOCAB, seed=0)
    queries = synth_queries(docs, N_QUERIES, seed=2)
    # an empty query, an unknown term, a repeated term (qtf 2)
    queries += ["", "zzzz", f"{queries[0]} {queries[0]}"]
    return docs, queries


@pytest.fixture(scope="module")
def built(corpus):
    docs, _ = corpus
    want, got = jkv.KVPostingsIndex(), tkv.KVPostingsIndex()
    want.build(docs)
    got.build(docs)
    return want, got


def test_the_corpus_is_the_reference_s(corpus):
    docs, queries = corpus
    assert tcorpus.synth_corpus(N_DOCS, vocab=VOCAB, seed=0) == docs
    assert tcorpus.synth_queries(docs, N_QUERIES, seed=2) == queries[:N_QUERIES]


def test_config_defaults_equal():
    assert dataclasses.asdict(tkv.KVPostingsConfig()) == dataclasses.asdict(
        jkv.KVPostingsConfig())


def test_build_writes_the_reference_items(built):
    want, got = built
    assert (got.n_docs, got.avgdl) == (want.n_docs, want.avgdl)
    keys = sorted(want.kv._items)
    assert sorted(got.kv._items) == keys and "__stats__" in keys
    for key in keys:
        assert got.kv.get(key) == want.kv.get(key), key


@pytest.mark.parametrize("k", [1, 10, 100])
def test_search_hits_and_sim_s_equal(built, corpus, k):
    want, got = built
    for q in corpus[1]:
        (wh, ws), (gh, gs) = want.search(q, k=k), got.search(q, k=k)
        assert gh == wh, q
        assert gs == ws, q
        assert all(type(s) is float for _, s in gh)


def test_a_store_and_config_of_the_caller_s(corpus):
    """A caller's store latency model and scoring config reach the search."""
    docs, queries = corpus
    kw = dict(k1=1.2, b=0.75, value_Bps=1e6, item_page_bytes=1 << 10)
    want = jkv.KVPostingsIndex(JKVStore(JKVModel(get_s=0.02)), jkv.KVPostingsConfig(**kw))
    got = tkv.KVPostingsIndex(KVStore(KVModel(get_s=0.02)), tkv.KVPostingsConfig(**kw))
    want.build(docs[:200])
    got.build(docs[:200])
    for q in queries:
        assert got.search(q) == want.search(q), q
