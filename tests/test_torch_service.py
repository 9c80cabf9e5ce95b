"""``build_search_app`` in both packages, end to end through the gateway.

Same corpus, same modeled clock (``sim_exec_s``), same runtime seed: every
response, modeled latency, hydration charge, ledger line and cache byte
count must match; scores at ``rtol=1e-6``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.data.corpus import synth_corpus, synth_queries
from repro.search.searcher import SearchConfig as JSearchConfig
from repro.search.service import build_search_app as j_build
from repro_torch.core.runtime import RuntimeConfig as TRuntimeConfig
from repro_torch.search.searcher import SearchConfig as TSearchConfig
from repro_torch.search.service import build_search_app as t_build


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = {
    "dense": {},
    "pruned+kernels": {"accumulator": "pruned", "use_kernel": True, "use_topk_kernel": True},
}


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(400, vocab=600, seed=2)


def _apps(corpus, **cfg):
    j = j_build(corpus, search_config=JSearchConfig(sim_exec_s=0.01, **cfg),
                runtime_config=JRuntimeConfig(seed=0))
    t = t_build(corpus, search_config=TSearchConfig(sim_exec_s=0.01, **cfg),
                runtime_config=TRuntimeConfig(seed=0), device="cpu")
    return j, t


def _assert_same_result(got, want):
    for key in ("ids", "ext_ids", "docs"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6, atol=0)


def _assert_same_response(got, want):
    assert got.status == want.status
    assert got.latency_s == want.latency_s
    if "results" in want.body:
        assert got.body["version"] == want.body["version"]
        assert len(got.body["results"]) == len(want.body["results"])
        for g, w in zip(got.body["results"], want.body["results"]):
            _assert_same_result(g, w)
    else:
        assert got.body["version"] == want.body["version"]
        _assert_same_result(got.body, want.body)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_app_matches_reference(corpus, name):
    j, t = _apps(corpus, **CONFIGS[name])
    queries = synth_queries(corpus, 8, seed=5)
    calls = [queries[0]] + queries[1:6] + [queries[:5], "zzz unknown-term"]
    for q in calls:
        got = t.query(q, k=10)
        _assert_same_response(got, j.query(q, k=10))
        if q is calls[0]:
            assert got.body["ids"]                         # non-trivial hits

    jr, tr = j.runtime.records, t.runtime.records
    assert len(jr) == len(tr)
    for a, b in zip(tr, jr):
        assert (a.fn, a.cold, a.provisioned, a.hydrate_s, a.latency_s, a.exec_s,
                a.t_arrival, a.t_done) == (b.fn, b.cold, b.provisioned, b.hydrate_s,
                                           b.latency_s, b.exec_s, b.t_arrival, b.t_done)
    assert [r.cold for r in tr] == [True] + [False] * (len(tr) - 1)
    assert dataclasses.asdict(t.runtime.ledger) == dataclasses.asdict(j.runtime.ledger)
    # the reference accounts an eager Searcher as 0 cache bytes; so does the port
    jb = [i.cache.used_bytes for i in j.runtime._instances]
    tb = [i.cache.used_bytes for i in t.runtime._instances]
    assert tb == jb == [0]


def test_probes_match_reference(corpus):
    j, t = _apps(corpus)
    for method, path, body in (("GET", "/nope", {"q": "bi"}), ("GET", "/search", {"k": 3})):
        a = t.gateway.request(method, path, body)
        b = j.gateway.request(method, path, body)
        assert (a.status, a.latency_s) == (b.status, b.latency_s)
        assert a.status in (404, 502)
    assert t.gateway.request("GET", "/nope", {}).status == 404
    assert t.gateway.request("GET", "/search", {"k": 3}).status == 502


def test_dense_payloads_on_single_app_match_reference(corpus):
    """The single-function app has no dense tier: dense and hybrid payloads
    raise ``DenseTierMissing`` in both packages, and the gateway answers
    502 at the same modeled latency."""
    from repro.core.cache import HydrationCache as JHydrationCache
    from repro.search.searcher import DenseTierMissing as JDenseTierMissing
    from repro_torch.core.cache import HydrationCache
    from repro_torch.search.searcher import DenseTierMissing
    j = j_build(corpus[:50], search_config=JSearchConfig(sim_exec_s=0.01))
    t = t_build(corpus[:50], search_config=TSearchConfig(sim_exec_s=0.01), device="cpu")
    handler, j_handler = t.runtime._handlers["search"], j.runtime._handlers["search"]
    cache, j_cache = HydrationCache(1 << 30), JHydrationCache(1 << 30)
    for payload in ({"q": "bi", "mode": "dense", "qv": [0.0] * 16},
                    {"q": "bi", "mode": "hybrid", "qv": [0.0] * 16}):
        with pytest.raises(DenseTierMissing):
            handler(cache, payload)
        with pytest.raises(JDenseTierMissing):
            j_handler(j_cache, payload)
    resp = t.gateway.request("GET", "/search", {"q": "bi", "mode": "dense"})
    want = j.gateway.request("GET", "/search", {"q": "bi", "mode": "dense"})
    assert (resp.status, resp.latency_s) == (want.status, want.latency_s) == (502, want.latency_s)


def test_prewarm_and_lazy_hydration_match_reference(corpus):
    """A prewarm ping answers as the reference's, and a lazily hydrating
    app serves the same responses and ledger."""
    from repro.core.cache import HydrationCache as JHydrationCache
    from repro_torch.core.cache import HydrationCache
    j = j_build(corpus[:50], search_config=JSearchConfig(sim_exec_s=0.01))
    t = t_build(corpus[:50], search_config=TSearchConfig(sim_exec_s=0.01), device="cpu")
    handler, j_handler = t.runtime._handlers["search"], j.runtime._handlers["search"]
    cache, j_cache = HydrationCache(1 << 30), JHydrationCache(1 << 30)
    assert handler(cache, {"prewarm_terms": 8}) == j_handler(j_cache, {"prewarm_terms": 8})
    j_lazy, t_lazy = _apps(corpus, lazy_hydration=True)
    for q in ("bi", ["bi bo", "zzz"]):
        _assert_same_response(t_lazy.query(q, k=10), j_lazy.query(q, k=10))
    assert dataclasses.asdict(t_lazy.runtime.ledger) == dataclasses.asdict(j_lazy.runtime.ledger)


def test_generation_manifest_matches_reference(corpus):
    """An NRT generation (base + deltas) published behind the app is served
    — fused under the manifest's stats — exactly as the reference serves
    it."""
    from repro.core.refresh import GenerationManifest as JGenerationManifest
    from repro.index.builder import IndexWriter as JIndexWriter
    from repro.index.builder import compute_global_stats as j_stats
    from repro.index.builder import global_vocab as j_vocab
    from repro.index.builder import write_segment as j_write
    from repro_torch.core.refresh import GenerationManifest
    from repro_torch.index.builder import (IndexWriter, compute_global_stats, global_vocab,
                                           write_segment)
    docs = corpus[:50]
    j = j_build(docs, search_config=JSearchConfig(sim_exec_s=0.01))
    t = t_build(docs, search_config=TSearchConfig(sim_exec_s=0.01), device="cpu")
    for app, writer, write, manifest, stats, vocab in (
            (t, IndexWriter, write_segment, GenerationManifest, compute_global_stats,
             global_vocab),
            (j, JIndexWriter, j_write, JGenerationManifest, j_stats, j_vocab)):
        assert app.query("bi", k=3).status == 200
        w = writer(global_stats=stats(docs[:30]), vocab=vocab(stats(docs)))
        w.add_many(docs[:30])
        base = w.pack()
        delta = writer.delta(docs[30:], stats(docs[:30]), vocab=base.vocab)
        app.catalog.publish_segment("index", "s0", write(base))
        app.catalog.publish_segment("index", "s1", write(delta))
        app.catalog.publish_generation("index", manifest(
            gen=1, base="s0", deltas=["s1"], tombstones=[2, 40],
            stats=stats([d for i, d in enumerate(docs) if i not in (2, 40)]),
            vocab=delta.vocab))
    for q in ("bi", "bo ma", ["bi", "zzz"]):
        got, want = t.query(q, k=5), j.query(q, k=5)
        assert got.status == 200 and got.body.get("version") == "gen-000001"
        _assert_same_response(got, want)
