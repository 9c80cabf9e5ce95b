"""``build_search_app`` in both packages, end to end through the gateway.

Same corpus, same modeled clock (``sim_exec_s``), same runtime seed: every
response, modeled latency, hydration charge, ledger line and cache byte
count must match; scores at ``rtol=1e-6``. What the port does not serve
yet raises ``NotImplementedError`` — it never answers another way.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.data.corpus import synth_corpus, synth_queries
from repro.search.searcher import SearchConfig as JSearchConfig
from repro.search.service import build_search_app as j_build
from repro_torch.core.runtime import RuntimeConfig as TRuntimeConfig
from repro_torch.search.searcher import SearchConfig as TSearchConfig
from repro_torch.search.service import build_search_app as t_build

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


def test_unported_paths_raise_not_implemented(corpus):
    t = t_build(corpus[:50], search_config=TSearchConfig(sim_exec_s=0.01), device="cpu")
    handler = t.runtime._handlers["search"]
    from repro_torch.core.cache import HydrationCache
    cache = HydrationCache(1 << 30)
    for payload in ({"q": "bi", "mode": "dense", "qv": [0.0] * 16},
                    {"q": "bi", "mode": "hybrid", "qv": [0.0] * 16},
                    {"sq": {"op": "term", "term": "bi"}},
                    {"prewarm_terms": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            handler(cache, payload)
    resp = t.gateway.request("GET", "/search", {"q": "bi", "mode": "dense"})
    assert resp.status == 502 and "not ported" in resp.body["error"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        t_build(corpus[:50], search_config=TSearchConfig(lazy_hydration=True), device="cpu")


def test_generation_manifest_raises_not_implemented(corpus):
    """An NRT generation (base + deltas) is refused until the write path is
    ported, not served from some other state."""
    from repro_torch.core.refresh import GenerationManifest
    from repro_torch.index.builder import IndexWriter, compute_global_stats, write_segment
    docs = corpus[:50]
    t = t_build(docs, search_config=TSearchConfig(sim_exec_s=0.01), device="cpu")
    assert t.query("bi", k=3).status == 200
    w = IndexWriter()
    w.add_many(docs)
    packed = w.pack()
    t.catalog.publish_segment("index", "s0", write_segment(packed))
    t.catalog.publish_generation("index", GenerationManifest(
        gen=1, base="s0", deltas=[], tombstones=[],
        stats=compute_global_stats(docs), vocab=packed.vocab))
    resp = t.query("bi", k=3)
    assert resp.status == 502 and "ROADMAP Queue 1 item 5" in resp.body["error"]
