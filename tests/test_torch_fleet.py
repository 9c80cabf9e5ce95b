"""The partitioned fleet's read path in both packages, end to end through the
gateway: sparse, dense and hybrid ``/search`` over ``ScatterGather``,
single, micro-batched and windowed, with replicas and hedging.

Same ``FleetSpec``, same docs, same runtime seed and the modeled clock
(``sim_exec_s``): responses, modeled latencies, every runtime record and
ledger line and the cache byte counts are exactly equal. Scores: sparse and
hybrid (RRF) exactly equal; dense within ``1e-6 · Σ_d |c_d·q_d|`` with ids
equal except inside the reference's own tolerance ties (the reference's
XLA dot order cannot be reproduced). Inside the port, dense answers equal
the full-corpus oracle bitwise and windowed answers equal serial ones.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import partition as jp
from repro.core.gateway import WindowPolicy as JWindowPolicy
from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.data.corpus import synth_corpus, synth_queries
from repro.search.searcher import SearchConfig as JSearchConfig
from repro.search.service import build_partitioned_search_app as j_build
from repro_torch.core import partition as tp
from repro_torch.core.gateway import WindowPolicy
from repro_torch.core.refresh import generation_version
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.search.oracle import (DenseOracleSearcher, OracleSearcher,
                                       hybrid_oracle_fuse)
from repro_torch.search.searcher import SearchConfig
from repro_torch.search.service import build_partitioned_search_app as t_build


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 10
DIM = 16
TOL = 1e-6
CONFIGS = {
    "eager-dense": {"lazy_hydration": False},
    "lazy-pruned+kernels": {"accumulator": "pruned", "use_kernel": True,
                            "use_topk_kernel": True},
}


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(300, vocab=500, seed=21)


@pytest.fixture(scope="module")
def queries(corpus):
    return synth_queries(corpus, 12, seed=23)


def _spec(pkg, *, n_parts=3, vector=True, replication=None, gateway=None, **cfg):
    """The same FleetSpec in either package (``pkg`` is a partition module)."""
    j = pkg is jp
    return pkg.FleetSpec(
        n_parts=n_parts,
        replication=replication or pkg.ReplicationSpec(),
        gateway=gateway or pkg.GatewaySpec(),
        index=pkg.IndexSpec(vector=pkg.VectorSpec(dim=DIM) if vector else None),
        runtime_config=(JRuntimeConfig if j else RuntimeConfig)(seed=0),
        search_config=(JSearchConfig if j else SearchConfig)(sim_exec_s=0.002, **cfg))


def _apps(corpus, **kw):
    j = j_build(corpus, _spec(jp, **kw))
    t = t_build(corpus, _spec(tp, **kw), device="cpu")
    return j, t


def _dense_close(app, got, want, text):
    """Dense scores within TOL · Σ_d |c_d·q_d| (the reference's returned
    rows, the query embedded from ``text``); ids equal unless the
    reference's scores tie within tolerance."""
    q = np.asarray(app.embedder(text), np.float64)
    emb = {e: np.asarray(app.embedder(app.doc_store.get(e)["contents"]), np.float64)
           for e in want["ext_ids"]}
    tol = [TOL * np.abs(emb[e] * q).sum() for e in want["ext_ids"]]
    assert np.all(np.abs(np.subtract(got["scores"], want["scores"])) <= tol)
    for r, (g, w) in enumerate(zip(got["ext_ids"], want["ext_ids"])):
        if g != w:
            near = [e for e, s in zip(want["ext_ids"], want["scores"])
                    if abs(s - want["scores"][r]) <= tol[r]]
            assert len(near) > 1 and g in near, (r, g, w)


def _same_result(app, got, want, mode, text):
    assert len(got["ids"]) == len(want["ids"])
    assert got["docs"] == want["docs"]
    if mode == "dense":
        _dense_close(app, got, want, text)
    else:
        assert got["ids"] == want["ids"] and got["ext_ids"] == want["ext_ids"]
        assert got["scores"] == want["scores"]


def _same_response(app, got, want, mode, texts):
    assert (got.status, got.latency_s) == (want.status, want.latency_s), got.body
    assert got.body.get("partitions") == want.body.get("partitions")
    assert got.body.get("generation") == want.body.get("generation")
    if "results" in want.body:
        assert len(got.body["results"]) == len(want.body["results"])
        for g, w, text in zip(got.body["results"], want.body["results"], texts):
            _same_result(app, g, w, mode, text)
    elif want.status == 200:
        _same_result(app, got.body, want.body, mode, texts[0])
    else:
        assert got.body == want.body


def _same_runtime(t, j):
    for a, b in zip(t.runtime.records, j.runtime.records, strict=True):
        assert (a.fn, a.cold, a.provisioned, a.hydrate_s, a.backfill_s, a.latency_s,
                a.exec_s, a.t_arrival, a.t_done, a.hedged) == (
            b.fn, b.cold, b.provisioned, b.hydrate_s, b.backfill_s, b.latency_s,
            b.exec_s, b.t_arrival, b.t_done, b.hedged)
    assert dataclasses.asdict(t.runtime.ledger) == dataclasses.asdict(j.runtime.ledger)
    assert ([i.cache.used_bytes for i in t.runtime._instances]
            == [i.cache.used_bytes for i in j.runtime._instances])
    assert sorted(t.runtime._handlers) == sorted(j.runtime._handlers)


@pytest.mark.parametrize("mode", ["sparse", "dense", "hybrid"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fleet_matches_reference(corpus, queries, config, mode):
    j, t = _apps(corpus, **CONFIGS[config])
    calls = [queries[0]] + queries[1:5] + [queries[:6], "zzz unknown-term"]
    for i, q in enumerate(calls):
        at = 1.0 + 0.05 * i
        got = t.query(q, k=K, mode=mode, t_arrival=at)
        want = j.query(q, k=K, mode=mode, t_arrival=at)
        _same_response(t, got, want, mode, [q] if isinstance(q, str) else q)
        if i == 0:
            assert got.body["ids"] and got.body["partitions"][0]["cold"]
    if mode != "sparse":                               # a vector-only query
        qv = [float(x) for x in t.embedder("tail latency")]
        got = t.query(None, k=5, mode="dense", vector=qv, t_arrival=2.0)
        want = j.query(None, k=5, mode="dense", vector=qv, t_arrival=2.0)
        _same_response(t, got, want, "dense", ["tail latency"])
    _same_runtime(t, j)


def test_replicated_hedged_fleet_matches_reference(corpus, queries):
    """replicas=2 behind a quantile HedgePolicy, one partition's primary
    pool killed every few queries: the same backups fire at the same
    instants, and every response, record and ledger line (hedge tax
    included) equals the reference's."""
    j = j_build(corpus, _spec(jp, replication=jp.ReplicationSpec(
        replicas=2, hedge=jp.HedgePolicy())))
    t = t_build(corpus, _spec(tp, replication=tp.ReplicationSpec(
        replicas=2, hedge=tp.HedgePolicy())), device="cpu")
    assert t.fn_groups == j.fn_groups
    for app in (t, j):
        app.warm()
    for i, q in enumerate(queries):
        if i % 4 == 3:
            assert t.runtime.kill_instance(fn=t.fn_names[0])
            assert j.runtime.kill_instance(fn=j.fn_names[0])
        mode = ("sparse", "hybrid", "dense")[i % 3]
        at = t.runtime.clock + 0.05
        _same_response(t, t.query(q, k=K, mode=mode, t_arrival=at),
                       j.query(q, k=K, mode=mode, t_arrival=at), mode, [q])
    assert any(r.hedged for r in t.runtime.records)
    _same_runtime(t, j)


def test_windowed_matches_reference_and_serial(corpus, queries):
    """Sparse, dense and hybrid admissions coalescing in one window: the
    port answers what the reference answers, and each answer is bitwise
    the serial per-query dispatch's (K4's Q-invariance at fleet level)."""
    pol = dict(max_window_s=0.08, target_batch=8, sparse_qps=2.0, p99_budget_s=2.0)
    j = j_build(corpus, _spec(jp, gateway=jp.GatewaySpec(window=JWindowPolicy(**pol))))
    t = t_build(corpus, _spec(tp, gateway=tp.GatewaySpec(window=WindowPolicy(**pol))),
                device="cpu")
    serial = t_build(corpus, _spec(tp), device="cpu")
    for app in (t, j, serial):
        app.warm()
    t0 = t.runtime.clock + 2.0
    subs = [(q, m) for q in queries[:6] for m in ("sparse", "dense", "hybrid")]
    th = [t.submit(q, k=K, mode=m, t_arrival=t0 + i * 0.001, fetch_docs=False)
          for i, (q, m) in enumerate(subs)]
    jh = [j.submit(q, k=K, mode=m, t_arrival=t0 + i * 0.001, fetch_docs=False)
          for i, (q, m) in enumerate(subs)]
    t.flush(), j.flush()
    for (q, m), a, b in zip(subs, th, jh):
        _same_response(t, a.response, b.response, m, [q])
        want = serial.query(q, k=K, mode=m, t_arrival=serial.runtime.clock + 0.05,
                            fetch_docs=False)
        assert a.response.body["ext_ids"] == want.body["ext_ids"], (q, m)
        assert (np.float32(a.response.body["scores"]).view(np.uint32).tolist()
                == np.float32(want.body["scores"]).view(np.uint32).tolist())
    _same_runtime(t, j)


def test_dense_and_hybrid_match_port_oracles(corpus, queries):
    """Inside the port: dense answers are the full-corpus oracle's ids and
    score bits (any partition size), hybrid is ``hybrid_oracle_fuse`` of the
    two oracles, sparse the BM25 oracle's ids."""
    for n_parts in (2, 4):
        t = t_build(corpus, _spec(tp, n_parts=n_parts), device="cpu")
        live = t.indexer.live_corpus()
        so = OracleSearcher(live)
        do = DenseOracleSearcher(live, t.embedder, device="cpu")
        for q in queries[:6]:
            s_want, d_want = so.search(q, k=t.search_k), do.search(q, k=t.search_k)
            r = t.query(q, k=K, mode="dense", fetch_docs=False)
            assert r.body["ext_ids"] == [do.doc_ids[d] for d, _ in d_want[:K]]
            assert (np.float32(r.body["scores"]).view(np.uint32).tolist()
                    == np.float32([v for _, v in d_want[:K]]).view(np.uint32).tolist())
            r = t.query(q, k=K, mode="hybrid", fetch_docs=False)
            fused = hybrid_oracle_fuse(s_want, d_want, K)
            assert r.body["ext_ids"] == [so.doc_ids[d] for d, _ in fused]
            assert r.body["scores"] == [v for _, v in fused]
            r = t.query(q, k=K, fetch_docs=False)
            assert r.body["ext_ids"] == [so.doc_ids[d] for d, _ in s_want[:K]]


def test_cross_tier_generation_skew_raises(corpus, queries):
    """A leg whose dense tier answers from another generation than the
    sparse tiers around it fails the scatter (502), as in the reference."""
    t = t_build(corpus, _spec(tp, n_parts=2), device="cpu")
    q = queries[0]
    assert t.query(q, k=5, mode="hybrid").ok
    assert t.scatter.last_versions == [generation_version(1)]
    orig = t.runtime.invoke
    state = {"armed": True}

    def invoke(fn, payload, **kw):
        result, rec = orig(fn, payload, **kw)
        if state["armed"] and fn.startswith("search-"):
            state["armed"] = False
            result = dict(result, vec_version="g999999")
        return result, rec

    t.runtime.invoke = invoke
    r = t.query(q, k=5, mode="hybrid", t_arrival=t.runtime.clock + 0.05)
    assert r.status == 502 and "g999999" in r.body["error"]


@pytest.mark.parametrize("body,vector", [
    ({"q": "bi", "mode": "dense"}, False), ({"q": "bi", "mode": "hybrid"}, False),
    *[(b, v) for v in (False, True) for b in (
        {"q": "bi", "mode": "nonsense"}, {"k": 3}, {"queries": []}, {"sq": "title:bi"},
        {"sq": "bi", "mode": "dense"}, {"mode": "hybrid", "qv": [0.0] * DIM})]])
def test_bad_requests_match_reference(corpus, body, vector):
    """Every body the fleet cannot serve is the reference's 400 (a sparse
    fleet asked for a dense mode, a structured query, an empty batch)."""
    j, t = _apps(corpus[:60], n_parts=2, vector=vector)
    got = t.gateway.request("GET", "/search", dict(body))
    want = j.gateway.request("GET", "/search", dict(body))
    assert (got.status, got.body, got.latency_s) == (want.status, want.body, want.latency_s)
    assert got.status == 400


# -- the FleetSpec surface (the ports of tests/test_fleetspec.py) ------------------


def test_spec_validates_fields():
    for pkg in (tp, jp):
        for make in (lambda: pkg.FleetSpec(n_parts=0),
                     lambda: pkg.ReplicationSpec(replicas=0),
                     lambda: pkg.GatewaySpec(routing="clever"),
                     lambda: pkg.VectorSpec(dim=0),
                     lambda: pkg.VectorSpec(dtype="float64"),
                     lambda: pkg.FleetSpec(n_parts=3, index=pkg.IndexSpec(
                         partition_weights=[1.0, 2.0])),
                     lambda: pkg.FleetSpec(n_parts=2, index=pkg.IndexSpec(
                         partition_weights=[1.0, -1.0]))):
            with pytest.raises(ValueError):
                make()
    spec = tp.ReplicationSpec(replicas=2, hedge=0.25)
    assert isinstance(spec.hedge, tp.HedgePolicy) and spec.hedge.after_s == 0.25


def test_legacy_kwargs_and_positional_int(corpus, queries):
    """The deprecated keyword sprawl warns and builds the same fleet; a bare
    int is ``n_parts`` without a warning; mixing both surfaces is an error."""
    cfg = SearchConfig(sim_exec_s=0.002)
    spec_app = t_build(corpus, tp.FleetSpec(
        n_parts=2, replication=tp.ReplicationSpec(replicas=2, hedge=tp.HedgePolicy()),
        runtime_config=RuntimeConfig(), search_config=cfg), device="cpu")
    with pytest.warns(DeprecationWarning):
        legacy = t_build(corpus, n_parts=2, replicas=2, hedge=tp.HedgePolicy(),
                         runtime_config=RuntimeConfig(), search_config=cfg, device="cpu")
    r1 = spec_app.query(queries[0], k=K, fetch_docs=False)
    r2 = legacy.query(queries[0], k=K, fetch_docs=False)
    assert r1.body["ext_ids"] == r2.body["ext_ids"] and r1.body["scores"] == r2.body["scores"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t_build(corpus[:40], 3, search_config=cfg, device="cpu").n_parts == 3
    with pytest.raises(TypeError):
        t_build(corpus[:40], tp.FleetSpec(n_parts=2), replicas=2, device="cpu")


def test_fleet_defaults_to_lazy_hydration(corpus, queries):
    lazy = t_build(corpus, _spec(tp, n_parts=2, vector=False), device="cpu")
    eager = t_build(corpus, _spec(tp, n_parts=2, vector=False, lazy_hydration=False),
                    device="cpu")
    r, r2 = (a.query(queries[0], k=K, fetch_docs=False) for a in (lazy, eager))
    assert lazy.runtime.ledger.backfill_gb_seconds > 0
    assert eager.runtime.ledger.backfill_gb_seconds == 0
    assert r.body["ext_ids"] == r2.body["ext_ids"]
    assert (np.float32(r.body["scores"]).view(np.uint32).tolist()
            == np.float32(r2.body["scores"]).view(np.uint32).tolist())
