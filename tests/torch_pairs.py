"""Both packages behind one namespace each, for the port's parity tests of
the structured tier and the fleet's write path.

``J`` holds the JAX package's names, ``T`` the port's, with every entry
point of the port bound to ``device="cpu"``: a scenario written once as
``scenario(P)`` runs on both, and the comparators below hold the port's
responses, runtime records, ledger and cache bytes to the reference's.
"""

import dataclasses
import functools
import importlib
import types

import numpy as np


def _namespace(pkg: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    part, gw, rt = mod("core.partition"), mod("core.gateway"), mod("core.runtime")
    refresh, builder, oracle = mod("core.refresh"), mod("index.builder"), mod("search.oracle")
    searcher, service, autoscale = mod("search.searcher"), mod("search.service"), mod("core.autoscale")
    cost, store, directory = mod("core.cost"), mod("core.object_store"), mod("core.directory")
    query, structured, cache = mod("search.query"), mod("search.structured"), mod("core.cache")
    on_cpu = pkg == "repro_torch"

    def cpu(fn):
        return functools.partial(fn, device="cpu") if on_cpu else fn

    return types.SimpleNamespace(
        torch=on_cpu,
        FleetSpec=part.FleetSpec, ReplicationSpec=part.ReplicationSpec,
        GatewaySpec=part.GatewaySpec, IndexSpec=part.IndexSpec,
        VectorSpec=part.VectorSpec, HedgePolicy=part.HedgePolicy,
        ScatterGather=part.ScatterGather, rrf_fuse=part.rrf_fuse,
        WindowPolicy=gw.WindowPolicy, Gateway=gw.Gateway,
        RuntimeConfig=rt.RuntimeConfig, FaaSRuntime=rt.FaaSRuntime,
        RetryPolicy=rt.RetryPolicy, RetriesExhausted=rt.RetriesExhausted,
        RuntimeError_=rt.RuntimeError_,
        AssetCatalog=refresh.AssetCatalog, GenerationManifest=refresh.GenerationManifest,
        PublishConflict=refresh.PublishConflict,
        generation_version=refresh.generation_version,
        ObjectStore=store.ObjectStore, RamDirectory=directory.RamDirectory,
        IndexWriter=builder.IndexWriter, MergePolicy=builder.MergePolicy,
        combine_segments=builder.combine_segments,
        compute_global_stats=builder.compute_global_stats,
        extend_vocab=builder.extend_vocab, global_vocab=builder.global_vocab,
        update_stats=builder.update_stats, field_avgdl=builder.field_avgdl,
        SearchConfig=searcher.SearchConfig, Searcher=cpu(searcher.Searcher),
        HydrationCache=cache.HydrationCache,
        OracleSearcher=oracle.OracleSearcher,
        DenseOracleSearcher=cpu(oracle.DenseOracleSearcher),
        StructuredOracleSearcher=cpu(oracle.StructuredOracleSearcher),
        hybrid_oracle_fuse=oracle.hybrid_oracle_fuse,
        AutoscalePolicy=autoscale.AutoscalePolicy,
        FleetController=autoscale.FleetController,
        CostLedger=cost.CostLedger, Invocation=cost.Invocation,
        parse_query=query.parse_query, QueryParseError=query.QueryParseError,
        query_from_payload=query.query_from_payload,
        structured=structured,
        build=cpu(service.build_partitioned_search_app),
    )


J = _namespace("repro")
T = _namespace("repro_torch")
PACKAGES = (J, T)


def bits(scores) -> list:
    return np.float32(scores).view(np.uint32).tolist()


def same_runtime(t, j) -> None:
    """Every invocation record, the ledger, each instance's cache bytes and
    the registered functions equal the reference's."""
    for a, b in zip(t.runtime.records, j.runtime.records, strict=True):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        del a["instance_id"], b["instance_id"]     # a process-wide counter
        assert a == b, (a, b)
    assert dataclasses.asdict(t.runtime.ledger) == dataclasses.asdict(j.runtime.ledger)
    assert ([i.cache.used_bytes for i in t.runtime._instances]
            == [i.cache.used_bytes for i in j.runtime._instances])
    assert sorted(t.runtime._handlers) == sorted(j.runtime._handlers)


def _dense_close(app, got, want, text, doc_text=None, tol=1e-6):
    """Dense scores within ``tol · Σ_d |c_d·q_d|``; ids equal unless the
    reference's scores tie within that tolerance (its XLA dot order cannot
    be reproduced). ``doc_text`` maps ext ids to texts (default: the app's
    doc store, which no longer holds documents deleted since)."""
    q = np.asarray(app.embedder(text), np.float64)
    if doc_text is None:
        doc_text = {e: app.doc_store.get(e)["contents"] for e in want["ext_ids"]}
    emb = {e: np.asarray(app.embedder(doc_text[e]), np.float64) for e in want["ext_ids"]}
    lim = [tol * np.abs(emb[e] * q).sum() for e in want["ext_ids"]]
    assert np.all(np.abs(np.subtract(got["scores"], want["scores"])) <= lim)
    for r, (g, w) in enumerate(zip(got["ext_ids"], want["ext_ids"])):
        if g != w:
            near = [e for e, s in zip(want["ext_ids"], want["scores"])
                    if abs(s - want["scores"][r]) <= lim[r]]
            assert len(near) > 1 and g in near, (r, g, w)


def same_response(got, want, *, mode="sparse", app=None, texts=(), doc_text=None) -> None:
    """Status, modeled latency and body equal the reference's; a dense
    body's scores within the dot-order tolerance (``app`` embeds
    ``texts``)."""
    assert (got.status, got.latency_s) == (want.status, want.latency_s), (got.body, want.body)
    if mode != "dense" or got.status != 200:
        assert got.body == want.body
        return
    rest = ("scores", "ids", "ext_ids", "docs", "results")
    assert ({k: v for k, v in got.body.items() if k not in rest}
            == {k: v for k, v in want.body.items() if k not in rest})
    pairs = (zip(got.body["results"], want.body["results"], texts)
             if "results" in want.body else [(got.body, want.body, texts[0])])
    for g, w, text in pairs:
        assert len(g["ids"]) == len(w["ids"])
        _dense_close(app, g, w, text, doc_text)


# -- fleet scenarios run in both packages -----------------------------------------

DIM = 16
PING = {"q": "", "k": 1, "fetch_docs": False}


def build_app(P, docs, n_parts=2, *, vector=False, **kw):
    kw.setdefault("runtime_config", P.RuntimeConfig())
    kw.setdefault("search_config", P.SearchConfig(sim_exec_s=0.002, sim_write_s=0.02))
    spec_kw = {k: kw.pop(k) for k in ("replication", "gateway") if k in kw}
    if vector or spec_kw:
        return P.build(docs, P.FleetSpec(
            n_parts=n_parts, index=P.IndexSpec(
                vector=P.VectorSpec(dim=DIM) if vector else None,
                merge_policy=kw.pop("merge_policy", None)),
            **spec_kw, **kw))
    return P.build(docs, n_parts=n_parts, **kw)


def oracle_top(corpus, q, k=10):
    oracle = T.OracleSearcher(corpus)
    return [oracle.doc_ids[i] for i, _ in oracle.search(q, k=k)]


def assert_fleet_matches_oracle(app, queries, k=10):
    """The fleet's merged top-k equals a from-scratch oracle rebuild of the
    LIVE corpus, in the fleet's own (partition, internal-id) order."""
    corpus = app.indexer.live_corpus()
    out = []
    for q in queries:
        r = app.query(q, k=k, t_arrival=app.runtime.clock + 0.05, fetch_docs=False)
        assert r.ok, r.body
        assert r.body["ext_ids"] == oracle_top(corpus, q, k), q
        assert len(app.scatter.last_versions) == 1
        out.append(r)
    return out


def both(scenario):
    """Run ``scenario(P) -> (app, responses)`` in both packages: the port's
    responses, records, ledger and cache bytes equal the reference's."""
    (j, jr), (t, tr) = (scenario(P) for P in PACKAGES)
    assert len(tr) == len(jr)
    for got, want in zip(tr, jr):
        same_response(got, want)
    same_runtime(t, j)
    return t, j


def mid_scatter(app, kill: bool, commit_check) -> None:
    """Arm the app's next search leg to land a commit mid-scatter (after
    killing partition 1's primary instance when ``kill``); the commit's
    response goes to ``commit_check``."""
    state = {"armed": True}
    orig_invoke = app.runtime.invoke

    def invoke(fn, payload, **kw):
        result = orig_invoke(fn, payload, **kw)
        if state["armed"] and fn.startswith("search-"):
            state["armed"] = False
            if kill:
                app.runtime.kill_instance(fn=app.fn_names[1])
            commit_check(app.commit())
        return result

    app.runtime.invoke = invoke
