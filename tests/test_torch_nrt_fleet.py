"""The commit-driven cases of the reference's gateway, hybrid, fleetspec and
hydration tests, in both packages: a commit inside an open admission
window, dense and hybrid answers through churn, a commit's manifest flip
on every partition, a rollover landing mid-scatter under both tiers, the
fleet's lazy-hydration default, the autoscaler's cold-profile floor, and
``POST /index`` with its writer functions.

As in ``test_torch_nrt.py``: responses, modeled latencies, commit bodies,
runtime records, ledger lines and cache bytes equal the reference's (dense
scores within the dot-order tolerance), and the port's answers equal its
own oracles over the live corpus.
"""

import pytest
import torch

from repro.data.corpus import synth_corpus, synth_queries
from torch_pairs import (PACKAGES, T, bits, both, build_app, mid_scatter, oracle_top,
                         same_response, same_runtime)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_commit_inside_open_window_splits_by_generation():
    corpus = synth_corpus(260, vocab=400, seed=51)
    queries = synth_queries(corpus, 24, seed=53)
    extra = [(f"new-{i}", t) for i, (_, t) in enumerate(corpus[:30])]
    corpora = {}

    def scenario(P):
        app = build_app(P, corpus, n_parts=3)
        app.warm()
        out = [app.query(q, k=10, t_arrival=app.runtime.clock + 0.05, fetch_docs=False)
               for q in queries[:4]]
        old = list(app.indexer.live_corpus())
        t0 = app.runtime.clock + 1.0
        pre = [app.submit(q, k=10, t_arrival=t0 + 0.004 * i, fetch_docs=False)
               for i, q in enumerate(queries[:4])]
        out.append(app.commit(t_arrival=t0 + 0.016))
        assert out[-1].ok and out[-1].body["committed"] is False
        out += [app.add_documents(extra, t_arrival=t0 + 0.017),
                app.commit(t_arrival=t0 + 0.018)]
        assert out[-1].body["gen"] == 2
        post = [app.submit(q, k=10, t_arrival=t0 + 0.02 + 0.004 * i, fetch_docs=False)
                for i, q in enumerate(queries[4:8])]
        app.flush()
        assert {h.response.body["generation"] for h in pre} == {1}
        assert {h.response.body["generation"] for h in post} == {2}
        corpora[P.torch] = (old, app.indexer.live_corpus(), pre, post)
        return app, out + [h.response for h in pre + post]

    both(scenario)
    old, new, pre, post = corpora[True]
    for h, q in zip(pre, queries[:4]):
        assert h.response.body["ext_ids"] == oracle_top(old, q)
    for h, q in zip(post, queries[4:8]):
        assert h.response.body["ext_ids"] == oracle_top(new, q)


def fleet_vs_oracles(app, queries, k=10):
    """Inside the port: dense answers are the full-corpus dense oracle's ids
    and score bits, hybrid ``hybrid_oracle_fuse`` of the two oracles."""
    corpus = app.indexer.live_corpus()
    so, do = T.OracleSearcher(corpus), T.DenseOracleSearcher(corpus, app.embedder)
    out = []
    for q in queries:
        s_want, d_want = so.search(q, k=app.search_k), do.search(q, k=app.search_k)
        r = app.query(q, k=k, mode="dense", t_arrival=app.runtime.clock + 0.05,
                      fetch_docs=False)
        assert r.body["ext_ids"] == [do.doc_ids[d] for d, _ in d_want[:k]]
        assert bits(r.body["scores"]) == bits([v for _, v in d_want[:k]])
        h = app.query(q, k=k, mode="hybrid", t_arrival=app.runtime.clock + 0.05,
                      fetch_docs=False)
        fused = T.hybrid_oracle_fuse(s_want, d_want, k)
        assert h.body["ext_ids"] == [so.doc_ids[d] for d, _ in fused]
        assert h.body["scores"] == [v for _, v in fused]
        out.append((q, r, h))
    return out


def _dense_pair(app_t, docs, obs_t, obs_j):
    for (q, rt, ht), (_, rj, hj) in zip(obs_t, obs_j, strict=True):
        same_response(rt, rj, mode="dense", app=app_t, texts=[q], doc_text=dict(docs))
        same_response(ht, hj)


def test_dense_and_hybrid_match_oracles_through_churn():
    docs = synth_corpus(160, vocab=300, seed=2)
    queries = synth_queries(docs, 4, seed=3)
    runs = {}
    for P in PACKAGES:
        app = build_app(P, docs[:120], vector=True)
        obs = []
        if P.torch:
            obs += fleet_vs_oracles(app, queries[:2])
        else:
            obs += [(q, app.query(q, k=10, mode="dense", t_arrival=app.runtime.clock + 0.05,
                                  fetch_docs=False),
                     app.query(q, k=10, mode="hybrid", t_arrival=app.runtime.clock + 0.05,
                               fetch_docs=False)) for q in queries[:2]]
        commits = []
        for add, dele in ((docs[120:140], docs[0:40:10]), (docs[140:], docs[50:60])):
            app.add_documents(add, t_arrival=app.runtime.clock + 0.01)
            app.delete_documents([d for d, _ in dele], t_arrival=app.runtime.clock + 0.01)
            commits.append(app.commit(t_arrival=app.runtime.clock + 0.01))
            assert commits[-1].ok
            if P.torch:
                obs += fleet_vs_oracles(app, queries)
            else:
                obs += [(q, app.query(q, k=10, mode="dense",
                                      t_arrival=app.runtime.clock + 0.05, fetch_docs=False),
                         app.query(q, k=10, mode="hybrid",
                                   t_arrival=app.runtime.clock + 0.05, fetch_docs=False))
                        for q in queries]
        runs[P.torch] = (app, obs, commits)
    (t, ot, ct), (j, oj, cj) = runs[True], runs[False]
    _dense_pair(t, docs, ot, oj)
    for a, b in zip(ct, cj):
        same_response(a, b)
    same_runtime(t, j)


def test_every_commit_flips_every_partition_manifest():
    docs = synth_corpus(60, vocab=150, seed=13)
    q = synth_queries(docs, 1, seed=14)[0]
    runs = {}
    for P in PACKAGES:
        app = build_app(P, docs, n_parts=3, vector=True)
        gen = app.indexer.gen
        app.add_documents([("zz-one-new-doc", "dense retrieval vector tier")],
                          t_arrival=app.runtime.clock + 0.01)
        c = app.commit(t_arrival=app.runtime.clock + 0.01)
        assert c.ok and app.indexer.gen == gen + 1
        h = app.query(q, k=5, mode="hybrid", t_arrival=app.runtime.clock + 0.05,
                      fetch_docs=False)
        assert app.scatter.last_versions == [P.generation_version(gen + 1)]
        vec = [float(x) for x in app.embedder("dense retrieval vector tier")]
        r = app.query(None, k=3, mode="dense", vector=vec,
                      t_arrival=app.runtime.clock + 0.05, fetch_docs=False)
        assert "zz-one-new-doc" in r.body["ext_ids"]
        runs[P.torch] = (app, c, h, r)
    (t, *ot), (j, *oj) = runs[True], runs[False]
    same_response(ot[0], oj[0])
    same_response(ot[1], oj[1])
    same_response(ot[2], oj[2], mode="dense", app=t, texts=["dense retrieval vector tier"])
    same_runtime(t, j)


def test_mid_scatter_rollover_pins_both_tiers():
    docs = synth_corpus(120, vocab=250, seed=17)
    q = synth_queries(docs, 1, seed=18)[0]
    runs = {}
    for P in PACKAGES:
        app = build_app(P, docs[:100], n_parts=3, vector=True)
        first = app.query(q, mode="hybrid", fetch_docs=False)
        gen = app.indexer.gen
        app.add_documents(docs[100:])
        commits = []
        mid_scatter(app, False, commits.append)
        r = app.query(q, k=10, mode="hybrid", fetch_docs=False)
        assert r.ok and commits[0].body["gen"] == gen + 1
        assert app.scatter.last_versions == [P.generation_version(gen)]
        r2 = app.query(q, k=10, mode="hybrid", t_arrival=app.runtime.clock + 0.05,
                       fetch_docs=False)
        assert app.scatter.last_versions == [P.generation_version(gen + 1)]
        runs[P.torch] = (app, [first, r, r2] + commits)
    (t, ot), (j, oj) = runs[True], runs[False]
    for a, b in zip(ot, oj, strict=True):
        same_response(a, b)
    fleet_vs_oracles(t, [q])


def test_fleet_defaults_to_lazy_hydration():
    docs = synth_corpus(60, vocab=150, seed=4)
    q = synth_queries(docs, 1, seed=5)[0]
    out = {}
    for P in PACKAGES:
        cfg = P.SearchConfig(sim_exec_s=0.002, sim_write_s=0.02)
        lazy = P.build(docs, P.FleetSpec(n_parts=2, runtime_config=P.RuntimeConfig(),
                                         search_config=cfg))
        eager = P.build(docs, P.FleetSpec(
            n_parts=2, runtime_config=P.RuntimeConfig(),
            search_config=P.SearchConfig(sim_exec_s=0.002, sim_write_s=0.02,
                                         lazy_hydration=False)))
        r, r2 = lazy.query(q, k=10, fetch_docs=False), eager.query(q, k=10, fetch_docs=False)
        assert lazy.runtime.ledger.backfill_gb_seconds > 0
        assert eager.runtime.ledger.backfill_gb_seconds == 0
        assert r.body["ext_ids"] == r2.body["ext_ids"]
        assert bits(r.body["scores"]) == bits(r2.body["scores"])
        out[P.torch] = (lazy, r, r2)
    same_response(out[True][1], out[False][1])
    same_response(out[True][2], out[False][2])
    same_runtime(out[True][0], out[False][0])


def test_autoscale_floor_tracks_cold_profile():
    for P in PACKAGES:
        def make(policy, P=P):
            rt = P.FaaSRuntime(P.RuntimeConfig())
            rt.register("p0", lambda cache, payload: (payload, 0.001))
            sg = P.ScatterGather(rt, [["p0"]])
            return P.FleetController(rt, sg, [lambda: lambda c, p: (p, 0.001)], policy)

        assert make(P.AutoscalePolicy())._overhead_threshold(["p0"]) == \
            pytest.approx(0.150 / 2)
        assert make(P.AutoscalePolicy(cold_overhead_s=0.2))._overhead_threshold(["p0"]) == \
            pytest.approx(0.1)
        assert make(P.AutoscalePolicy(cold_overhead_s=0.2, up_overhead_s=0.03)
                    )._overhead_threshold(["p0"]) == pytest.approx(0.03)


def test_commit_through_post_index_and_writer_handler_match_reference():
    """``POST /index`` answers every op as the reference does (unknown ops
    and bad bodies included), and a writer function invoked directly packs
    and publishes the same delta segment."""
    docs = synth_corpus(60, vocab=150, seed=23)

    def scenario(P):
        app = build_app(P, docs[:50], n_parts=2, vector=True)
        out = [app.gateway.request("POST", "/index", body) for body in (
            {"op": "add", "docs": [list(d) for d in docs[50:55]]},
            {"op": "delete", "ids": [docs[0][0], "nope"]},
            {"op": "frobnicate"}, {"op": "add"},
            {"op": "commit"}, {"op": "commit"})]
        assert [r.status for r in out] == [200, 200, 502, 502, 200, 200]
        ix = app.indexer
        ix.stage_add(docs[55:])
        ix.parts[0].staged_docs = list(docs[55:])
        res, exec_s = app.runtime._handlers["indexer-p0"](None, {"op": "delta", "gen": 9})
        assert res["op"] == "delta" and res["n_docs"] == len(docs[55:])
        assert app.catalog.open_segment(app.assets[0], res["seg"]).list()
        app._writer = (res, exec_s)
        return app, out

    t, j = both(scenario)
    assert t._writer == j._writer
