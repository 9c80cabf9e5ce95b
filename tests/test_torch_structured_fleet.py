"""Structured queries end to end through the partitioned fleet, in both
packages (the port of ``tests/test_structured_fleet.py``).

A ``field:``-scoped phrase query with a facet request, through a
4-partition × 2-replica fleet: the port's responses, modeled latencies,
runtime records and ledger equal the reference's, and its top-k equals the
port's ``StructuredOracleSearcher`` over the live corpus (same order, same
f32 bits), facet counts a full-corpus count, snippets cover every matched
term — across a mid-window delta commit (admitted queries stay pinned to
their generation) and on lazily hydrated all-cold instances.
"""

import pytest
import torch

from repro_torch.index.tokenizer import flatten_text, tokenize
from torch_pairs import J, PACKAGES, T, same_response, same_runtime


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DOCS = [
    (f"d{i:03d}", {"title": t, "body": b, "cat": c})
    for i, (t, b, c) in enumerate([
        ("serverless lucene", "a prototype of serverless lucene on lambda", "systems"),
        ("big data systems", "serverless big data engines at scale", "systems"),
        ("cloud functions", "functions as a service with big latency tails", "cloud"),
        ("information retrieval", "bm25 ranking for information retrieval", "ir"),
        ("vector search", "dense vector retrieval with big data", "ir"),
        ("lambda tails", "tail latency in serverless lambda fleets", "cloud"),
        ("index formats", "packed segment formats for lucene indexes", "systems"),
        ("query parsing", "structured query parsing with phrases", "ir"),
        ("scatter gather", "scatter gather merge over partitions", "systems"),
        ("facet counts", "faceted navigation over categorical fields", "ir"),
        ("cold starts", "cold start hydration of serverless search", "cloud"),
        ("phrase search", "positional phrase search needs positions", "ir"),
    ])
]
QUERIES = [
    'title:"serverless lucene" OR big',      # the acceptance query shape
    'body:big AND data',
    '"big data"^2 systems',
    'cat:systems',
    'serverless',                            # structured bag-of-words
]


def _build(P, **fleet_kw):
    spec = P.FleetSpec(
        n_parts=4, replication=P.ReplicationSpec(replicas=2),
        index=P.IndexSpec(structured=True, facet_fields=("cat",)),
        runtime_config=P.RuntimeConfig(seed=0),
        search_config=P.SearchConfig(k=10, sim_exec_s=0.0002, sim_write_s=0.01),
        **fleet_kw)
    return P.build(DOCS, spec)


def _check(app, sq, *, facets=("cat",), k=10, resp=None, corpus=None):
    """The port's response against its oracle over the live corpus: exact
    (ext_id, score) list equality — order AND f32 bits — plus exact facets
    and snippet term coverage."""
    live = corpus if corpus is not None else app.indexer.live_corpus()
    oracle = T.StructuredOracleSearcher(live, facet_fields=("cat",))
    if resp is None:
        resp = app.query(sq=sq, k=k, facets=list(facets), snippets=True)
    assert resp.status == 200, (resp.status, resp.body)
    r = resp.body
    want = [(live[i][0], s) for i, s in oracle.search(sq, k)]
    assert list(zip(r["ext_ids"], r["scores"])) == want, sq
    for f in facets:
        assert r["facets"][f] == oracle.facet_counts(sq, f), (sq, f)
        assert r["facets"][f] == oracle.exact_facet_counts(sq, f), (sq, f)
    if "snippets" in r:
        terms = set(T.parse_query(sq).terms)
        for doc, snip in zip(r["docs"], r["snippets"]):
            for t in terms & set(tokenize(doc["contents"])):
                assert "<em>" in snip and t in snip.lower(), (sq, t, snip)
    return r


@pytest.mark.parametrize("sq", QUERIES)
def test_fleet_matches_oracle_and_reference(sq):
    apps = [_build(P) for P in PACKAGES]
    got, want = (a.query(sq=sq, k=10, facets=["cat"], snippets=True) for a in apps[::-1])
    same_response(got, want)
    _check(apps[1], sq, resp=got)
    same_runtime(apps[1], apps[0])


def test_legacy_path_serves_unchanged_on_a_structured_fleet():
    """Plain ``q`` queries on a v2 fleet equal a v1 fleet over the flattened
    texts, bit for bit, in the port as in the reference."""
    app = _build(T)
    v1 = T.build([(e, flatten_text(t)) for e, t in DOCS], T.FleetSpec(
        n_parts=4, replication=T.ReplicationSpec(replicas=2),
        search_config=T.SearchConfig(k=10, sim_exec_s=0.0002)))
    ref = _build(J)
    for q in ("serverless lucene", "big data", "latency"):
        a, b = app.query(q, k=10, fetch_docs=False), v1.query(q, k=10, fetch_docs=False)
        assert a.status == b.status == 200
        assert a.body["ext_ids"] == b.body["ext_ids"] and a.body["scores"] == b.body["scores"]
        same_response(a, ref.query(q, k=10, fetch_docs=False))


def test_structured_on_v1_fleet_and_bad_queries_rejected_at_admission():
    for P in PACKAGES:
        v1 = P.build([(e, flatten_text(t)) for e, t in DOCS], P.FleetSpec(
            n_parts=2, search_config=P.SearchConfig(sim_exec_s=0.0002)))
        assert v1.query(sq="title:foo").status == 400
    apps = [_build(P) for P in PACKAGES]
    for kw in (dict(sq="x", facets=["nope"]), dict(sq='"unbalanced'), dict(sq="AND x"),
               dict(sq="x", mode="dense"), dict(q="x", sq="x"), dict(sq=[])):
        got, want = apps[1].query(**kw), apps[0].query(**kw)
        assert got.status == 400
        same_response(got, want)
    got, want = apps[1].query(sq="serverless"), apps[0].query(sq="serverless")
    assert got.status == 200
    same_response(got, want)
    same_runtime(apps[1], apps[0])


def test_parity_holds_across_delta_commit_with_new_facet_value():
    apps = [_build(P) for P in PACKAGES]
    got, want = (a.query(sq='body:big AND data', facets=["cat"], snippets=True)
                 for a in apps[::-1])
    same_response(got, want)
    for app in apps:
        app.add_documents([
            ("n000", {"title": "stream processing",
                      "body": "serverless big data streams", "cat": "streams"}),
            ("n001", {"title": "big graphs",
                      "body": "graph systems with big data", "cat": "systems"}),
        ])
        app.delete_documents(["d001"])
    got, want = (a.commit() for a in apps[::-1])
    assert got.status == 200 and got.body["committed"], got.body
    same_response(got, want)
    for sq in ('body:big AND data', '"big data" OR title:big', 'cat:streams OR serverless'):
        got, want = (a.query(sq=sq, k=10, facets=["cat"], snippets=True) for a in apps[::-1])
        same_response(got, want)
        _check(apps[1], sq, resp=got)
    same_runtime(apps[1], apps[0])


def test_mid_window_commit_pins_admitted_queries_to_their_generation():
    """Queries admitted before a commit that lands inside the same open
    batching window score against generation 1's corpus and stats; a query
    admitted after it against generation 2 — same flush, in both
    packages."""
    out = []
    for P in PACKAGES:
        app = _build(P, gateway=P.GatewaySpec(window=P.WindowPolicy(
            max_window_s=0.5, sparse_qps=0.0, max_batch=64)))
        t0 = app.runtime.clock
        corpus_g1 = app.indexer.live_corpus()
        h = [app.submit(sq='title:"serverless lucene" OR big', facets=["cat"],
                        t_arrival=t0 + 0.01),
             app.submit(sq='body:big AND data', facets=["cat"], t_arrival=t0 + 0.02),
             app.submit("serverless", t_arrival=t0 + 0.03)]
        app.add_documents([("n000", {"title": "streams", "body": "big data streams",
                                     "cat": "streams"})], t_arrival=t0 + 0.05)
        assert app.commit(t_arrival=t0 + 0.06).body["committed"]
        corpus_g2 = app.indexer.live_corpus()
        h.append(app.submit(sq='cat:streams OR serverless', facets=["cat"],
                            t_arrival=app.runtime.clock + 0.01))
        app.flush(None)
        bad = app.submit(sq='"unbalanced', t_arrival=app.runtime.clock + 0.01)
        out.append((app, [x.response for x in h] + [bad.response], corpus_g1, corpus_g2))
    (j, jr, _, _), (t, tr, g1, g2) = out
    for got, want in zip(tr, jr, strict=True):
        same_response(got, want)
    r1, r2, r3, r4, bad = tr
    assert [r.body["generation"] for r in (r1, r2, r4)] == [1, 1, 2]
    _check(t, 'title:"serverless lucene" OR big', resp=r1, corpus=g1)
    _check(t, 'body:big AND data', resp=r2, corpus=g1)
    _check(t, 'cat:streams OR serverless', resp=r4, corpus=g2)
    assert r3.body["ext_ids"] and bad.status == 400
    same_runtime(t, j)


def test_cold_lazy_instances_hold_bit_parity():
    """Kill EVERY instance: the next structured query cold-starts each leg
    through lazy block-range hydration (only the queried terms' v2 rows)
    and still matches the oracle bit for bit, and the reference's
    hydration charges."""
    apps = [_build(P) for P in PACKAGES]
    resps = []
    for app in apps:
        assert app.query(sq="serverless").status == 200
        killed = 0
        while app.runtime.kill_instance():
            killed += 1
        assert killed > 0
        resps.append(app.query(sq='"big data" OR title:phrase', facets=["cat"],
                               snippets=True))
    same_response(resps[1], resps[0])
    r = _check(apps[1], '"big data" OR title:phrase', resp=resps[1])
    assert any(p["cold"] for p in r["partitions"])
    same_runtime(apps[1], apps[0])


def test_structured_batch_equals_serial_and_pins_one_k2_call():
    """An ``sqs`` micro-batch answers each query as its serial ``sq`` does,
    and the searcher evaluates the batch with one top-k call."""
    from repro_torch.kernels import ref
    app = _build(T)
    serial = [app.query(sq=sq, k=10, facets=["cat"], fetch_docs=False).body
              for sq in QUERIES]
    calls = []
    orig = ref.topk_ref

    def counting(scores, k):
        calls.append(tuple(scores.shape))
        return orig(scores, k)

    ref.topk_ref = counting
    try:
        batch = app.query(sq=QUERIES, k=10, facets=["cat"], fetch_docs=False).body
    finally:
        ref.topk_ref = orig
    for s, b in zip(serial, batch["results"], strict=True):
        assert (s["ext_ids"], s["scores"], s["facets"]) == (b["ext_ids"], b["scores"],
                                                            b["facets"])
    # one call a partition leg, each over the whole (Q, n_docs) batch
    assert len(calls) == 4 and all(q == len(QUERIES) for q, _ in calls)
