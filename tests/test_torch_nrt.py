"""Near-real-time indexing in both packages: delta segments, tombstones,
merges, generation commits, forked writers and zero-downtime rollover (the
port of ``tests/test_nrt.py``; the commit-driven cases of the other
reference tests are in ``test_torch_nrt_fleet.py``).

Each scenario runs once per package on the same docs, runtime seed and
modeled clock (``sim_exec_s``, ``sim_write_s``): the port's responses,
modeled latencies, commit bodies, runtime records, ledger lines and cache
bytes equal the reference's exactly (dense scores within the dot-order
tolerance), and inside the port every answer equals its own oracles
rebuilt over the live corpus — the invariants of the reference's harness:

* PARITY — any interleaving of add/delete/commit/merge ranks exactly like
  a from-scratch rebuild of the final live corpus;
* CONSISTENCY — no query merges hits from two index generations, across
  partitions, hedged replica legs or freshly scaled pools, even when a
  rollover (or an instance kill) lands mid-scatter;
* ATOMICITY — concurrent generation publishes surface as PublishConflict;
  gc never deletes the serving generation or a segment it references.
"""

import random

import pytest
import torch

from repro.data.corpus import synth_corpus, synth_queries
from repro_torch.index.tokenizer import tokenize
from torch_pairs import (PING, J, PACKAGES, T, assert_fleet_matches_oracle, both, build_app,
                         mid_scatter, oracle_top)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- builder level: the delta segment itself ------------------------------------


def test_delta_plus_combine_equals_rebuild():
    docs = synth_corpus(240, vocab=400, seed=0)
    base_docs, new_docs = docs[:180], docs[180:]
    deleted = {docs[3][0], docs[100][0], docs[200][0]}
    live = [(e, t) for e, t in docs if e not in deleted]
    hits = {}
    for P in PACKAGES:
        stats = P.compute_global_stats(base_docs)
        vocab = P.global_vocab(stats)
        w = P.IndexWriter(global_stats=stats, vocab=vocab)
        w.add_many(base_docs)
        base = w.pack()
        vocab2 = P.extend_vocab(vocab, (t for _, txt in new_docs for t in tokenize(txt)))
        delta = P.IndexWriter.delta(new_docs, stats, vocab=vocab2)
        live_stats = dict(stats, df=dict(stats["df"]))
        by_id = dict(docs)
        for _, t in new_docs:
            P.update_stats(live_stats, t, sign=1)
        for e in deleted:
            P.update_stats(live_stats, by_id[e], sign=-1)
        dead = [i for i, (e, _) in enumerate(base_docs + new_docs) if e in deleted]
        combined = P.combine_segments([base, delta], vocab=vocab2, stats=live_stats,
                                      tombstones=dead)
        ref = P.compute_global_stats(live)
        assert live_stats["df"] == ref["df"] and live_stats["n_docs"] == ref["n_docs"]
        cfg = P.SearchConfig(sim_exec_s=0.002)
        s_delta = P.Searcher(combined, cfg)
        wr = P.IndexWriter(global_stats=ref, vocab=P.global_vocab(ref))
        wr.add_many(live)
        s_rebuild = P.Searcher(wr.pack(), cfg)
        hits[P.torch] = []
        for q in synth_queries(docs, 25, seed=2):
            got = s_delta.search_one(q)
            e1 = [combined.meta.doc_ids[i] for i, _ in got]
            e2 = [s_rebuild.packed.meta.doc_ids[i] for i, _ in s_rebuild.search_one(q)]
            assert e1 == e2 == oracle_top(live, q), q
            assert not set(e1) & deleted
            hits[P.torch].append(got)
    assert hits[True] == hits[False]


def test_extend_vocab_is_append_only():
    v = {"b": 0, "a": 1}
    v2 = T.extend_vocab(v, ["c", "a", "aa"])
    assert v2 == J.extend_vocab(v, ["c", "a", "aa"])
    assert v2["b"] == 0 and v2["a"] == 1 and v2["aa"] == 2 and v2["c"] == 3
    assert T.extend_vocab(v2, ["a"]) == v2


def test_merge_policy_tiers():
    for P in PACKAGES:
        pol = P.MergePolicy(max_deltas=2, ratio=0.5, tombstone_ratio=0.2)
        assert [pol.should_merge(*a) for a in (
            (100, 0, 0, 0), (100, 30, 1, 5), (100, 30, 3, 0), (100, 60, 1, 0),
            (100, 0, 0, 30), (0, 1, 1, 0))] == [False, False, True, True, True, True]


# -- property: random interleavings vs full rebuild ------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_interleaving_parity(seed):
    """Seeded random add/delete/commit/merge interleavings: after every
    commit the fleet ranks exactly like a rebuild of the live corpus, and
    the port's commits, answers and records equal the reference's."""
    docs = synth_corpus(160, vocab=300, seed=seed)
    queries = synth_queries(docs, 10, seed=seed + 50)

    def scenario(P):
        rng = random.Random(seed)
        init, pool = docs[:90], list(docs[90:])
        app = build_app(P, init, merge_policy=P.MergePolicy(
            max_deltas=2, ratio=0.4, tombstone_ratio=0.15))
        out = assert_fleet_matches_oracle(app, queries)
        for _ in range(4):
            for _ in range(rng.randint(1, 3)):
                if pool and rng.random() < 0.6:
                    take = rng.randint(1, min(12, len(pool)))
                    batch, pool[:take] = pool[:take], []
                    out.append(app.add_documents(batch))
                else:
                    live = app.indexer.live_corpus()
                    out.append(app.delete_documents(
                        rng.sample([e for e, _ in live], k=min(3, len(live)))))
                assert out[-1].ok, out[-1].body
            out.append(app.commit())
            assert out[-1].ok, out[-1].body
            out += assert_fleet_matches_oracle(app, queries)
        assert sum(len(c["merged"]) for c in app.indexer.commits) >= 1
        ref = P.compute_global_stats(app.indexer.live_corpus())
        assert app.indexer.stats["df"] == ref["df"]
        assert app.indexer.stats["avgdl"] == pytest.approx(ref["avgdl"])
        return app, out

    t, j = both(scenario)
    assert t.indexer.stats == j.indexer.stats and t.indexer.commits == j.indexer.commits


def test_delete_only_commit_and_update_semantics():
    docs = synth_corpus(80, vocab=200, seed=3)

    def scenario(P):
        app = build_app(P, docs[:60])
        victim = docs[0][0]
        out = [app.delete_documents([victim]), app.commit()]
        assert out[-1].ok and out[-1].body["writers"] == 0 and out[-1].body["deleted"] == 1
        assert victim not in [e for e, _ in app.indexer.live_corpus()]
        out += assert_fleet_matches_oracle(app, synth_queries(docs, 6, seed=9))
        with pytest.raises(ValueError):
            app.indexer.stage_add([(docs[1][0], "dup")])
        out += [app.add_documents(docs[60:62]), app.delete_documents([docs[60][0]]),
                app.commit()]
        assert out[-1].body["indexed"] == 1 and out[-1].body["deleted"] == 0
        live = [e for e, _ in app.indexer.live_corpus()]
        assert docs[61][0] in live and docs[60][0] not in live
        out.append(app.delete_documents(["nope"]))
        assert out[-1].ok and out[-1].body["pending_deletes"] == 0
        with pytest.raises(ValueError):
            app.indexer.stage_add([("brand-new", "x"), (docs[2][0], "dup")])
        assert "brand-new" not in app.indexer._pending_ids
        out.append(app.commit())
        assert out[-1].body["committed"] is False
        return app, out

    both(scenario)


def test_update_flow_delete_add_commit():
    docs = synth_corpus(60, vocab=150, seed=10)
    queries = synth_queries(docs, 6, seed=19)
    target = docs[2][0]

    def scenario(P):
        app = build_app(P, docs)
        out = []
        for i in range(4):                  # round-robin lands both partitions
            text = f"mede bu dubo variant{i} bu mede"
            out += [app.delete_documents([target]), app.add_documents([(target, text)]),
                    app.commit()]
            assert out[-1].ok, out[-1].body
            assert dict(app.indexer.live_corpus())[target] == text
            out += assert_fleet_matches_oracle(app, queries + ["mede bu"])
        return app, out

    both(scenario)


# -- fault injection: version consistency under rollover + kills ------------------


def test_rollover_mid_scatter_never_tears_a_query():
    docs = synth_corpus(120, vocab=250, seed=4)
    q = synth_queries(docs, 1, seed=11)[0]

    def scenario(P):
        app = build_app(P, docs[:100], n_parts=3)
        out = [app.query(q, fetch_docs=False)]
        gen = app.indexer.gen
        out.append(app.add_documents(docs[100:]))
        commits = []
        mid_scatter(app, True, commits.append)
        out.append(app.query(q, k=10, fetch_docs=False))
        assert commits[0].ok and commits[0].body["gen"] == gen + 1
        assert app.scatter.last_versions == [P.generation_version(gen)]
        assert out[-1].body["generation"] == gen
        out.append(app.query(q, k=10, t_arrival=app.runtime.clock + 0.05, fetch_docs=False))
        assert app.scatter.last_versions == [P.generation_version(gen + 1)]
        out += commits + assert_fleet_matches_oracle(app, [q])
        return app, out

    both(scenario)


def test_hedged_legs_share_the_pinned_generation():
    docs = synth_corpus(100, vocab=200, seed=5)
    queries = synth_queries(docs, 6, seed=13)

    def scenario(P):
        app = build_app(P, docs[:80], replicas=2, hedge=0.01)
        app.warm()
        out = [app.query(q, fetch_docs=False, t_arrival=app.runtime.clock + 0.05)
               for q in queries]
        out += [app.add_documents(docs[80:]), app.commit()]
        assert out[-1].ok
        app.runtime.kill_instance(fn=app.fn_names[0])
        out.append(app.query(queries[0], fetch_docs=False,
                             t_arrival=app.runtime.clock + 0.05))
        assert out[-1].ok and len(app.scatter.last_versions) == 1
        return app, out + assert_fleet_matches_oracle(app, queries)

    t, _ = both(scenario)
    assert any(r.hedged for r in t.runtime.records)


def test_scale_up_registers_replica_on_current_generation():
    docs = synth_corpus(100, vocab=200, seed=6)

    def scenario(P):
        app = build_app(P, docs[:80], autoscale=True)
        out = [app.query(synth_queries(docs, 1, seed=14)[0], fetch_docs=False),
               app.add_documents(docs[80:]), app.commit()]
        current = app.indexer.gen
        ctl = app.controller
        ctl._scale_up(0, ctl.groups[0], app.runtime.clock + 1.0, "test")
        assert len(app.scatter.groups[0]) == 2
        for q in synth_queries(docs, 4, seed=15):
            out.append(app.query(q, k=10, t_arrival=app.runtime.clock + 0.05,
                                 fetch_docs=False))
            assert app.scatter.last_versions == [P.generation_version(current)]
        return app, out + assert_fleet_matches_oracle(app, synth_queries(docs, 4, seed=16))

    t, j = both(scenario)
    assert t.controller.events == j.controller.events


# -- publish atomicity + gc -------------------------------------------------------


def _m(P, gen, base, deltas, stats=None):
    return P.GenerationManifest(gen=gen, base=base, deltas=deltas, tombstones=[],
                                stats=stats or {"n_docs": 1, "avgdl": 1.0, "df": {}},
                                vocab={})


def test_publish_generation_conflict_lost_update():
    for P in PACKAGES:
        cat = P.AssetCatalog(P.ObjectStore())
        cat.publish_generation("idx", _m(P, 1, "g1-base", []))
        cat.publish_generation("idx", _m(P, 2, "g1-base", ["g2-a"]))
        with pytest.raises(P.PublishConflict):
            cat.publish_generation("idx", _m(P, 2, "g1-base", ["g2-b"]))
        assert cat.current_generation("idx").deltas == ["g2-a"]
        assert cat.read_generation("idx").gen == 2


def test_publish_generation_conflict_torn_race():
    for P in PACKAGES:
        store = P.ObjectStore()
        cat = P.AssetCatalog(store)
        cat.publish_generation("idx", _m(P, 1, "b", []))
        real_head = store.head

        def racing_head(key, real_head=real_head, store=store):
            meta = real_head(key)
            if key.endswith("MANIFEST"):
                store.put(key, b'{"current": "gen-000001"}')
            return meta

        store.head = racing_head
        with pytest.raises(P.PublishConflict):
            cat.publish_generation("idx", _m(P, 2, "b", ["d"]))
        store.head = real_head
        assert not store.list(cat.version_prefix("idx", "gen-000002"))


def test_publish_generation_same_gen_race_spares_winner():
    for P in PACKAGES:
        store = P.ObjectStore()
        cat = P.AssetCatalog(store)
        cat.publish_generation("idx", _m(P, 1, "b", []))
        winner, loser = _m(P, 2, "b", ["g2-winner"]), _m(P, 2, "b", ["g2-loser"])
        real_head = store.head

        def racing_head(key, real_head=real_head, store=store, cat=cat, winner=winner):
            meta = real_head(key)
            if key.endswith("MANIFEST"):
                store.head = real_head
                cat.publish_generation("idx", winner)
                store.head = racing_head
            return meta

        store.head = racing_head
        with pytest.raises(P.PublishConflict):
            cat.publish_generation("idx", loser)
        store.head = real_head
        assert cat.current_version("idx") == P.generation_version(2)
        assert cat.read_generation("idx").deltas == ["g2-winner"]


def test_publish_segment_is_create_once():
    for P in PACKAGES:
        cat = P.AssetCatalog(P.ObjectStore())
        cat.publish_segment("idx", "g000001-base", P.RamDirectory({"f": b"A"}))
        with pytest.raises(P.PublishConflict):
            cat.publish_segment("idx", "g000001-base", P.RamDirectory({"f": b"B"}))
        assert cat.open_segment("idx", "g000001-base").open_input("f").read_all() == b"A"


def test_gc_reclaims_merged_away_segments_keeps_serving():
    docs = synth_corpus(90, vocab=200, seed=7)

    def scenario(P):
        app = build_app(P, docs[:60], merge_policy=P.MergePolicy(max_deltas=0))
        out = [app.add_documents(docs[60:75]), app.commit(),
               app.add_documents(docs[75:]), app.commit()]
        cat, store = app.catalog, app.store
        for st in app.indexer.parts:
            versions = cat.versions(st.asset)
            assert cat.current_version(st.asset) in versions and len(versions) == 2
            for v in versions:
                for seg in cat.read_generation(st.asset, v).segments:
                    assert store.list(cat.segment_prefix(st.asset, seg)), (v, seg)
            assert not store.list(cat.segment_prefix(st.asset, "g000001-base"))
        return app, out + assert_fleet_matches_oracle(app, synth_queries(docs, 6, seed=17))

    t, j = both(scenario)
    assert sorted(m.key for m in t.store.list("")) == sorted(m.key for m in j.store.list(""))


def test_failed_commit_rolls_back_and_retries():
    docs = synth_corpus(90, vocab=200, seed=9)
    queries = synth_queries(docs, 5, seed=18)

    def scenario(P):
        app = build_app(P, docs[:70])
        ix = app.indexer
        out = [app.add_documents(docs[70:]), app.delete_documents([docs[1][0]])]
        before = (dict(ix.stats, df=dict(ix.stats["df"])), dict(ix.vocab),
                  [list(st.seg_docs) for st in ix.parts])
        real = ix.catalog.publish_generation
        calls = {"n": 0}
        p1 = ix.parts[1].asset

        def failing(name, manifest):
            calls["n"] += 1
            if name == p1:
                raise P.PublishConflict("racing writer won")
            return real(name, manifest)

        ix.catalog.publish_generation = failing
        out.append(app.commit())
        assert out[-1].status == 502 and "racing writer" in out[-1].body["error"]
        assert calls["n"] >= 4
        ix.catalog.publish_generation = real
        assert ix.gen == 1 and ix.stats == before[0] and ix.vocab == before[1]
        assert [list(st.seg_docs) for st in ix.parts] == before[2]
        assert len(ix.pending_adds) == 20 and len(ix.pending_deletes) == 1
        out += assert_fleet_matches_oracle(app, queries)
        heal_gen = ix._published_gen() + 1
        assert heal_gen > 2
        out.append(app.commit())
        assert out[-1].ok and out[-1].body["gen"] == heal_gen
        assert all(ix.catalog.current_version(st.asset) == P.generation_version(heal_gen)
                   for st in ix.parts)
        return app, out + assert_fleet_matches_oracle(app, queries)

    both(scenario)


def test_rollover_prewarms_every_idle_instance():
    docs = synth_corpus(80, vocab=200, seed=11)
    q1, q2 = synth_queries(docs, 2, seed=20)

    def scenario(P):
        app = build_app(P, docs[:60], n_parts=1)
        t0 = app.runtime.clock + 0.1
        out = [app.query(q1, fetch_docs=False, t_arrival=t0),
               app.query(q2, fetch_docs=False, t_arrival=t0)]
        assert sum(i.fn == app.fn_names[0] for i in app.runtime._instances) == 2
        out += [app.add_documents(docs[60:]), app.commit(t_arrival=app.runtime.clock + 0.1)]
        assert out[-1].ok and out[-1].body["pings"] == 2
        t1 = app.runtime.clock + 0.1
        for q in (q1, q2):
            out.append(app.query(q, fetch_docs=False, t_arrival=t1))
            assert all(not p["cold"] and p["hydrate_s"] == 0
                       for p in out[-1].body["partitions"])
        return app, out

    both(scenario)


def test_commit_survives_runtime_straggler_hedge():
    docs = synth_corpus(80, vocab=200, seed=13)
    queries = synth_queries(docs, 5, seed=21)

    def scenario(P):
        app = build_app(P, docs[:50], runtime_config=P.RuntimeConfig(hedge_after_s=0.001))
        out = [app.add_documents(docs[50:65]), app.commit()]
        assert out[-1].ok, out[-1].body
        assert any(rec.write and rec.hedged for rec in app.runtime.records)
        out += assert_fleet_matches_oracle(app, queries)
        out += [app.add_documents(docs[65:]), app.commit()]
        assert out[-1].ok
        return app, out + assert_fleet_matches_oracle(app, queries)

    both(scenario)


def test_delete_removes_raw_document_content():
    docs = synth_corpus(60, vocab=150, seed=12)
    gone, updated = docs[0][0], docs[1][0]

    def scenario(P):
        app = build_app(P, docs[:50])
        out = [app.delete_documents([gone, updated]),
               app.add_documents([(updated, "replacement text body")] + docs[50:])]
        assert gone in app.doc_store
        out.append(app.commit())
        assert out[-1].ok and gone not in app.doc_store
        assert app.doc_store.get(updated)["contents"] == "replacement text body"
        return app, out

    both(scenario)


def test_commit_bills_the_write_line():
    docs = synth_corpus(80, vocab=200, seed=8)

    def scenario(P):
        app = build_app(P, docs[:60])
        led = app.runtime.ledger
        assert led.write_invocations == 0
        out = [app.add_documents(docs[60:]), app.commit()]
        assert out[-1].ok and led.write_invocations == 2 and led.write_dollars > 0
        att = led.attribution()
        assert att["write"] == pytest.approx(led.write_dollars)
        writes = [r for r in app.runtime.records if r.write]
        assert len(writes) == 2 and all(r.fn.startswith("indexer-") for r in writes)
        return app, out

    both(scenario)


# -- concurrent multi-writer commits ------------------------------------------


def test_two_writer_race_converges_to_serialized_oracle():
    """Two forked writers stage against the SAME generation and commit back
    to back; the loser rebases on the winner, so the final index is
    bit-identical to one writer committing both batches serially — in the
    port as in the reference, seed by seed."""
    for seed in (0, 1, 2):
        docs = synth_corpus(90, vocab=200, seed=40 + seed)
        queries = synth_queries(docs, 6, seed=70 + seed)

        def scenario(P, seed=seed, docs=docs, queries=queries):
            rng = random.Random(seed)
            base, extra = docs[:60], docs[60:]
            cut = rng.randrange(5, len(extra) - 5)
            batch_a, batch_b = extra[:cut], extra[cut:]
            del_a = [base[rng.randrange(len(base))][0]]
            del_b = [base[rng.randrange(len(base))][0]]
            racing = build_app(P, base)
            a = racing.indexer
            b = a.fork(1)
            a.stage_delete(del_a)
            a.stage_add(batch_a)
            b.stage_delete(del_b)
            b.stage_add(batch_b)
            ra, _ = a.commit(racing.fn_groups, ping_payload=PING)
            rb, lat = b.commit(racing.fn_groups, ping_payload=PING)
            assert rb["rebased"] == 1 and rb["gen"] == ra["gen"] + 1
            assert a.sync() is True and a.live_corpus() == b.live_corpus()
            serial = build_app(P, base)
            for adds, dels in ((batch_a, del_a), (batch_b, del_b)):
                serial.delete_documents(dels)
                serial.add_documents(adds)
                assert serial.commit().ok
            six = serial.indexer
            assert (b.stats, b.vocab, b._rr) == (six.stats, six.vocab, six._rr)
            assert b.live_corpus() == six.live_corpus()
            out = []
            for q in queries:
                r1 = racing.query(q, k=10, t_arrival=racing.runtime.clock + 0.05,
                                  fetch_docs=False)
                r2 = serial.query(q, k=10, t_arrival=serial.runtime.clock + 0.05,
                                  fetch_docs=False)
                assert r1.body["ext_ids"] == r2.body["ext_ids"]
                assert r1.body["scores"] == r2.body["scores"]
                out.append(r1)
            racing._race = (ra, rb, lat)
            return racing, out + assert_fleet_matches_oracle(racing, queries)

        t, j = both(scenario)
        assert t._race == j._race


def test_publish_conflict_loser_rebases_and_orphans_are_collected():
    docs = synth_corpus(80, vocab=200, seed=44)

    def scenario(P):
        app = build_app(P, docs[:60])
        a = app.indexer
        b = a.fork(1)
        a.stage_add(docs[60:70])
        b.stage_add(docs[70:])
        ra, _ = a.commit(app.fn_groups, ping_payload=PING)
        real_fg, real_pg = b._foreign_gen, b._published_gen
        stale = {"armed": True}

        def stale_fg():
            return None if stale["armed"] else real_fg()

        def stale_pg():
            if stale["armed"]:
                stale["armed"] = False
                return ra["gen"] - 1
            return real_pg()

        b._foreign_gen, b._published_gen = stale_fg, stale_pg
        published = []
        real_pub = b.catalog.publish_segment

        def recording_pub(name, seg, files):
            published.append((name, seg))
            return real_pub(name, seg, files)

        b.catalog.publish_segment = recording_pub
        rb, _ = b.commit(app.fn_groups, ping_payload=PING)
        b.catalog.publish_segment = real_pub
        assert rb["publish_conflicts"] == 1 and rb["rebased"] == 1
        assert rb["gen"] == ra["gen"] + 1
        orphans = [(n, s) for n, s in published
                   if s.startswith(f"g{ra['gen']:06d}") and "w1-" in s]
        assert orphans
        for name, seg in orphans:
            assert app.store.list(app.catalog.segment_prefix(name, seg)) == []
        assert a.sync() is True
        app._race = (ra, rb, published)
        return app, assert_fleet_matches_oracle(app, synth_queries(docs, 5, seed=46))

    t, j = both(scenario)
    assert t._race == j._race


def test_sync_adopts_foreign_publish():
    docs = synth_corpus(70, vocab=200, seed=47)

    def scenario(P):
        app = build_app(P, docs[:60])
        a = app.indexer
        b = a.fork(1)
        out = [app.add_documents(docs[60:]), app.commit()]
        assert b.gen == 1 and b.sync() is True and b.gen == a.gen
        assert b.live_corpus() == a.live_corpus() and b._rr == a._rr
        assert b.sync() is False
        return app, out

    both(scenario)


def test_rebase_conflict_on_same_id_is_loud_and_restores():
    docs = synth_corpus(70, vocab=200, seed=48)

    def scenario(P):
        app = build_app(P, docs[:60])
        a = app.indexer
        b = a.fork(1)
        a.stage_add([docs[60]])
        b.stage_add([docs[60], docs[61]])
        a.commit(app.fn_groups, ping_payload=PING)
        with pytest.raises(ValueError, match="rebase conflict"):
            b.commit(app.fn_groups, ping_payload=PING)
        assert b.gen == 1 and len(b.pending_adds) == 2
        return app, assert_fleet_matches_oracle(app, synth_queries(docs, 4, seed=49))

    both(scenario)
