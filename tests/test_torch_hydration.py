"""Lazy hydration in both packages: the port's ``index/hydration.py`` reads
the same extents and bytes as the reference from the same published
segments, and inside the port a partial view ranks bit-identically to full
hydration — plain versions, NRT generations (base + delta + tombstones) and
the dense tier's live rows alike. The handlers bill hydration and backfill
exactly as the reference's do.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.cache import HydrationCache as JCache
from repro.core.kvstore import KVStore as JKV
from repro.core.object_store import ObjectStore as JStore
from repro.core.refresh import AssetCatalog as JCatalog
from repro.core.runtime import FaaSRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JRuntimeConfig
from repro.data.corpus import synth_corpus, synth_queries
from repro.index import hydration as jh
from repro.search.searcher import SearchConfig as JSearchConfig
from repro.search.searcher import make_search_handler as j_handler
from repro_torch.core.cache import HydrationCache
from repro_torch.core.kvstore import KVStore
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.refresh import AssetCatalog, GenerationManifest
from repro_torch.core.runtime import FaaSRuntime, RuntimeConfig
from repro_torch.index import hydration as th
from repro_torch.index.builder import (PAYLOAD_FILE, SUPERINDEX_FILE, IndexWriter,
                                       combine_segments, combine_vector_segments,
                                       compute_global_stats, extend_vocab, global_vocab,
                                       pack_vectors, update_stats, write_segment,
                                       write_vector_segment)
from repro_torch.index.tokenizer import tokenize
from repro_torch.search.searcher import (LazySearcher, SearchConfig, Searcher,
                                         hydrate_searcher, lazy_hydrate_dense_searcher,
                                         lazy_hydrate_searcher, make_search_handler)


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


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(400, vocab=600, seed=31)


@pytest.fixture(scope="module")
def queries(corpus):
    return synth_queries(corpus, 10, seed=33)


@pytest.fixture(scope="module")
def packed(corpus):
    w = IndexWriter()
    w.add_many(corpus)
    return w.pack()


def _stores(segments: dict, name="idx", version="v1"):
    """The same segment bytes published in both packages' stores; returns
    (port store, port catalog, reference store, reference catalog)."""
    out = []
    for store_cls, cat_cls in ((ObjectStore, AssetCatalog), (JStore, JCatalog)):
        store = store_cls()
        cat = cat_cls(store)
        for seg, directory in segments.items():
            if seg is None:
                cat.publish(name, version, directory)
            else:
                cat.publish_segment(name, seg, directory)
        out += [store, cat]
    return out


def _stats(store):
    return (store.stats.gets, store.stats.bytes_out, store.stats.sim_seconds)


def _bits(scores):
    return [np.float32(s).view(np.uint32) for s in scores]


# -- extents and bytes: the port reads what the reference reads --------------------


def test_coalesce_extents_matches_reference():
    rng = np.random.default_rng(0)
    for gap in (0, 10, 1000):
        ext = [(int(a), int(a + b)) for a, b in
               zip(rng.integers(0, 5000, 40), rng.integers(0, 300, 40))]
        assert th.coalesce_extents(ext, gap) == jh.coalesce_extents(ext, gap)


def test_partial_segment_reads_the_reference_extents(packed, queries):
    """Header GET, then the queried terms' coalesced row ranges, then
    backfill: after every step both packages moved the same bytes with the
    same GETs, and hold the same arrays."""
    store, cat, jstore, jcat = _stores({None: write_segment(packed)})
    seg = th.open_partial_segment(cat.open("idx", "v1")[1])
    jseg = jh.open_partial_segment(jcat.open("idx", "v1")[1])
    for q in queries[:4]:
        tids = [packed.vocab[t] for t in tokenize(q) if t in packed.vocab]
        assert seg.hydrate_terms(tids) == jseg.hydrate_terms(tids)
        assert seg.bytes_read == jseg.bytes_read
        assert _stats(store) == _stats(jstore)
        assert (seg._rows_live == jseg._rows_live).all()
    assert not seg.full
    view = seg.to_packed()
    dead = ~seg._rows_live
    assert (view.block_docs[dead] == packed.meta.n_docs).all()
    assert (view.block_tf[dead] == 0).all()
    assert seg.backfill() and jseg.backfill()
    assert _stats(store) == _stats(jstore) and seg.bytes_read == jseg.bytes_read
    assert np.array_equal(seg.block_docs, packed.block_docs)
    assert np.array_equal(seg.block_tf, packed.block_tf)
    assert not seg.backfill()


def test_missing_superindex_raises(packed):
    store, cat, _, _ = _stores({None: write_segment(packed)})
    _, directory = cat.open("idx", "v1")
    store.delete(directory.prefix + SUPERINDEX_FILE)
    with pytest.raises(th.SuperIndexMissing):
        th.open_partial_segment(cat.open("idx", "v1")[1])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_lazy_vectors_read_the_reference_rows(dtype):
    """``ensure_live`` pulls only live row spans — the same GETs and bytes
    as the reference — and the combined view equals the eager combine."""
    rng = np.random.default_rng(3)
    base = pack_vectors(rng.standard_normal((20, DIM)).astype(np.float32),
                        [f"b{i}" for i in range(20)], dtype=dtype)
    delta = pack_vectors(rng.standard_normal((7, DIM)).astype(np.float32),
                         [f"x{i}" for i in range(7)], dtype=dtype)
    tombs = [0, 5, 6, 22]
    store, cat, jstore, jcat = _stores({"base": write_vector_segment(base),
                                        "delta": write_vector_segment(delta)})
    lazy = th.LazyVectors([th.open_partial_vector_segment(cat.open_segment("idx", s))
                           for s in ("base", "delta")], tombstones=tombs)
    jlazy = jh.LazyVectors([jh.open_partial_vector_segment(jcat.open_segment("idx", s))
                            for s in ("base", "delta")], tombstones=tombs)
    assert lazy.ensure_live() and jlazy.ensure_live()
    assert _stats(store) == _stats(jstore) and lazy.bytes_read == jlazy.bytes_read
    assert not lazy.ensure_live()
    vecs, ids, live = lazy.combined()
    jvecs, jids, jlive = jlazy.combined()
    evecs, eids, elive = combine_vector_segments([base, delta], tombs)
    assert ids == jids == eids and (live == jlive).all() and (live == elive).all()
    assert (vecs[live] == evecs[elive]).all() and (vecs == jvecs).all()
    part = th.open_partial_vector_segment(cat.open_segment("idx", "base"))
    part.hydrate_rows([(5, 12)])
    assert (part.vectors[5:12] == base.vectors[5:12]).all() and not part.full
    part.backfill()
    assert part.full and (part.as_f32() == base.as_f32()).all()


# -- partial == full, bitwise, inside the port -------------------------------------


def _nrt_generation():
    """A base + delta generation with three tombstones, and the fused
    PackedIndex a full hydration of it gives."""
    docs = synth_corpus(240, vocab=400, seed=5)
    base_docs, new_docs = docs[:180], docs[180:]
    deleted = {docs[3][0], docs[100][0], docs[200][0]}
    stats = compute_global_stats(base_docs)
    vocab = global_vocab(stats)
    w = IndexWriter(global_stats=stats, vocab=vocab)
    w.add_many(base_docs)
    base = w.pack()
    vocab2 = extend_vocab(vocab, (t for _, txt in new_docs for t in tokenize(txt)))
    delta = IndexWriter.delta(new_docs, stats, vocab=vocab2)
    live_stats = dict(stats, df=dict(stats["df"]))
    by_id = dict(docs)
    for _, t in new_docs:
        update_stats(live_stats, t, sign=1)
    for e in deleted:
        update_stats(live_stats, by_id[e], sign=-1)
    dead = [i for i, (e, _) in enumerate(base_docs + new_docs) if e in deleted]
    combined = combine_segments([base, delta], vocab=vocab2, stats=live_stats,
                                tombstones=dead)
    return docs, base, delta, vocab2, live_stats, dead, combined


def _same_searches(a: Searcher, b: Searcher, queries):
    va, ia = a.search(queries)
    vb, ib = b.search(queries)
    assert np.array_equal(va.view(np.uint32), vb.view(np.uint32))
    assert np.array_equal(ia, ib)


@pytest.mark.parametrize("accumulator", ["dense", "pruned"])
def test_partial_hydration_bit_identical_under_nrt(accumulator):
    """With only the query terms' blocks hydrated, the fused view of base +
    delta + tombstones ranks bit-identically to full hydration; backfill
    then reproduces the full index bit for bit."""
    docs, base, delta, vocab2, live_stats, dead, combined = _nrt_generation()
    store, cat, _, _ = _stores({"base": write_segment(base), "delta": write_segment(delta)})
    lazy = th.LazyIndex([th.open_partial_segment(cat.open_segment("idx", s))
                         for s in ("base", "delta")],
                        vocab=vocab2, stats=live_stats, tombstones=dead)
    assert lazy.state == "partial"
    queries = synth_queries(docs, 15, seed=6)
    lazy.ensure_terms({t for q in queries for t in tokenize(q)})
    cfg = SearchConfig(max_blocks=64, k=K, accumulator=accumulator)
    full = Searcher(combined, cfg, device="cpu")
    _same_searches(full, Searcher(lazy.packed(), cfg, device="cpu"), queries)
    lazy.backfill()
    assert lazy.state == "full"
    fused = lazy.packed()
    for name in ("block_docs", "block_tf", "block_max", "term_offsets", "doc_len", "idf"):
        assert np.array_equal(getattr(fused, name), getattr(combined, name)), name


def test_generation_manifest_hydrates_eager_and_lazy_alike():
    """``hydrate_searcher``'s generation branch fuses base + delta under the
    manifest's live stats: it serves the full combine, and the lazy entry
    over the same manifest answers the same bits."""
    docs, base, delta, vocab2, live_stats, dead, combined = _nrt_generation()
    store, cat, _, _ = _stores({"base": write_segment(base), "delta": write_segment(delta)})
    cat.publish_generation("idx", GenerationManifest(
        gen=1, base="base", deltas=["delta"], tombstones=dead,
        stats=live_stats, vocab=vocab2))
    cfg = SearchConfig(sim_exec_s=0.002)
    eager, eager_s = hydrate_searcher(cat, "idx", cfg, device="cpu")
    lazy, lazy_s = lazy_hydrate_searcher(cat, "idx", cfg, device="cpu")
    assert isinstance(lazy, LazySearcher) and 0 < lazy_s < eager_s
    queries = synth_queries(docs, 8, seed=7)
    lazy.ensure_queries(queries)
    _same_searches(eager, Searcher(combined, cfg, device="cpu"), queries)
    _same_searches(eager, lazy.searcher, queries)


# -- the handlers: the reference's bytes, records and ledger ------------------------


def _handler_pair(packed, corpus, cfg_kw, **publish):
    """One function per package over the same published bytes."""
    segments = {None: write_segment(packed)}
    store, cat, jstore, jcat = _stores(segments)
    rt, jrt = FaaSRuntime(RuntimeConfig(seed=0)), JRuntime(JRuntimeConfig(seed=0))
    kv, jkv = KVStore(), JKV()
    for ext, text in corpus:
        kv.put(ext, {"id": ext, "contents": text})
        jkv.put(ext, {"id": ext, "contents": text})
    rt.register("s", make_search_handler(cat, kv, "idx", SearchConfig(**cfg_kw), "cpu"))
    jrt.register("s", j_handler(jcat, jkv, "idx", JSearchConfig(**cfg_kw)))
    return (store, cat, rt), (jstore, jcat, jrt)


def _same_runtime(rt, jrt):
    for a, b in zip(rt.records, jrt.records, strict=True):
        assert (a.fn, a.cold, a.hydrate_s, a.backfill_s, a.latency_s, a.exec_s,
                a.t_arrival, a.t_done) == (b.fn, b.cold, b.hydrate_s, b.backfill_s,
                                           b.latency_s, b.exec_s, b.t_arrival, b.t_done)
    assert dataclasses.asdict(rt.ledger) == dataclasses.asdict(jrt.ledger)
    assert ([i.cache.used_bytes for i in rt._instances]
            == [i.cache.used_bytes for i in jrt._instances])


@pytest.mark.parametrize("accumulator", ["dense", "pruned"])
def test_lazy_handler_bills_like_reference(packed, corpus, queries, accumulator):
    """Cold lazy query: header + query-term ranges on the critical path,
    backfill on its own ledger line; every record, ledger line and cache
    byte count equals the reference's, and the answers equal the eager
    port's bit for bit."""
    cfg = dict(sim_exec_s=0.002, lazy_hydration=True, accumulator=accumulator)
    (store, _, rt), (jstore, _, jrt) = _handler_pair(packed, corpus, cfg)
    (_, _, rt_e), _ = _handler_pair(packed, corpus, dict(cfg, lazy_hydration=False))
    for i, q in enumerate(queries[:5]):
        t = rt.clock + 1.0
        got, rec = rt.invoke("s", {"q": q, "k": K}, t_arrival=t)
        want, _ = jrt.invoke("s", {"q": q, "k": K}, t_arrival=t)
        eager, _ = rt_e.invoke("s", {"q": q, "k": K}, t_arrival=t)
        assert got["ids"] == want["ids"] == eager["ids"]
        assert _bits(got["scores"]) == _bits(eager["scores"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6, atol=0)
        assert rec.cold == (i == 0) and (rec.backfill_s > 0) == (i == 0)
    _same_runtime(rt, jrt)
    assert _stats(store) == _stats(jstore)
    assert rt.ledger.backfill_invocations == 1


def test_prewarm_ping_and_eager_fallback_like_reference(packed, corpus, queries):
    """A prewarm ping hydrates the top-df terms without backfill; a segment
    without the lazy layout falls back to eager hydration. Both as the
    reference does, byte for byte."""
    cfg = dict(sim_exec_s=0.002, lazy_hydration=True)
    (store, _, rt), (jstore, _, jrt) = _handler_pair(packed, corpus, cfg)
    for r in (rt, jrt):
        out, rec = r.invoke("s", {"q": "", "k": 1, "fetch_docs": False,
                                  "prewarm_terms": 16})
        assert out["prewarmed"] and rec.backfill_s == 0
        r.invoke("s", {"q": queries[0], "k": K}, t_arrival=r.clock + 1.0)
    _same_runtime(rt, jrt)
    assert _stats(store) == _stats(jstore)

    (store, cat, rt), (jstore, jcat, jrt) = _handler_pair(packed, corpus, cfg)
    for s, c in ((store, cat), (jstore, jcat)):
        prefix = c.open("idx", "v1")[1].prefix
        s.delete(prefix + SUPERINDEX_FILE)
        s.delete(prefix + PAYLOAD_FILE)
    res, rec = rt.invoke("s", {"q": queries[0], "fetch_docs": False})
    jres, _ = jrt.invoke("s", {"q": queries[0], "fetch_docs": False})
    assert rec.cold and rec.hydrate_s > 0 and rec.backfill_s == 0
    assert res["ids"] == jres["ids"] and res["ids"]
    _same_runtime(rt, jrt)


def test_lazy_dense_entry_pulls_live_rows_like_reference(corpus):
    """The dense tier's lazy entry: one header GET, then exactly the live
    rows; the searcher it lends scores the eager combine's rows."""
    from repro.search.searcher import lazy_hydrate_dense_searcher as j_lazy_dense
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((50, DIM)).astype(np.float32)
    pv = pack_vectors(vecs, [d for d, _ in corpus[:50]])
    store, cat, jstore, jcat = _stores({None: write_vector_segment(pv)})
    cfg, jcfg = SearchConfig(sim_exec_s=0.002), JSearchConfig(sim_exec_s=0.002)
    entry, sim_s = lazy_hydrate_dense_searcher(cat, "idx", cfg, device="cpu")
    jentry, jsim_s = j_lazy_dense(jcat, "idx", jcfg)
    assert sim_s == jsim_s
    assert entry.ensure_live() == jentry.ensure_live()
    assert entry.nbytes == jentry.nbytes and _stats(store) == _stats(jstore)
    assert (entry.searcher.rows.numpy() == vecs).all()
    assert entry.searcher.nbytes == jentry.searcher.nbytes
    q = list(rng.standard_normal((3, DIM)).astype(np.float32))
    got, want = entry.searcher.search_batch(q), jentry.searcher.search_batch(q)
    assert [[i for i, _ in h] for h in got] == [[i for i, _ in h] for h in want]
    cache = HydrationCache(1 << 30)
    jcache = JCache(1 << 30)
    cache.get_or_hydrate("idx", "v1", lambda: (entry, sim_s))
    jcache.get_or_hydrate("idx", "v1", lambda: (jentry, jsim_s))
    assert cache.used_bytes == jcache.used_bytes
