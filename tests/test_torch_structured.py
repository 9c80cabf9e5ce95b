"""The structured tier, layer by layer, in both packages (the port of
``tests/test_structured.py``).

* tokenizer and query DSL — the port's copies answer exactly as the
  reference's: fielded views, positions, spans, ASTs and parse errors.
* format — the port's v1 and v2 segments are the reference's bytes.
* evaluator — the port's device evaluator (here on the CPU) equals the
  reference's numpy one BIT for bit: every leaf's contribution and match
  mask (term, fielded term, 2- and 3-term phrases, a document past position
  65,535), whole queries' scores and eligibility, top-k ids and score bits,
  facet counts and snippets; and the port's ``StructuredOracleSearcher``
  equals the reference's and its own dict-based ``exact_*`` twins.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data.corpus import synth_fielded_corpus, synth_structured_queries
from repro.index import builder as jb
from repro.index import tokenizer as jt
from repro.search import structured as js
from repro_torch.index import builder as tb
from repro_torch.index import tokenizer as tt
from repro_torch.search import structured as ts
from repro_torch.search.structured import StructuredState
from torch_pairs import J, PACKAGES, T, bits


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(a, b) -> None:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


# -- tokenizer: the edge cases the field split exposes -------------------------


def test_empty_field_contributes_nothing_but_stays_declared():
    doc = {"title": "", "body": "hello world"}
    for tok in (jt, tt):
        assert tok.field_items(doc) == [("title", ""), ("body", "hello world")]
        assert tok.tokenize(doc) == ["hello", "world"]
        assert tok.tokenize_positions(doc) == [("body", "hello", 0), ("body", "world", 1)]
        assert tok.field_token_counts(doc) == {"title": 0, "body": 2}


def test_stopword_only_field_has_zero_kept_length():
    doc = {"title": "the of and a", "body": "serverless lucene"}
    long = "x" * 65
    for tok in (jt, tt):
        assert tok.tokenize(doc) == ["serverless", "lucene"]
        assert [p for p in tok.tokenize_positions(doc) if p[0] == "title"] == []
        assert tok.field_token_counts(doc)["title"] == 0
        assert tok.tokenize({"t": long}) == []
        assert tok.tokenize_positions({"t": f"{long} ok"}) == [("t", "ok", 0)]


def test_duplicate_terms_keep_distinct_positions():
    for tok in (jt, tt):
        assert tok.tokenize_positions({"body": "data big data"}) == [
            ("body", "data", 0), ("body", "big", 1), ("body", "data", 2)]
        assert tok.tokenize_positions("the big data") == [("body", "big", 0),
                                                          ("body", "data", 1)]
        assert tok.tokenize_positions({"title": "data", "body": "data"}) == [
            ("title", "data", 0), ("body", "data", 0)]


def test_flatten_invariant_fielded_doc_equals_concatenation():
    doc = {"title": "Serverless Lucene", "body": "big data engines"}
    for tok in (jt, tt):
        assert tok.flatten_text(doc) == "Serverless Lucene big data engines"
        assert tok.tokenize(doc) == tok.tokenize(tok.flatten_text(doc))
        assert sum(tok.field_token_counts(doc).values()) == len(tok.tokenize(doc))
        assert tok.field_items("hi world") == [("body", "hi world")]


def test_spans_index_the_original_text():
    text = "The BIG-data engine"
    assert tt.tokenize_spans(text) == jt.tokenize_spans(text)
    for tok, s, e in tt.tokenize_spans(text):
        assert text[s:e].lower() == tok


# -- query DSL: the port's ASTs are the reference's ------------------------------

DSL = ['title:"serverless lucene" body:big^2 data', "a1 OR b1", "a1 AND b1",
       "a1 AND b1 OR c1", "data data title:data", '"big data" "big data"',
       '"data" data', '"the big data" of', "of the",
       'title:"serverless lucene"^1.5 AND body:big data data']


def test_parse_clause_shapes():
    for P in PACKAGES:
        ph, bt, dt = P.parse_query(DSL[0]).leaves
        assert (ph.kind, ph.field, ph.terms) == ("phrase", "title", ["serverless", "lucene"])
        assert (bt.kind, bt.field, bt.boost) == ("term", "body", 2.0)
        assert (dt.kind, dt.field, dt.terms) == ("term", None, ["data"])
    assert T.parse_query(DSL[0]).terms == ["serverless", "lucene", "big", "data"]


def test_asts_equal_the_reference():
    for sq in DSL:
        t, j = T.parse_query(sq), J.parse_query(sq)
        assert t.to_payload() == j.to_payload(), sq
        assert (t.conjunctive, t.terms) == (j.conjunctive, j.terms), sq


def test_any_and_makes_the_query_conjunctive():
    for P in PACKAGES:
        assert not P.parse_query("a1 OR b1").conjunctive
        assert P.parse_query("a1 AND b1 OR c1").conjunctive


def test_duplicate_terms_merge_qtf_but_phrases_never_merge():
    for P in PACKAGES:
        q = P.parse_query("data data title:data")
        assert [(lf.terms[0], lf.field, lf.qtf) for lf in q.leaves] == [
            ("data", None, 2), ("data", "title", 1)]
        assert [lf.kind for lf in P.parse_query('"big data" "big data"').leaves] == [
            "phrase", "phrase"]
        assert P.parse_query('"data" data').leaves[0].qtf == 2


def test_parse_errors_match_the_reference():
    for bad in ('"unbalanced', "x^nope", "x^0", "x^-1", "AND x", "x AND", None):
        msgs = []
        for P in PACKAGES:
            with pytest.raises(P.QueryParseError) as ei:
                P.parse_query(bad)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], bad


def test_payload_round_trip_across_packages():
    q = J.parse_query(DSL[-1])
    assert T.query_from_payload(q.to_payload()).to_payload() == q.to_payload()
    assert T.query_from_payload(q.to_payload()) == T.parse_query(DSL[-1])


# -- format: the port's segments are the reference's bytes ----------------------

DOCS = [
    ("d0", {"title": "serverless lucene", "body": "a prototype of serverless "
            "lucene", "cat": "systems"}),
    ("d1", {"title": "big data", "body": "serverless big data engines",
            "cat": "systems"}),
    ("d2", {"title": "tails", "body": "tail latency in big fleets",
            "cat": "cloud"}),
    ("d3", {"title": "facets", "body": "faceted navigation data data data",
            "cat": "ir"}),
]
FLAT = [(e, jt.flatten_text(t)) for e, t in DOCS]


def _pack(W, docs, **kw):
    w = W(**kw)
    for e, t in docs:
        w.add(e, t)
    return w.pack()


def test_v1_bytes_equal_the_reference():
    t, j = _pack(tb.IndexWriter, FLAT), _pack(jb.IndexWriter, FLAT)
    assert t.fields is None
    assert tb.pack_superindex(t) == jb.pack_superindex(j)
    assert tb.pack_payload(t) == jb.pack_payload(j)


def test_v2_bytes_equal_the_reference_and_extend_v1():
    t = _pack(tb.IndexWriter, DOCS, structured=True, facet_fields=("cat",))
    j = _pack(jb.IndexWriter, DOCS, structured=True, facet_fields=("cat",))
    assert tb.pack_superindex(t) == jb.pack_superindex(j)
    assert tb.pack_payload(t) == jb.pack_payload(j)
    v1 = tb.pack_superindex(_pack(tb.IndexWriter, FLAT))
    assert tb.pack_superindex(t)[4:4 + len(v1) - 4] == v1[4:]


def test_v2_round_trip_restores_occurrence_arrays():
    v2 = _pack(tb.IndexWriter, DOCS, structured=True, facet_fields=("cat",))
    fd = v2.fields
    meta, _, _, fh = tb.unpack_superindex(tb.pack_superindex(v2))
    assert (fh["field_names"], fh["facet_values"]) == (fd.field_names, fd.facet_values)
    docs, tf, nocc, occf, occp = tb.unpack_payload_rows(tb.pack_payload(v2), meta.block,
                                                        fh["pos_slots"])
    np.testing.assert_array_equal(nocc, fd.block_nocc)
    np.testing.assert_array_equal(occf, fd.block_occ_field)
    np.testing.assert_array_equal(occp, fd.block_occ_pos)


def test_stripping_fields_restores_v1_bytes_exactly():
    v1 = _pack(tb.IndexWriter, FLAT)
    v2 = _pack(tb.IndexWriter, DOCS, structured=True, facet_fields=("cat",))
    stripped = dataclasses.replace(v2, fields=None)
    assert tb.pack_superindex(stripped) == tb.pack_superindex(v1)
    assert tb.pack_payload(stripped) == tb.pack_payload(v1)


# -- evaluator: bitwise against the reference's numpy evaluator -----------------

CORPUS = DOCS + [
    ("d4", {"title": "big big big", "body": " ".join(["big"] * 12),
            "cat": "systems"}),               # > POS_SLOTS occurrences
    ("d5", {"title": "", "body": "the of and", "cat": "cloud"}),  # empty-ish
    ("d6", {"title": "far away", "body": " ".join(["filler"] * 65_530)
            + " alpha beta gamma delta alpha beta gamma",
            "cat": "ir"}),                    # positions past the uint16 clamp
    ("d7", {"title": "big data systems", "body": "serverless big data engines "
            "at scale big data", "cat": "systems"}),
]

QUERIES = [
    'title:"serverless lucene" OR big',
    'body:big AND data',
    '"big data"^2 systems',
    'cat:systems',
    'title:big',
    'serverless lucene',                      # plain bag-of-words
    '"big big" OR facets',                    # repeated-term phrase
    '"serverless big data"',                  # 3-term phrase
    'body:"big data engines" AND serverless',
    '"alpha beta"', '"beta gamma"', '"gamma delta"',   # near/past 65,535
    'body:"delta alpha beta"', 'filler^3 OR "big big big"',
    'zzzz title:big', 'nofield:big',
]
FAVG = {"title": 2.25, "body": 8213.5, "cat": 1.0}


@pytest.fixture(scope="module")
def packs():
    j = _pack(jb.IndexWriter, CORPUS, structured=True, facet_fields=("cat",))
    t = _pack(tb.IndexWriter, CORPUS, structured=True, facet_fields=("cat",))
    return j, t, StructuredState.from_packed(t, device="cpu")


def test_positions_clamp_past_65535(packs):
    j, _, state = packs
    pos = state.block_occ_pos
    assert pos.dtype == torch.int32 and int(pos.max()) == 0xFFFF
    assert int(np.asarray(j.fields.block_occ_pos).max()) == 0xFFFF


@pytest.mark.parametrize("sq", QUERIES)
def test_leaf_contributions_bitwise(packs, sq):
    j, _, state = packs
    for jleaf, tleaf in zip(J.parse_query(sq).leaves, T.parse_query(sq).leaves, strict=True):
        want_c, want_m = js.leaf_contribution(j, jleaf, field_avgdl=FAVG)
        got_c, got_m = ts.leaf_contribution(state, tleaf, field_avgdl=FAVG)
        _same_bits(got_c, want_c)
        _same_bits(got_m, want_m)


@pytest.mark.parametrize("sq", QUERIES)
def test_evaluate_structured_bitwise(packs, sq):
    j, _, state = packs
    want_s, want_e = js.evaluate_structured(j, J.parse_query(sq), field_avgdl=FAVG)
    got_s, got_e = ts.evaluate_structured(state, T.parse_query(sq), field_avgdl=FAVG)
    _same_bits(got_s, want_s)
    _same_bits(got_e, want_e)
    for k in (1, 3, 20):                       # k past n_docs pads (0.0, n_docs)
        wv, wi = js.structured_topk(want_s, k)
        gv, gi = ts.structured_topk(got_s, k)
        _same_bits(gv, wv)
        _same_bits(gi, wi)
    assert ts.facet_counts(state, got_e, "cat") == js.facet_counts(j, want_e, "cat")


def test_synthetic_fielded_corpus_bitwise():
    """A Zipf fielded corpus with the benchmark's query mix (terms, fielded
    terms, phrases, scoped phrases, boosted conjunctions): scores,
    eligibility, batched top-k and batched facets equal the reference's."""
    docs = synth_fielded_corpus(600, vocab=300, seed=3)
    j = _pack(jb.IndexWriter, docs, structured=True, facet_fields=("cat",))
    t = _pack(tb.IndexWriter, docs, structured=True, facet_fields=("cat",))
    state = StructuredState.from_packed(t, device="cpu")
    stats = jb.compute_global_stats(docs, fields=True)
    favg = {f: jb.field_avgdl(stats, f) for f in stats["fields"]}
    qs = synth_structured_queries(docs, 30, seed=16)
    got, want = [], []
    for sq in qs:
        ws, we = js.evaluate_structured(j, J.parse_query(sq), field_avgdl=favg)
        gs, ge = ts.evaluate_structured(state, T.parse_query(sq), field_avgdl=favg)
        _same_bits(gs, ws)
        _same_bits(ge, we)
        got.append((gs, ge))
        want.append((ws, we))
    gv, gi = ts.structured_topk(torch.stack([s for s, _ in got]), 50)
    for qi, (ws, _) in enumerate(want):
        wv, wi = js.structured_topk(ws, 50)
        _same_bits(gv[qi], wv)
        _same_bits(gi[qi], wi)
    counts = ts.facet_counts(state, torch.stack([e for _, e in got]), "cat")
    assert counts == [js.facet_counts(j, we, "cat") for _, we in want]


def test_v1_pack_refuses_fields_phrases_and_facets():
    t = _pack(tb.IndexWriter, FLAT)
    state = StructuredState.from_packed(t, device="cpu")
    for sq in ("title:big", '"big data"'):
        with pytest.raises(ts.StructuredUnsupported):
            ts.evaluate_structured(state, T.parse_query(sq), field_avgdl={})
    _, eligible = ts.evaluate_structured(state, T.parse_query("big"), field_avgdl={})
    with pytest.raises(ts.StructuredUnsupported):
        ts.facet_counts(state, eligible, "cat")


# -- the oracle: the port's equals the reference's and its dict twins -----------


@pytest.fixture(scope="module")
def oracles():
    return (J.StructuredOracleSearcher(CORPUS, facet_fields=("cat",)),
            T.StructuredOracleSearcher(CORPUS, facet_fields=("cat",)))


@pytest.mark.parametrize("sq", QUERIES)
def test_packed_match_sets_equal_dict_twins(oracles, sq):
    j, t = oracles
    assert t.match_set(sq) == j.match_set(sq) == t.exact_match_set(sq), sq


@pytest.mark.parametrize("sq", QUERIES)
def test_packed_facets_equal_dict_twins(oracles, sq):
    j, t = oracles
    assert t.facet_counts(sq, "cat") == j.facet_counts(sq, "cat") == \
        t.exact_facet_counts(sq, "cat"), sq


@pytest.mark.parametrize("sq", QUERIES)
def test_oracle_topk_equals_the_reference(oracles, sq):
    j, t = oracles
    got, want = t.search(sq, 5), j.search(sq, 5)
    assert [d for d, _ in got] == [d for d, _ in want], sq
    assert bits([s for _, s in got]) == bits([s for _, s in want]), sq


def test_pos_slots_truncation_is_symmetric(oracles):
    _, t = oracles
    d4 = next(i for i, (e, _) in enumerate(CORPUS) if e == "d4")
    m = t.match_set('body:"big big"')
    assert d4 in m and m == t.exact_match_set('body:"big big"')


def test_bag_of_words_structured_matches_legacy_oracle_ranking(oracles):
    _, t = oracles
    legacy = T.OracleSearcher([(e, tt.flatten_text(x)) for e, x in CORPUS])
    for q in ("serverless lucene", "big data", "data data big"):
        want, got = legacy.search(q, 10), t.search(q, 10)
        assert [d for d, _ in got] == [d for d, _ in want], q
        for (_, a), (_, b) in zip(got, want):
            assert a == pytest.approx(b, rel=1e-5), q


def test_unknown_terms_fields_and_values_match_nothing(oracles):
    _, t = oracles
    assert t.match_set("zzzz") == t.match_set("nofield:big") == set()
    assert t.match_set('"serverless zzzz"') == set()
    assert t.search("zzzz", 5) == [] and t.facet_counts("zzzz", "cat") == {}


def test_conjunction_needs_every_leaf(oracles):
    _, t = oracles
    assert t.match_set("serverless AND data") == \
        t.match_set("serverless") & t.match_set("data")
    assert t.match_set("serverless OR data") == \
        t.match_set("serverless") | t.match_set("data")


def test_facet_counts_cover_full_match_set_not_topk(oracles):
    _, t = oracles
    _, eligible = t.evaluate("big")
    got = ts.facet_counts(t.state, eligible, "cat")
    assert sum(got.values()) == int(eligible.sum())
    with pytest.raises(Exception, match="not declared"):
        ts.facet_counts(t.state, eligible, "title")


def test_merge_facet_counts_orders_deterministically():
    parts = [{"b": 2, "a": 1}, {"a": 1, "c": 2}]
    merged = ts.merge_facet_counts(parts)
    assert merged == js.merge_facet_counts(parts)
    assert list(merged.items()) == [("a", 2), ("b", 2), ("c", 2)]
    assert ts.merge_facet_counts([]) == {}


# -- snippets: the port's cutter is the reference's -----------------------------

SNIP_DOC = {"title": "Serverless Lucene", "body":
            "A prototype of serverless Lucene running on cloud functions, "
            "where big data workloads meet pay-per-query economics."}


def test_snippet_covers_every_matched_term():
    snip = ts.make_snippet(SNIP_DOC, ["serverless", "big", "economics"])
    assert snip == js.make_snippet(SNIP_DOC, ["serverless", "big", "economics"])
    for t in ("serverless", "big", "economics"):
        assert "<em>" in snip and t in snip.lower()
    assert "<em>Serverless</em>" in snip


def test_snippet_falls_back_to_head_when_nothing_matches():
    doc = {"body": "x" * 200}
    snip = ts.make_snippet(doc, ["absent"])
    assert snip == js.make_snippet(doc, ["absent"])
    assert snip.startswith("x") and snip.endswith("…") and "<em>" not in snip
    assert ts.make_snippet({"body": ""}, ["absent"]) == ""


def test_snippet_merges_overlapping_windows():
    body = "alpha beta gamma " * 3 + "delta"
    snip = ts.make_snippet({"body": body}, ["beta", "gamma"])
    assert snip == js.make_snippet({"body": body}, ["beta", "gamma"])
    assert "<em>beta</em> <em>gamma</em>" in snip


def test_field_avgdl_from_global_stats():
    t, j = (P.compute_global_stats(DOCS, fields=True) for P in (T, J))
    assert t == j
    assert T.field_avgdl(t, "title") == J.field_avgdl(j, "title")
    assert T.field_avgdl(t, "absent") == 1.0


# -- the handler: one K2 call a batch, facets over the stacked eligibility -------


def test_search_structured_equals_per_query_reference(packs):
    """``Searcher.search_structured`` evaluates a micro-batch, takes ONE
    top-k over the stacked scores and counts facets over the stacked
    eligibility: its hits and facets equal the reference handler's
    per-query loop."""
    j, t, _ = packs
    searcher = T.Searcher(t)
    asts = [T.parse_query(sq) for sq in QUERIES]
    facets = [["cat"] if i % 2 else [] for i in range(len(asts))]
    hits, counts = searcher.search_structured(asts, 4, field_avgdl=FAVG, facets=facets)
    n = j.meta.n_docs
    for qi, sq in enumerate(QUERIES):
        scores, eligible = js.evaluate_structured(j, J.parse_query(sq), field_avgdl=FAVG)
        vals, ids = js.structured_topk(scores, 4)
        want = [(int(i), float(v)) for v, i in zip(vals, ids) if i < n and v > 0]
        assert hits[qi] == want, sq
        assert counts[qi] == {f: js.facet_counts(j, eligible, f) for f in facets[qi]}
