"""Synthetic corpora with Zipfian term statistics (MS MARCO stand-in).

No datasets ship with this container, so benchmarks/examples generate
corpora whose statistics mimic web passages: Zipf-distributed vocabulary,
log-normal document lengths, queries sampled from document terms (so every
query has matches, like MS MARCO's passage-sourced queries).
"""

from __future__ import annotations

import zlib

import numpy as np

# pronounceable fake terms: cheap bijection id -> string
_SYL = ["ba", "be", "bi", "bo", "bu", "da", "de", "di", "do", "du",
        "ka", "ke", "ki", "ko", "ku", "ma", "me", "mi", "mo", "mu",
        "na", "ne", "ni", "no", "nu", "ra", "re", "ri", "ro", "ru",
        "sa", "se", "si", "so", "su", "ta", "te", "ti", "to", "tu"]


def term_string(tid: int) -> str:
    s = []
    tid += 1
    while tid:
        tid, r = divmod(tid, len(_SYL))
        s.append(_SYL[r])
    return "".join(s)


def synth_corpus(n_docs: int, *, vocab: int = 5000, mean_len: int = 60,
                 seed: int = 0, zipf_a: float = 1.3) -> list[tuple[str, str]]:
    rng = np.random.default_rng(seed)
    lens = np.maximum(4, rng.lognormal(np.log(mean_len), 0.4, n_docs)).astype(int)
    docs = []
    for i in range(n_docs):
        tids = rng.zipf(zipf_a, lens[i]) % vocab
        text = " ".join(term_string(int(t)) for t in tids)
        docs.append((f"doc{i}", text))
    return docs


def synth_pruned_blocks(seed: int, *, n_terms: int, max_blocks: int,
                        n_docs: int, block: int = 128, zipf_a: float = 2.0,
                        k1: float = 0.9, b: float = 0.4, avgdl: float = 12.0):
    """Fabricate one query's gathered, IMPACT-ORDERED postings blocks —
    kernel-shaped inputs for ``bm25_pruned_topk`` without paying
    ``IndexWriter`` costs (1M-doc partitions pack in ms, not minutes).

    Reproduces exactly what ``IndexWriter.pack`` + ``gather_query_blocks``
    would hand the kernel: per term, Zipf-skewed tf postings sorted by f64
    BM25 impact descending, cut into B-lane blocks with f64-computed
    ``block_max`` (cast f32), tf pre-zeroed on invalid blocks, pad lanes
    carrying doc id ``n_docs``. Impact ordering is load-bearing — the
    pruning bound assumes block 0 holds each term's max impact.

    Returns the ``bm25_pruned_topk`` positional inputs
    (tf, dl, docs, idf_q, ub, valid) as numpy arrays.
    """
    rng = np.random.default_rng(seed)
    T, M, B = n_terms, max_blocks, block
    doc_len = rng.integers(5, 4 * int(avgdl), n_docs).astype(np.float32)
    docs = np.full((T, M, B), n_docs, np.int32)
    tf = np.zeros((T, M, B), np.uint8)
    bmax = np.zeros((T, M), np.float64)
    valid = np.zeros((T, M), bool)
    idf = rng.uniform(0.5, 3.0, T).astype(np.float32)
    qtf = rng.integers(1, 3, T).astype(np.float32)
    for t in range(T):
        n_post = int(rng.integers(B // 2, min(M * B, n_docs) + 1))
        d = rng.choice(n_docs, n_post, replace=False).astype(np.int32)
        f = np.minimum(rng.zipf(zipf_a, n_post), 255).astype(np.float64)
        dl = doc_len[d].astype(np.float64)
        imp = idf[t] * f / (f + k1 * (1.0 - b + b * dl / avgdl))
        order = np.argsort(-imp, kind="stable")
        d, f, imp = d[order], f[order], imp[order]
        for m in range(min(M, -(-n_post // B))):
            sl = slice(m * B, min((m + 1) * B, n_post))
            nn = sl.stop - sl.start
            docs[t, m, :nn] = d[sl]
            tf[t, m, :nn] = f[sl]
            bmax[t, m] = imp[sl].max(initial=0.0)
            valid[t, m] = True
    dl_g = np.concatenate([doc_len, np.ones(1, np.float32)])[
        np.minimum(docs, n_docs)]
    idf_q = (idf * qtf).astype(np.float32)
    ub = np.where(valid, qtf[:, None] * bmax, 0.0).astype(np.float32)
    tf = np.where(valid[..., None], tf, 0).astype(np.uint8)
    return tf, dl_g, docs, idf_q, ub, valid


def synth_fielded_corpus(n_docs: int, *, vocab: int = 5000,
                         mean_len: int = 60, n_facets: int = 8,
                         seed: int = 0, zipf_a: float = 1.3
                         ) -> list[tuple[str, dict]]:
    """Fielded twin of :func:`synth_corpus` for the structured (v2) tier:
    every document is ``{"title", "body", "cat"}`` — a short Zipf-sampled
    title, a :func:`synth_corpus`-shaped body, and one categorical facet
    value with Zipf-skewed popularity (realistic facet histograms: a fat
    head value, a long tail)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(4, rng.lognormal(np.log(mean_len), 0.4,
                                       n_docs)).astype(int)
    tlens = rng.integers(2, 6, n_docs)
    docs = []
    for i in range(n_docs):
        ttids = rng.zipf(zipf_a, tlens[i]) % vocab
        btids = rng.zipf(zipf_a, lens[i]) % vocab
        cat = int(rng.zipf(1.6) - 1) % n_facets
        docs.append((f"doc{i}", {
            "title": " ".join(term_string(int(t)) for t in ttids),
            "body": " ".join(term_string(int(t)) for t in btids),
            "cat": f"c{cat}",
        }))
    return docs


def synth_structured_queries(docs: list[tuple[str, dict]], n_queries: int, *,
                             seed: int = 1) -> list[str]:
    """A structured-query mix over a fielded corpus, cycling the DSL's
    clause shapes: bag-of-words, field-scoped terms, quoted phrases
    (adjacent KEPT tokens of one document's body, so the phrase is
    guaranteed to match post-analysis), field-scoped phrases, and boosted
    conjunctions. Terms are sampled from the target document itself, like
    :func:`synth_queries` — every query has matches."""
    from repro_torch.index.tokenizer import tokenize
    rng = np.random.default_rng(seed)
    out: list[str] = []
    while len(out) < n_queries:
        _, text = docs[rng.integers(len(docs))]
        title = tokenize(text["title"])
        body = tokenize(text["body"])
        if len(body) < 3:
            continue
        i = int(rng.integers(len(body) - 1))
        a, b = body[i], body[i + 1]
        c = body[int(rng.integers(len(body)))]
        t = title[int(rng.integers(len(title)))] if title else c
        shape = len(out) % 5
        if shape == 0:                       # plain bag-of-words
            out.append(f"{a} {c}")
        elif shape == 1:                     # fielded term, disjunctive
            out.append(f"title:{t} OR {c}")
        elif shape == 2:                     # unscoped phrase
            out.append(f'"{a} {b}"')
        elif shape == 3:                     # field-scoped phrase + term
            out.append(f'body:"{a} {b}" OR {c}')
        else:                                # boosted conjunction
            out.append(f"title:{t}^2 AND {c}")
    return out


def hash_embedder(dim: int = 16):
    """Deterministic text → unit-norm f32 embedding (no model weights ship
    with the container, so the dense tier embeds with a content-hash-seeded
    Gaussian — the OpenAI-embeddings stand-in). The CRC32 seed depends only
    on the text bytes, so every process, commit, and rebuild derives the
    IDENTICAL vector for a doc — the property the delta-vs-rebuild dense
    parity tests lean on."""
    def embed(text: str) -> np.ndarray:
        rng = np.random.default_rng(zlib.crc32(text.encode("utf-8")))
        v = rng.standard_normal(dim).astype(np.float32)
        n = float(np.linalg.norm(v))
        return (v / np.float32(n)) if n else v

    embed.dim = dim
    return embed


def synth_queries(docs: list[tuple[str, str]], n_queries: int, *,
                  terms_per_query: int = 3, seed: int = 1) -> list[str]:
    rng = np.random.default_rng(seed)
    queries = []
    for _ in range(n_queries):
        _, text = docs[rng.integers(len(docs))]
        toks = text.split()
        take = min(terms_per_query, len(toks))
        picks = rng.choice(len(toks), size=take, replace=False)
        queries.append(" ".join(toks[p] for p in picks))
    return queries
