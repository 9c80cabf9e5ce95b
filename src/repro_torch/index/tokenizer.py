"""Minimal Lucene-style analyzer: lowercase, alnum tokenization, stopwords.

Anserini's default analyzer additionally applies Porter stemming; we keep
analysis deliberately simple (documented deviation — ranking-quality
parity with Anserini is not a claim of this reproduction; latency/cost are).

Structured (fielded) documents: a document's text may be either a plain
string (one implicit ``body`` field) or a mapping ``{field: text}``. Every
bag-of-words consumer keeps working on either shape — :func:`tokenize`
flattens a mapping to the concatenation of its field texts (insertion
order), so document length, term frequencies, and global stats are
identical whether a doc arrived flat or fielded. The fielded views
(:func:`tokenize_positions`, :func:`tokenize_spans`) feed the v2 packed-
segment format: per-posting (field, position) occurrence lists and
per-field lengths for BM25F-style normalization, plus character spans for
snippet highlighting.

Positions index the KEPT token stream of one field (0-based, after
stopword/overlength removal) — a documented deviation from Lucene's
position-increment gaps: phrase adjacency here means "consecutive kept
tokens of the same field", and the oracle applies the identical rule.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# Lucene's classic English stopword set.
STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)

# the implicit field a plain-string document's text lives in
DEFAULT_FIELD = "body"


def field_items(text: "str | Mapping[str, str]") -> list[tuple[str, str]]:
    """A document's (field, text) pairs: a plain string is one implicit
    ``body`` field; a mapping yields its items in insertion order (that
    order defines the flattened token stream, so it is part of the
    document's identity)."""
    if isinstance(text, Mapping):
        return [(str(f), str(v)) for f, v in text.items()]
    return [(DEFAULT_FIELD, text)]


def flatten_text(text: "str | Mapping[str, str]") -> str:
    """One analyzable string for bag-of-words consumers (stats, embedders):
    field texts joined with a single space, in field order."""
    if isinstance(text, Mapping):
        return " ".join(str(v) for v in text.values())
    return text


def tokenize(text: "str | Mapping[str, str]", *,
             stopwords: frozenset[str] = STOPWORDS,
             max_token_len: int = 64) -> list[str]:
    if isinstance(text, Mapping):
        text = flatten_text(text)
    return [
        t for t in _TOKEN_RE.findall(text.lower())
        if t not in stopwords and len(t) <= max_token_len
    ]


def tokenize_positions(text: "str | Mapping[str, str]", *,
                       stopwords: frozenset[str] = STOPWORDS,
                       max_token_len: int = 64
                       ) -> list[tuple[str, str, int]]:
    """(field, token, position) for every kept token, in field order then
    position order. Positions are 0-based per field over the KEPT stream;
    duplicate terms within one field keep their distinct positions."""
    out: list[tuple[str, str, int]] = []
    for field, ftext in field_items(text):
        pos = 0
        for t in _TOKEN_RE.findall(ftext.lower()):
            if t in stopwords or len(t) > max_token_len:
                continue
            out.append((field, t, pos))
            pos += 1
    return out


def tokenize_spans(text: str, *, stopwords: frozenset[str] = STOPWORDS,
                   max_token_len: int = 64
                   ) -> list[tuple[str, int, int]]:
    """Kept tokens of ONE field's raw text with their [start, end) character
    offsets — the snippet cutter's input (offsets index the ORIGINAL text,
    so slices preserve the author's casing and punctuation)."""
    out: list[tuple[str, int, int]] = []
    for m in _TOKEN_RE.finditer(text.lower()):
        t = m.group()
        if t in stopwords or len(t) > max_token_len:
            continue
        out.append((t, m.start(), m.end()))
    return out


def field_token_counts(text: "str | Mapping[str, str]") -> dict[str, int]:
    """field -> kept-token count for one document — the per-field length the
    v2 format stores for BM25F-style normalization. Sums to ``len(tokenize
    (text))`` exactly (flattening concatenates the per-field streams)."""
    out: dict[str, int] = {}
    for field, ftext in field_items(text):
        out[field] = len(tokenize(ftext))
    return out


def token_counts(text: "str | Mapping[str, str]") -> "Counter[str]":
    """term -> tf for one document — the unit the incremental stats
    maintenance (df/avgdl updates on add/delete) works in."""
    from collections import Counter
    return Counter(tokenize(text))
