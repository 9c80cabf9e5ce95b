"""Structured query AST + parser — the v2 format's query language.

The grammar is deliberately FLAT (no parentheses, no NOT): a query is a
sequence of clauses separated by whitespace and/or the bare keywords
``AND`` / ``OR``. Each clause is one of::

    term                  hello
    field:term            title:hello
    "quoted phrase"       "information retrieval"
    field:"phrase"        title:"serverless lucene"

and any clause may carry a trailing boost: ``title:hello^2.5``. The
presence of ANY explicit ``AND`` makes the whole query conjunctive (every
leaf must match); otherwise leaves are disjunctive (Lucene's default
SHOULD semantics). That single switch keeps evaluation a per-leaf
scatter-add plus one eligibility mask — no boolean tree walk on the
scoring path, which is what lets the fleet and the oracle share one
bit-exact accumulator.

Clause text is run through the SAME analyzer as indexing
(:func:`repro_torch.index.tokenizer.tokenize`), so a clause may expand to
several term leaves (``foo-bar`` → ``foo``, ``bar``) or vanish entirely
(a stopword). Exact-duplicate term leaves merge with ``qtf`` summed — the
structured twin of the bag-of-words query-term-frequency weighting, so a
structured query that is plain bag-of-words scores exactly like the
legacy ``q`` path.

The AST is JSON-able (:meth:`Query.to_payload` /
:func:`query_from_payload`): the gateway parses ONCE at admission and the
scatter fan-out ships plain dicts, never re-parsing on workers.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.index.tokenizer import tokenize


class QueryParseError(ValueError):
    """Malformed structured query — admission maps this to HTTP 400."""


# field prefix, quoted phrase or bare word, optional ^boost
_CLAUSE_RE = re.compile(
    r'(?:(?P<field>[A-Za-z0-9_]+):)?'
    r'(?:"(?P<phrase>[^"]*)"|(?P<word>[^\s"^]+))'
    r'(?:\^(?P<boost>[^\s"]+))?')


@dataclass
class Leaf:
    """One scoring unit: a (possibly field-scoped) term or phrase.

    ``terms`` holds one analyzed token for kind ``term``, the in-order
    token sequence for kind ``phrase``. ``field`` of None means
    unscoped — a term leaf then scores with the doc-level BM25 formula
    (bit-identical to the legacy path); a field-scoped term leaf scores
    BM25F-style off the per-field length. ``qtf`` counts merged duplicate
    term leaves (phrases never merge)."""

    kind: str                     # "term" | "phrase"
    terms: list[str]
    field: "str | None" = None
    boost: float = 1.0
    qtf: int = 1

    def to_payload(self) -> dict:
        return {"kind": self.kind, "terms": list(self.terms),
                "field": self.field, "boost": self.boost, "qtf": self.qtf}


@dataclass
class Query:
    """A parsed structured query: flat leaves + one conjunction bit."""

    leaves: list[Leaf] = field(default_factory=list)
    conjunctive: bool = False

    @property
    def terms(self) -> list[str]:
        """Every analyzed term the query touches, deduped, first-seen
        order — the hydration set AND the snippet matcher's term list."""
        seen: dict[str, None] = {}
        for lf in self.leaves:
            for t in lf.terms:
                seen.setdefault(t)
        return list(seen)

    def to_payload(self) -> dict:
        return {"conj": self.conjunctive,
                "leaves": [lf.to_payload() for lf in self.leaves]}


def leaf_from_payload(d: dict) -> Leaf:
    return Leaf(kind=str(d["kind"]), terms=[str(t) for t in d["terms"]],
                field=d.get("field"), boost=float(d.get("boost", 1.0)),
                qtf=int(d.get("qtf", 1)))


def query_from_payload(d: dict) -> Query:
    return Query(leaves=[leaf_from_payload(x) for x in d.get("leaves", ())],
                 conjunctive=bool(d.get("conj", False)))


def _parse_boost(raw: "str | None", clause: str) -> float:
    if raw is None:
        return 1.0
    try:
        b = float(raw)
    except ValueError:
        raise QueryParseError(f"bad boost in clause {clause!r}") from None
    if not (b > 0.0):
        raise QueryParseError(f"boost must be > 0 in clause {clause!r}")
    return b


def parse_query(text: str) -> Query:
    """Parse the DSL into a :class:`Query`.

    Raises :class:`QueryParseError` on syntax errors (unbalanced quote,
    bad boost, dangling operator). Clauses whose text analyzes to nothing
    (stopwords, punctuation) are DROPPED, mirroring the analyzer's
    behaviour on the legacy path — a query may legitimately parse to zero
    leaves and simply match nothing.
    """
    if not isinstance(text, str):
        raise QueryParseError("structured query must be a string")
    if text.count('"') % 2:
        raise QueryParseError(f"unbalanced quote in query {text!r}")
    leaves: list[Leaf] = []
    merged: dict[tuple, int] = {}     # term-leaf key -> index into leaves
    conjunctive = False
    saw_clause = False
    pending_op = False
    for m in _CLAUSE_RE.finditer(text):
        word = m.group("word")
        if word in ("AND", "OR") and m.group("field") is None \
                and m.group("boost") is None:
            if not saw_clause:
                raise QueryParseError(f"dangling operator in query {text!r}")
            conjunctive |= word == "AND"
            pending_op = True
            continue
        pending_op = False
        saw_clause = True
        fld = m.group("field")
        boost = _parse_boost(m.group("boost"), m.group(0))
        phrase = m.group("phrase")
        if phrase is not None:
            toks = tokenize(phrase)
            if not toks:
                continue
            if len(toks) == 1:        # one-token "phrase" is just a term
                word, phrase = toks[0], None
            else:
                leaves.append(Leaf("phrase", toks, field=fld, boost=boost))
                continue
        for t in tokenize(word):
            key = (fld, t, boost)
            if key in merged:
                leaves[merged[key]].qtf += 1
            else:
                merged[key] = len(leaves)
                leaves.append(Leaf("term", [t], field=fld, boost=boost))
    if pending_op:
        raise QueryParseError(f"dangling operator in query {text!r}")
    return Query(leaves=leaves, conjunctive=conjunctive)
