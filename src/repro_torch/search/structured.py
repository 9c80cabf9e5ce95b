"""Structured-query evaluation over a format-v2 packed index, on the device —
the port of ``repro/search/structured.py``.

The reference evaluates on the host in numpy over the partition's packed
arrays. Here the same function runs as tensor operations on the device the
partition already lives on (a :class:`StructuredState`, hung off the
searcher), so nothing of the partition is copied back per query:

* Each :class:`~repro_torch.search.query.Leaf` produces a dense per-document
  contribution vector plus a boolean match mask. A term leaf slices its
  rows of the blocked postings; a fielded leaf counts the stored occurrence
  slots of its field; a phrase leaf is one vectorized join over the stored
  occurrences (below). Every per-leaf input is partition-invariant: idf and
  avgdl (doc- and field-level) come from the generation's LIVE global stats,
  per-doc tf / lengths / occurrences from the doc's own rows.
* A document's score is the leaf contributions added in LEAF ORDER (one f32
  add per leaf), so fleet and oracle sums are bit-identical regardless of
  how docs are partitioned, and bit-identical to the reference: the leaf
  formula takes numpy's steps in numpy's order, each rounded once, with its
  parameters as 0-d float32 tensors on the device.
* Eligibility is one mask: a doc scores iff it matches ALL leaves
  (conjunctive) or ANY leaf (disjunctive); ineligible docs score +0.0.

The phrase join: every live stored occurrence of term *i* becomes one int64
key ``(doc·F + field)·S + pos`` with ``S = 2**17``, so ``pos + i`` never
carries into the field (positions clamp at ``0xFFFF``). Term 0's keys are
sorted and deduplicated (the reference works on sets; clamped positions
can repeat), filtered by field when the phrase is scoped, and a base key
survives iff ``key + i`` is among term *i*'s sorted keys for every *i* ≥ 1
(``searchsorted``). The phrase tf of a doc is the count of its surviving
base keys. Nothing loops over postings on the host.

Structured queries always evaluate on this dense path, even on fleets
configured with the ``pruned`` accumulator: field- and phrase-modified
impacts invalidate the v1 ``block_max`` ceilings. The top-k of a batch is
one call of the port's K2 (:func:`repro_torch.kernels.topk.topk`) over the
stacked ``(Q, n_docs)`` scores, whose lowest-id ties equal the reference's
stable argsort.

Also here: the facet counter (one scatter-add over the FULL eligible match
set, on the device), and the host-side string code the coordinator runs:
the facet merge and the snippet cutter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.index.builder import PackedIndex
from repro_torch.index.tokenizer import field_items, tokenize_spans
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.topk import topk
from repro_torch.search.bm25 import SearchState
from repro_torch.search.query import Leaf, Query

POS_SPAN = 1 << 17        # S: a key's position span, past the 0xFFFF clamp + i
_NO_BASE = -(1 << 62)     # dead base keys: below every live key, never + i == -1


class StructuredUnsupported(Exception):
    """Structured query against a v1 (no field/position data) index —
    admission maps this to HTTP 400."""


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclasses.dataclass
class StructuredState:
    """A format-v2 partition's structured inputs on one device: the blocked
    postings of its :class:`~repro_torch.search.bm25.SearchState` plus the
    v2 sidecar (``PackedIndex.fields``) as tensors, and the host metadata
    the evaluator reads per leaf (vocab, term extents, idf for the weights,
    field and facet names). Positions widen from uint16 to int32 at the
    copy. ``fields`` tensors are None on a v1 pack."""

    search: SearchState
    offsets: np.ndarray                  # (V+1,) host term extents
    idf: np.ndarray                      # (V,) host float32
    vocab: dict
    n_docs: int
    k1: float
    b: float
    avgdl: float
    field_names: list
    facet_names: list
    facet_values: list
    pos_slots: int = 0
    field_len: "torch.Tensor | None" = None        # (n_docs+1, F) f32
    block_nocc: "torch.Tensor | None" = None       # (NB, B) uint8
    block_occ_field: "torch.Tensor | None" = None  # (NB, B, P) uint8
    block_occ_pos: "torch.Tensor | None" = None    # (NB, B, P) int32
    facet_ids: "torch.Tensor | None" = None        # (n_docs, NF) int32

    @classmethod
    def from_packed(cls, packed: PackedIndex, search: SearchState | None = None,
                    device=None) -> "StructuredState":
        """``packed``'s structured inputs on ``search``'s device (its tensors
        are shared, not copied), or on ``device`` (None → the card)."""
        if search is None:
            search = SearchState.from_packed(packed, resolve_device(device))
        dev = search.device
        m = packed.meta
        fd = packed.fields
        st = cls(search=search, offsets=np.asarray(packed.term_offsets),
                 idf=np.asarray(packed.idf, dtype=np.float32), vocab=packed.vocab,
                 n_docs=m.n_docs, k1=m.k1, b=m.b, avgdl=m.avgdl,
                 field_names=list(fd.field_names) if fd else [],
                 facet_names=list(fd.facet_names) if fd else [],
                 facet_values=[list(v) for v in fd.facet_values] if fd else [])
        if fd is not None:
            st.pos_slots = fd.pos_slots
            st.field_len = torch.from_numpy(
                np.array(fd.field_len, dtype=np.float32)).to(dev)
            st.block_nocc = torch.from_numpy(np.array(fd.block_nocc)).to(dev)
            st.block_occ_field = torch.from_numpy(np.array(fd.block_occ_field)).to(dev)
            st.block_occ_pos = torch.from_numpy(
                np.asarray(fd.block_occ_pos).astype(np.int32)).to(dev)
            st.facet_ids = torch.from_numpy(
                np.array(fd.facet_ids, dtype=np.int32)).to(dev)
        return st

    @property
    def device(self) -> torch.device:
        return self.search.device

    def field_id(self, name: str) -> int:
        try:
            return self.field_names.index(name)
        except ValueError:
            return -1

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in (self.field_len, self.block_nocc,
                                      self.block_occ_field, self.block_occ_pos,
                                      self.facet_ids) if t is not None)


def _rows(state: StructuredState, tid: int):
    """One term's flat postings: (docs int64, tf, live, (lo, hi)); pad and
    tombstoned slots (doc ≥ n_docs or tf 0) are not live."""
    lo, hi = int(state.offsets[tid]), int(state.offsets[tid + 1])
    s = state.search
    docs = s.block_docs[lo:hi].reshape(-1).long()
    tf = s.block_tf[lo:hi].reshape(-1)
    live = (docs < state.n_docs) & (tf > 0)
    return docs, tf, live, (lo, hi)


def _per_doc(state: StructuredState, docs, live, values) -> torch.Tensor:
    """(n_docs,) vector holding each live posting's value at its doc (doc
    ids are unique within a term), 0 elsewhere; dead postings land in a
    spare slot that is dropped."""
    n = state.n_docs
    out = torch.zeros(n + 1, dtype=values.dtype, device=values.device)
    out.index_put_((torch.where(live, docs, n),), values)
    return out[:n]


def _slots_live(state: StructuredState, lo: int, hi: int, live):
    """(postings, P) mask of the stored occurrence slots of live postings."""
    nocc = state.block_nocc[lo:hi].reshape(-1)
    slots = torch.arange(state.pos_slots, device=nocc.device)
    return (slots[None, :] < nocc[:, None].long()) & live[:, None]


def _phrase_tf(state: StructuredState, tids: list[int], fid: int) -> torch.Tensor:
    """(n_docs,) float32 count of each doc's distinct stored (field, pos)
    occurrences of term 0 followed, in the same field, by term i at pos + i
    for every i ≥ 1 — restricted to field ``fid`` unless it is -2."""
    n = state.n_docs
    dev = state.device
    P, F = state.pos_slots, max(1, len(state.field_names))
    rows = [_rows(state, t) for t in tids]
    if any(hi == lo for _, _, _, (lo, hi) in rows):
        return torch.zeros(n, dtype=torch.float32, device=dev)
    keys = []
    for i, (docs, _, live, (lo, hi)) in enumerate(rows):
        occf = state.block_occ_field[lo:hi].reshape(-1, P).long()
        occp = state.block_occ_pos[lo:hi].reshape(-1, P).long()
        ok = _slots_live(state, lo, hi, live)
        if i == 0 and fid != -2:
            ok &= occf == fid
        key = (docs[:, None] * F + occf) * POS_SPAN + occp
        keys.append(torch.sort(torch.where(ok, key, _NO_BASE if i == 0 else -1)
                               .reshape(-1)).values)
    base = keys[0]
    good = base >= 0
    good[1:] &= base[1:] != base[:-1]           # a set: each key counts once
    for i, other in enumerate(keys[1:], start=1):
        probe = base + i
        at = torch.searchsorted(other, probe).clamp_(max=other.numel() - 1)
        good &= other[at] == probe
    doc = torch.where(good, base // (F * POS_SPAN), n)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, doc, torch.ones_like(doc, dtype=torch.int32))
    return counts[:n].to(torch.float32)


def _bm25_leaf(tf, dl, weight, k1, b, avgdl) -> torch.Tensor:
    """The shared f32 leaf formula (Lucene variant, no (k1+1) numerator):
    numpy's ``tf + k1 * (1 - b + b * dl / avgdl)`` and ``weight * tf /
    denom``, operation by operation in its order, each rounded once.
    ``weight``, ``k1``, ``b`` and ``avgdl`` are 0-d float32 tensors on the
    device (a CPU scalar would make the division a reciprocal multiply)."""
    norm = (1.0 - b) + (b * dl) / avgdl
    denom = tf + k1 * norm
    return (weight * tf) / denom


def _zeros(state: StructuredState):
    n, dev = state.n_docs, state.device
    return (torch.zeros(n, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev))


def leaf_contribution(state: StructuredState, leaf: Leaf, *,
                      field_avgdl: dict[str, float]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's dense (contrib f32 (n_docs,), match bool (n_docs,)) on the
    state's device. ``field_avgdl`` maps field name -> live per-field
    average length (the generation's global stats)."""
    n = state.n_docs
    vocab, idf = state.vocab, state.idf
    if leaf.kind == "term":
        tid = vocab.get(leaf.terms[0], -1)
        if tid < 0:
            return _zeros(state)
        weight = _f32(leaf.boost) * _f32(leaf.qtf) * _f32(idf[tid])
        docs, tf, live, (lo, hi) = _rows(state, tid)
        if leaf.field is None:
            tf_d = _per_doc(state, docs, live, tf.to(torch.float32))
            dl, avg = state.search.doc_len[:n], state.avgdl
        else:
            if state.field_len is None:
                raise StructuredUnsupported("fielded term on a v1 index")
            fid = state.field_id(leaf.field)
            if fid < 0:
                return _zeros(state)
            P = state.pos_slots
            occf = state.block_occ_field[lo:hi].reshape(-1, P)
            tf_f = ((occf == fid) & _slots_live(state, lo, hi, live)).sum(dim=1)
            tf_d = _per_doc(state, docs, live, tf_f.to(torch.float32))
            dl, avg = state.field_len[:n, fid], field_avgdl.get(leaf.field, 1.0)
    else:
        # phrase: adjacency over stored (field, position) occurrences —
        # consecutive kept tokens of the SAME field, field fixed when scoped
        if state.field_len is None:
            raise StructuredUnsupported("phrase on a v1 index")
        fid = -2
        if leaf.field is not None:
            fid = state.field_id(leaf.field)
            if fid < 0:
                return _zeros(state)
        tids = [vocab.get(t, -1) for t in leaf.terms]
        if any(t < 0 for t in tids):
            return _zeros(state)
        weight = _f32(leaf.boost) * _f32(
            np.sum(idf[np.asarray(tids)], dtype=np.float32))
        tf_d = _phrase_tf(state, tids, fid)
        if leaf.field is None:
            dl, avg = state.search.doc_len[:n], state.avgdl
        else:
            dl, avg = state.field_len[:n, fid], field_avgdl.get(leaf.field, 1.0)
    # the leaf's four scalars in one copy to the device
    w, k1, b, a = torch.from_numpy(np.array(
        [weight, state.k1, state.b, avg], dtype=np.float32)).to(state.device)
    match = tf_d > 0
    contrib = _bm25_leaf(tf_d, dl, w, k1, b, a)
    return torch.where(match, contrib, 0.0), match


def leaf_kind(leaf: Leaf) -> str:
    """``term``, ``field_term``, ``phrase`` or ``field_phrase``: the name of
    a leaf's profiler range (``structured.<kind>``)."""
    return ("field_" if leaf.field is not None else "") + leaf.kind


def evaluate_structured(state: StructuredState, query: Query, *,
                        field_avgdl: dict[str, float]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores f32 (n_docs,), eligible bool (n_docs,)) for one query, on
    the state's device.

    Leaf contributions accumulate in leaf order (bit-reproducible f32
    sums); ineligible docs — failing the AND/OR predicate — score +0.0.
    Tombstoned docs carry tf = 0 everywhere in the fused pack, so they
    match no leaf and drop out with no special casing."""
    acc = torch.zeros(state.n_docs, dtype=torch.float32, device=state.device)
    nmatch = torch.zeros(state.n_docs, dtype=torch.int32, device=state.device)
    for leaf in query.leaves:
        with torch.profiler.record_function(f"structured.{leaf_kind(leaf)}"):
            contrib, match = leaf_contribution(state, leaf, field_avgdl=field_avgdl)
            acc = acc + contrib
            nmatch += match
    if query.conjunctive:
        eligible = nmatch == len(query.leaves) if query.leaves \
            else torch.zeros_like(nmatch, dtype=torch.bool)
    else:
        eligible = nmatch > 0
    return torch.where(eligible, acc, 0.0), eligible


def structured_topk(scores: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (n_docs,) or stacked (Q, n_docs) scores with ``lax.top_k``
    tie-breaks (descending value, ascending index among equals) — one K2
    call on the card, its twin on the CPU — padded to k with (0.0, n_docs)
    like the dense path's contract."""
    single = scores.dim() == 1
    s = scores.unsqueeze(0) if single else scores
    Q, n = s.shape
    kk = min(k, n)
    if kk > 0:
        vals, ids = topk(s, kk)
    else:
        vals = s.new_zeros(Q, 0)
        ids = torch.zeros(Q, 0, dtype=torch.int32, device=s.device)
    if kk < k:
        vals = torch.cat([vals, vals.new_zeros(Q, k - kk)], dim=1)
        ids = torch.cat([ids, ids.new_full((Q, k - kk), n)], dim=1)
    return (vals[0], ids[0]) if single else (vals, ids)


def facet_counts(state: StructuredState, eligible: torch.Tensor,
                 facet_field: str) -> "dict[str, int] | list[dict[str, int]]":
    """value -> doc count over the FULL eligible set (not the top-k) for one
    declared facet field; absent docs (facet id -1) don't count. One
    scatter-add on the device for (n_docs,) eligibility, or for a stacked
    (Q, n_docs) batch (then a list of dicts, one per query)."""
    if state.facet_ids is None:
        raise StructuredUnsupported("facets on a v1 index")
    try:
        fi = state.facet_names.index(facet_field)
    except ValueError:
        raise StructuredUnsupported(
            f"facet field {facet_field!r} not declared "
            f"(declared: {state.facet_names})") from None
    values = state.facet_values[fi]
    V = len(values)
    single = eligible.dim() == 1
    el = eligible.unsqueeze(0) if single else eligible
    Q = el.shape[0]
    col = state.facet_ids[:, fi].long()
    slot = torch.where(el & (col >= 0), col, V)          # (Q, n_docs)
    slot = slot + (V + 1) * torch.arange(Q, device=slot.device)[:, None]
    counts = torch.zeros(Q * (V + 1), dtype=torch.int64, device=slot.device)
    counts.scatter_add_(0, slot.reshape(-1), torch.ones_like(slot.reshape(-1)))
    counts = counts.reshape(Q, V + 1)[:, :V].cpu().numpy()
    out = [{values[v]: int(c) for v, c in enumerate(row) if c > 0} for row in counts]
    return out[0] if single else out


def merge_facet_counts(parts: list[dict[str, int]]) -> dict[str, int]:
    """String-keyed summation across partitions (facet value ids are
    segment-local; strings are the global join key), deterministically
    ordered: count desc, then value asc."""
    total: dict[str, int] = {}
    for p in parts:
        for v, c in p.items():
            total[v] = total.get(v, 0) + c
    return dict(sorted(total.items(), key=lambda kv: (-kv[1], kv[0])))


# -- snippets -------------------------------------------------------------------


def make_snippet(text, terms, *, width: int = 40, max_fragments: int = 4,
                 em: tuple[str, str] = ("<em>", "</em>")) -> str:
    """Highlighted fragments of one document covering EVERY matched term.

    Greedy anchor selection: walking fields in document order, each query
    term present in the doc anchors one fragment at its first occurrence;
    overlapping windows merge. Within a chosen window every query-term
    occurrence is wrapped in ``em`` tags, so snippets read naturally while
    the coverage guarantee stays per-term. Slices index the ORIGINAL text
    (casing and punctuation preserved); clipped edges get an ellipsis.

    Falls back to the head of the first field when nothing matches.
    """
    terms = set(terms)
    fields = field_items(text)
    # per field: all query-term token spans
    field_spans = [[(tok, s, e) for tok, s, e in tokenize_spans(ftext)
                    if tok in terms] for _, ftext in fields]
    covered: set[str] = set()
    anchors: list[tuple[int, int, int]] = []      # (field idx, start, end)
    for fi, spans in enumerate(field_spans):
        for tok, s, e in spans:
            if tok not in covered:
                covered.add(tok)
                anchors.append((fi, s, e))
    if not anchors:
        head = fields[0][1] if fields else ""
        frag = head[:2 * width]
        return frag + ("…" if len(head) > len(frag) else "")
    anchors = anchors[:max_fragments]
    # windows per field, merged when overlapping
    windows: dict[int, list[tuple[int, int]]] = {}
    for fi, s, e in anchors:
        ftext = fields[fi][1]
        windows.setdefault(fi, []).append(
            (max(0, s - width), min(len(ftext), e + width)))
    frags: list[str] = []
    for fi in sorted(windows):
        ftext = fields[fi][1]
        merged: list[list[int]] = []
        for lo, hi in sorted(windows[fi]):
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        for lo, hi in merged:
            piece = ftext[lo:hi]
            # wrap every query-term occurrence inside the window
            marks = [(s - lo, e - lo) for tok, s, e in field_spans[fi]
                     if s >= lo and e <= hi]
            for s, e in sorted(marks, reverse=True):
                piece = piece[:s] + em[0] + piece[s:e] + em[1] + piece[e:]
            pre = "…" if lo > 0 else ""
            post = "…" if hi < len(ftext) else ""
            frags.append(pre + piece + post)
    return " ".join(frags)
