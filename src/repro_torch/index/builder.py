"""Inverted-index builder → packed, blocked, impact-ordered arrays.

Lucene stores postings as compressed, doc-ordered skip-list streams —
pointer-chasing that the TPU's vector units cannot traverse. The TPU-native
equivalent (DESIGN.md §2) packs each term's postings into fixed-width blocks:

    term_offsets : (V+1,)      int32   block range of term t = [off[t], off[t+1])
    block_docs   : (NB, B)     int32   doc ids, PAD = n_docs (dump slot)
    block_tf     : (NB, B)     uint8   term frequency, clamped to 255
    block_max    : (NB,)       float32 max BM25 impact within the block
    doc_len      : (n_docs+1,) float32 document length (dump slot appended)
    idf          : (V,)        float32 BM25 idf per term

Blocks within a term are sorted by descending ``block_max`` (impact ordering,
Lin & Trotman '17 — cited by the paper): truncating evaluation to the first M
blocks of each term is the classic score-at-a-time approximation, and gives
the fixed shapes jit needs. B = 128 matches the TPU lane width.

BM25 (Lucene's variant, k1=0.9, b=0.4 Anserini defaults):

    idf(t)   = ln(1 + (N - df + 0.5)/(df + 0.5))
    score    = idf(t) * tf / (tf + k1 * (1 - b + b * dl/avgdl))

(Lucene folds the (k1+1) numerator constant away since it is rank-neutral;
we follow Lucene.)
"""

from __future__ import annotations

import dataclasses
import io
import math
from typing import Iterable

import numpy as np

from repro_torch.core import jsonutil as orjson   # orjson when installed

from repro_torch.core.directory import Directory, DirectoryError, RamDirectory
from repro_torch.index.tokenizer import (DEFAULT_FIELD, field_items, tokenize,
                                   tokenize_positions)

BLOCK = 128          # lane width
K1_DEFAULT = 0.9     # Anserini defaults
B_DEFAULT = 0.4

# Format v2 (structured queries): per-posting STORED OCCURRENCES. Each
# posting keeps its first POS_SLOTS (field, position) occurrences in
# tokenize_positions order — a fixed-pitch truncation (like the uint8
# tf-255 clamp) that keeps payload rows range-readable. Fielded tf and
# phrase matching are computed from the STORED occurrences, and the
# structured oracle applies the identical rule, so fleet/oracle parity is
# exact by construction even where the cap bites.
POS_SLOTS = 8
_POS_MAX = 0xFFFF    # positions clamp to uint16 (oracle-identical rule)


@dataclasses.dataclass
class IndexMeta:
    n_docs: int
    n_terms: int
    n_blocks: int
    block: int
    avgdl: float
    k1: float
    b: float
    doc_ids: list[str]          # external ids, position = internal id

    def to_json(self) -> bytes:
        return orjson.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, data: bytes) -> "IndexMeta":
        return cls(**orjson.loads(data))


@dataclasses.dataclass
class FieldData:
    """Format-v2 sidecar: per-document field data + per-posting stored
    occurrences + declared facet fields.

    The block_* arrays are row-aligned with the segment's posting blocks
    (same (NB, B) grid, same impact ordering), so the lazy cold path
    hydrates them with the SAME coalesced payload-row ranges it already
    pulls for docs/tf. Slots past ``block_nocc`` are zero."""

    field_names: list[str]          # field id -> name, first-seen order
    pos_slots: int                  # P: stored occurrences per posting
    field_len: np.ndarray           # (n_docs+1, F) float32 kept-token lengths
    block_nocc: np.ndarray          # (NB, B) uint8 stored-occurrence count
    block_occ_field: np.ndarray     # (NB, B, P) uint8 field id per occurrence
    block_occ_pos: np.ndarray       # (NB, B, P) uint16 position per occurrence
    facet_names: list[str]          # declared categorical facet fields
    facet_values: list[list[str]]   # per facet field: value id -> string
    facet_ids: np.ndarray           # (n_docs, NF) int32, -1 = absent

    def field_id(self, name: str) -> int:
        try:
            return self.field_names.index(name)
        except ValueError:
            return -1

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (
            self.field_len, self.block_nocc, self.block_occ_field,
            self.block_occ_pos, self.facet_ids))


@dataclasses.dataclass
class PackedIndex:
    """The hydrated, array-form index (numpy arrays)."""

    meta: IndexMeta
    vocab: dict[str, int]
    term_offsets: np.ndarray    # (V+1,) int32
    block_docs: np.ndarray      # (NB, B) int32
    block_tf: np.ndarray        # (NB, B) uint8
    block_max: np.ndarray       # (NB,) float32
    doc_len: np.ndarray         # (n_docs+1,) float32
    idf: np.ndarray             # (V,) float32
    fields: "FieldData | None" = None   # format v2 only; None = v1

    def term_id(self, term: str) -> int:
        return self.vocab.get(term, -1)

    @property
    def nbytes(self) -> int:
        n = sum(a.nbytes for a in (
            self.term_offsets, self.block_docs, self.block_tf,
            self.block_max, self.doc_len, self.idf))
        if self.fields is not None:
            n += self.fields.nbytes
        return n


def compute_global_stats(docs: Iterable[tuple[str, str]], *,
                         fields: bool = False) -> dict:
    """Corpus-wide BM25 statistics for document-partitioned indexing.

    Distributed IR subtlety the paper's §3 glosses over: each partition's
    index must score with GLOBAL idf/avgdl, or the merged ranking diverges
    from a single-index build. The offline batch indexer computes these
    once and passes them to every partition's writer.

    ``fields=True`` (structured fleets only — the stats blob's byte size
    feeds hydration pricing, so v1 fleets must not grow it) additionally
    records per-field totals under ``stats["fields"]``:
    ``{field: {"total": kept tokens, "docs": docs carrying the field}}``,
    the inputs to per-field avgdl for BM25F-style normalization.
    """
    from collections import Counter
    df: Counter = Counter()
    total_len = 0
    n_docs = 0
    fstats: dict[str, dict] = {}
    for _, text in docs:
        toks = tokenize(text)
        total_len += len(toks)
        n_docs += 1
        df.update(set(toks))
        if fields:
            for field, ftext in field_items(text):
                e = fstats.setdefault(field, {"total": 0, "docs": 0})
                e["total"] += len(tokenize(ftext))
                e["docs"] += 1
    out = {"n_docs": n_docs,
           "avgdl": total_len / max(1, n_docs),
           "df": dict(df)}
    if fields:
        out["fields"] = fstats
    return out


def field_avgdl(stats: dict, field: str) -> float:
    """Live per-field average length from ``stats["fields"]`` (1.0 for a
    field the live corpus does not carry — any fielded tf there is 0, so
    the denominator never matters)."""
    e = stats.get("fields", {}).get(field)
    if not e or e["docs"] <= 0 or e["total"] <= 0:
        return 1.0
    return e["total"] / e["docs"]


def global_vocab(stats: dict) -> dict[str, int]:
    """Deterministic corpus-global term→id map from compute_global_stats.

    This ordering IS the cross-path term-id contract: the mesh state's
    shared ``term_offsets``/``idf`` indexing and the fleet handlers'
    idf-ranked ``max_terms`` truncation both assume every partition was
    packed against exactly this map."""
    return {t: i for i, t in enumerate(sorted(stats["df"]))}


def extend_vocab(vocab: dict[str, int], terms: Iterable[str]) -> dict[str, int]:
    """Append-only vocab growth for incremental indexing.

    Existing term ids NEVER move (already-published segments index
    ``term_offsets``/``idf`` by them); genuinely new terms get fresh ids
    appended in sorted order, deterministically. Segments packed against a
    shorter vocab stay valid — their ``term_offsets`` is edge-padded at
    hydration (new terms have zero blocks there)."""
    out = dict(vocab)
    for t in sorted(set(terms) - out.keys()):
        out[t] = len(out)
    return out


def update_stats(stats: dict, text: str, *, sign: int = 1,
                 counts: "dict | None" = None) -> dict:
    """Incrementally fold one document into (sign=+1) or out of (sign=-1)
    ``compute_global_stats``-shaped stats, in place. The NRT writer calls
    this per add/delete so commit-time stats are O(changed docs), while
    staying exactly equal to a from-scratch ``compute_global_stats`` over
    the live corpus (the delta-vs-rebuild parity requirement). Pass
    ``counts`` (``token_counts(text)``) when the caller already tokenized
    the doc for other bookkeeping — the text is not re-tokenized."""
    if counts is None:
        from repro_torch.index.tokenizer import token_counts
        counts = token_counts(text)
    n = stats["n_docs"] + sign
    total_len = stats["avgdl"] * max(1, stats["n_docs"]) \
        if stats["n_docs"] else 0.0
    # avgdl is stored, not the raw total — keep an exact integer token total
    # alongside so repeated +/- cannot accumulate float drift
    total = stats.setdefault("_total_len", round(total_len))
    total += sign * sum(counts.values())
    stats["_total_len"] = total
    df = stats["df"]
    for t in counts:
        new = df.get(t, 0) + sign
        if new > 0:
            df[t] = new
        else:
            df.pop(t, None)
    stats["n_docs"] = n
    stats["avgdl"] = total / max(1, n)
    # structured fleets (stats carry a "fields" entry) maintain per-field
    # totals the same incremental way, staying exactly equal to a
    # from-scratch compute_global_stats(fields=True) over the live corpus
    if "fields" in stats:
        fs = stats["fields"]
        for field, ftext in field_items(text):
            e = fs.setdefault(field, {"total": 0, "docs": 0})
            e["total"] += sign * len(tokenize(ftext))
            e["docs"] += sign
            if e["docs"] <= 0:
                fs.pop(field, None)
    return stats


class IndexWriter:
    """Accumulates documents, then packs. Offline batch side of paper §3.

    ``global_stats`` (from :func:`compute_global_stats`) overrides the
    local corpus statistics — required when this writer packs one
    partition of a document-partitioned deployment.

    ``vocab`` fixes the term-id mapping (global term → id). Partitioned
    deployments that evaluate queries against a SHARED id space (the
    mesh-level path) pass the corpus-wide vocab so every partition's
    ``term_offsets`` is indexed identically; terms absent from this
    partition simply get zero blocks. With a fixed vocab an empty
    partition packs to a valid zero-doc index (scatter-gather over a
    corpus that does not divide evenly).

    ``structured=True`` packs format v2: per-posting stored occurrences
    (first ``pos_slots`` per posting), per-field kept-token lengths, and
    per-doc values for each declared ``facet_fields`` entry (the raw
    field text is the facet value). OFF by default — a v1 pack's bytes
    are unchanged by this feature's existence.
    """

    def __init__(self, *, k1: float = K1_DEFAULT, b: float = B_DEFAULT,
                 block: int = BLOCK, global_stats: dict | None = None,
                 vocab: dict[str, int] | None = None,
                 structured: bool = False,
                 facet_fields: "tuple[str, ...] | list[str]" = (),
                 pos_slots: int = POS_SLOTS) -> None:
        self.k1 = k1
        self.b = b
        self.block = block
        self.global_stats = global_stats
        self.vocab = vocab
        self._postings: dict[str, dict[int, int]] = {}   # term -> {doc: tf}
        self._doc_ids: list[str] = []
        self._doc_len: list[int] = []
        self.structured = structured or bool(facet_fields)
        self.facet_fields = list(facet_fields)
        self.pos_slots = pos_slots
        # v2 bookkeeping (empty unless structured)
        self._field_names: list[str] = []
        self._field_ids: dict[str, int] = {}
        self._field_len_rows: list[dict[int, int]] = []  # doc -> {fid: len}
        self._occ: dict[str, dict[int, list]] = {}  # term -> doc -> [(f, p)]
        self._facet_maps: list[dict[str, int]] = [
            {} for _ in self.facet_fields]
        self._facet_rows: list[list[int]] = []

    def _field_id(self, name: str) -> int:
        fid = self._field_ids.get(name)
        if fid is None:
            fid = self._field_ids[name] = len(self._field_names)
            self._field_names.append(name)
        return fid

    def add(self, ext_id: str, text: "str | dict") -> int:
        doc = len(self._doc_ids)
        self._doc_ids.append(ext_id)
        toks = tokenize(text)
        self._doc_len.append(len(toks))
        for t in toks:
            self._postings.setdefault(t, {})
            self._postings[t][doc] = self._postings[t].get(doc, 0) + 1
        if self.structured:
            # fielded views: per-field kept lengths + (field, position)
            # occurrence lists per posting, in tokenize_positions order
            # (field insertion order, then kept-stream position) — the
            # order the pos_slots truncation is defined over
            flen: dict[int, int] = {}
            for field, _ in field_items(text):
                flen.setdefault(self._field_id(field), 0)
            for field, tok, pos in tokenize_positions(text):
                fid = self._field_id(field)
                flen[fid] = flen.get(fid, 0) + 1
                self._occ.setdefault(tok, {}).setdefault(doc, []).append(
                    (fid, min(pos, _POS_MAX)))
            self._field_len_rows.append(flen)
            fmap = dict(field_items(text))
            row = []
            for fi, fname in enumerate(self.facet_fields):
                val = fmap.get(fname)
                if val is None or val == "":
                    row.append(-1)
                else:
                    vmap = self._facet_maps[fi]
                    row.append(vmap.setdefault(str(val), len(vmap)))
            self._facet_rows.append(row)
        return doc

    def add_many(self, docs: Iterable[tuple[str, str]]) -> None:
        for ext_id, text in docs:
            self.add(ext_id, text)

    @classmethod
    def delta(cls, docs: Iterable[tuple[str, str]], base_stats: dict, *,
              vocab: dict[str, int], k1: float = K1_DEFAULT,
              b: float = B_DEFAULT, block: int = BLOCK,
              structured: bool = False,
              facet_fields: "tuple[str, ...] | list[str]" = (),
              pos_slots: int = POS_SLOTS) -> PackedIndex:
        """Pack ONLY ``docs`` as a delta segment against the frozen global
        ``vocab`` and ``base_stats`` — the NRT increment: a commit uploads
        just these blocks, never touching the published base segment.

        Delta doc ids are segment-local (0..len(docs)); the serving side
        shifts them when it combines base + deltas
        (:func:`combine_segments`). The frozen stats only shape the
        IMPACT ORDERING baked into ``block_max`` — idf/avgdl applied at
        query time come from the generation manifest's live stats, which
        is what keeps delta-served scores equal to a full rebuild's.
        Extend the vocab first (:func:`extend_vocab`) when the new docs
        carry unseen terms; ``pack`` refuses stale vocabs."""
        w = cls(k1=k1, b=b, block=block, global_stats=base_stats, vocab=vocab,
                structured=structured, facet_fields=facet_fields,
                pos_slots=pos_slots)
        w.add_many(docs)
        return w.pack()

    # -- packing ----------------------------------------------------------------

    def pack(self) -> PackedIndex:
        n_docs = len(self._doc_ids)
        if self.vocab is not None:
            vocab = dict(self.vocab)
            uncovered = [t for t in self._postings if t not in vocab]
            if uncovered:        # a stale vocab would silently lose postings
                raise ValueError(
                    f"{len(uncovered)} added term(s) missing from the fixed "
                    f"vocab (e.g. {sorted(uncovered)[:5]}) — rebuild the "
                    "global vocab before packing")
            terms = [None] * len(vocab)
            for t, i in vocab.items():
                terms[i] = t
        else:
            if n_docs == 0:
                raise ValueError("empty index")
            terms = sorted(self._postings)
            vocab = {t: i for i, t in enumerate(terms)}
        V = len(terms)
        avgdl = float(np.mean(self._doc_len)) if self._doc_len else 0.0
        gs = self.global_stats
        stat_docs = gs["n_docs"] if gs else n_docs
        if gs:
            avgdl = gs["avgdl"]
        doc_len = np.asarray(self._doc_len + [1.0], dtype=np.float32)  # +dump

        idf = np.zeros(V, dtype=np.float32)
        blocks_docs: list[np.ndarray] = []
        blocks_tf: list[np.ndarray] = []
        blocks_max: list[float] = []
        offsets = np.zeros(V + 1, dtype=np.int32)
        P = self.pos_slots
        blocks_nocc: list[np.ndarray] = []
        blocks_occf: list[np.ndarray] = []
        blocks_occp: list[np.ndarray] = []

        B = self.block
        k1, b = self.k1, self.b
        for ti, term in enumerate(terms):
            plist = self._postings.get(term) or {}   # {} when the term is
            local_df = len(plist)                    # global-vocab-only here
            df = gs["df"].get(term, local_df) if gs else local_df  # global
            idf[ti] = math.log(1.0 + (stat_docs - df + 0.5) / (df + 0.5))
            docs = np.fromiter(plist.keys(), dtype=np.int32, count=local_df)
            tfs = np.fromiter(plist.values(), dtype=np.int64, count=local_df)
            # per-posting impact for ordering
            dl = doc_len[docs]
            imp = idf[ti] * tfs / (tfs + k1 * (1 - b + b * dl / avgdl))
            # impact-sort postings descending, then cut into blocks: the
            # first blocks of each term carry its highest-scoring docs.
            order = np.argsort(-imp, kind="stable")
            docs, tfs, imp = docs[order], tfs[order], imp[order]
            n_blk = -(-local_df // B)
            pad = n_blk * B - local_df
            if self.structured:
                # stored occurrences, aligned with the impact-sorted
                # postings then padded like docs/tf
                occ_map = self._occ.get(term) or {}
                nocc = np.zeros(n_blk * B, np.uint8)
                occf = np.zeros((n_blk * B, P), np.uint8)
                occp = np.zeros((n_blk * B, P), np.uint16)
                for i, d in enumerate(docs[:local_df]):
                    lst = occ_map.get(int(d), ())[:P]
                    nocc[i] = len(lst)
                    for s, (fid, pos) in enumerate(lst):
                        occf[i, s] = fid
                        occp[i, s] = pos
                for j in range(n_blk):
                    sl = slice(j * B, (j + 1) * B)
                    blocks_nocc.append(nocc[sl])
                    blocks_occf.append(occf[sl])
                    blocks_occp.append(occp[sl])
            docs = np.concatenate([docs, np.full(pad, n_docs, np.int32)])
            tfs = np.concatenate([np.minimum(tfs, 255).astype(np.uint8),
                                  np.zeros(pad, np.uint8)])
            imp = np.concatenate([imp, np.zeros(pad)])
            for j in range(n_blk):
                sl = slice(j * B, (j + 1) * B)
                blocks_docs.append(docs[sl])
                blocks_tf.append(tfs[sl])
                blocks_max.append(float(imp[sl].max(initial=0.0)))
            offsets[ti + 1] = offsets[ti] + n_blk

        NB = len(blocks_docs)
        meta = IndexMeta(
            n_docs=n_docs, n_terms=V, n_blocks=NB, block=B, avgdl=avgdl,
            k1=k1, b=b, doc_ids=self._doc_ids,
        )
        fields = None
        if self.structured:
            F = len(self._field_names)
            field_len = np.zeros((n_docs + 1, F), np.float32)
            for d, flen in enumerate(self._field_len_rows):
                for fid, n in flen.items():
                    field_len[d, fid] = n
            field_len[n_docs] = 1.0                     # dump slot
            NF = len(self.facet_fields)
            facet_ids = (np.asarray(self._facet_rows, np.int32)
                         if self._facet_rows
                         else np.zeros((0, NF), np.int32)).reshape(n_docs, NF)
            facet_values = []
            for vmap in self._facet_maps:
                vals = [None] * len(vmap)
                for v, i in vmap.items():
                    vals[i] = v
                facet_values.append(vals)
            fields = FieldData(
                field_names=list(self._field_names), pos_slots=P,
                field_len=field_len,
                block_nocc=(np.stack(blocks_nocc) if NB
                            else np.zeros((0, B), np.uint8)),
                block_occ_field=(np.stack(blocks_occf) if NB
                                 else np.zeros((0, B, P), np.uint8)),
                block_occ_pos=(np.stack(blocks_occp) if NB
                               else np.zeros((0, B, P), np.uint16)),
                facet_names=list(self.facet_fields),
                facet_values=facet_values, facet_ids=facet_ids)
        return PackedIndex(
            meta=meta,
            vocab=vocab,
            term_offsets=offsets,
            block_docs=np.stack(blocks_docs) if NB else np.zeros((0, B), np.int32),
            block_tf=np.stack(blocks_tf) if NB else np.zeros((0, B), np.uint8),
            block_max=np.asarray(blocks_max, dtype=np.float32),
            doc_len=doc_len,
            idf=idf,
            fields=fields,
        )


# -- segment (de)serialization through the Directory seam ------------------------


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _npy_load(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


SEGMENT_FILES = ("term_offsets", "block_docs", "block_tf", "block_max",
                 "doc_len", "idf")

# Lazy-hydration layout (PR 7, Airphant-style): every segment additionally
# carries a compact HEADER (superindex.bin — meta, vocab, term→block extents
# via term_offsets, the block_max table, doc lengths, idf) serialized ahead
# of an interleaved BLOCK PAYLOAD (blocks.bin — row i is block i's B int32
# doc ids followed by its B uint8 tfs). A cold instance reads the header in
# ONE ranged GET, then pulls exactly the payload row ranges the query's
# terms name (term t's rows are [off[t], off[t+1]) — contiguous by
# construction), instead of streaming the whole segment. The eager *.npy
# files stay byte-identical so full hydration (read_segment) is unchanged.
SUPERINDEX_FILE = "superindex.bin"
PAYLOAD_FILE = "blocks.bin"
_SUPERINDEX_MAGIC = b"SUPX"      # format v1: 6 sections, 5 B/lane payload
_SUPERINDEX_MAGIC_V2 = b"SUP2"   # format v2: + fields/positions/facets

# v2 superindex extra sections (after the 6 v1 sections): fields header
# json, field_len npy, facet_ids npy
_V2_SECTIONS = 3
FIELDS_FILE = "fields.json"
FIELD_NPY_FILES = ("field_len", "block_nocc", "block_occ_field",
                   "block_occ_pos", "facet_ids")


def payload_row_bytes(block: int, pos_slots: int = 0) -> int:
    """Bytes per payload row: B int32 doc ids + B uint8 tfs, interleaved so
    one coalesced range read covers both arrays of a term's blocks. A v2
    row (``pos_slots`` > 0) appends B uint8 occurrence counts, B×P uint8
    field ids and B×P uint16 positions — same row pitch discipline, so
    the ranged-GET machinery needs only the wider stride."""
    base = block * 4 + block
    if pos_slots:
        base += block * (1 + 3 * pos_slots)
    return base


def _fields_header(fd: FieldData) -> dict:
    return {"field_names": fd.field_names, "pos_slots": fd.pos_slots,
            "facet_names": fd.facet_names, "facet_values": fd.facet_values}


def pack_superindex(index: PackedIndex) -> bytes:
    """The segment header: everything a query-sufficient partial view needs
    EXCEPT the posting blocks themselves, framed as length-prefixed
    sections (meta json, vocab json, then term_offsets / block_max /
    doc_len / idf as npy). A v2 segment (``index.fields``) appends the
    fields header json, field_len and facet_ids — still one ranged GET;
    the per-posting occurrence arrays live in the payload rows. A v1
    segment's bytes are unchanged."""
    sections = [
        index.meta.to_json(),
        orjson.dumps(index.vocab),
        _npy_bytes(index.term_offsets),
        _npy_bytes(index.block_max),
        _npy_bytes(index.doc_len),
        _npy_bytes(index.idf),
    ]
    magic = _SUPERINDEX_MAGIC
    if index.fields is not None:
        fd = index.fields
        magic = _SUPERINDEX_MAGIC_V2
        sections += [orjson.dumps(_fields_header(fd)),
                     _npy_bytes(fd.field_len),
                     _npy_bytes(fd.facet_ids)]
    out = io.BytesIO()
    out.write(magic)
    for s in sections:
        out.write(len(s).to_bytes(4, "little"))
        out.write(s)
    return out.getvalue()


def unpack_superindex(data: bytes) -> tuple[IndexMeta, dict,
                                            list[np.ndarray], "dict | None"]:
    """Inverse of :func:`pack_superindex` →
    (meta, vocab, [term_offsets, block_max, doc_len, idf], fields_header).

    ``fields_header`` is None for a v1 blob; for v2 it carries
    field_names/pos_slots/facet_names/facet_values plus the hydrated
    ``field_len`` and ``facet_ids`` arrays (the block-aligned occurrence
    arrays hydrate from payload rows, not the header)."""
    magic = data[:4]
    if magic not in (_SUPERINDEX_MAGIC, _SUPERINDEX_MAGIC_V2):
        raise ValueError("not a superindex blob")
    n_sections = 6 + (_V2_SECTIONS if magic == _SUPERINDEX_MAGIC_V2 else 0)
    sections, pos = [], 4
    for _ in range(n_sections):
        n = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        sections.append(data[pos:pos + n])
        pos += n
    meta = IndexMeta.from_json(sections[0])
    vocab = orjson.loads(sections[1])
    arrays = [_npy_load(s) for s in sections[2:6]]
    fields_header = None
    if magic == _SUPERINDEX_MAGIC_V2:
        fields_header = orjson.loads(sections[6])
        fields_header["field_len"] = _npy_load(sections[7])
        fields_header["facet_ids"] = _npy_load(sections[8])
    return meta, vocab, arrays, fields_header


def pack_payload(index: PackedIndex) -> bytes:
    """Interleaved block payload: row i = block i's doc ids (B × int32,
    little-endian) followed by its tfs (B × uint8); a v2 row appends the
    block's stored-occurrence arrays (nocc, field ids, uint16-LE
    positions) so positions/fields hydrate in the same coalesced row
    ranges as docs/tf."""
    NB = index.meta.n_blocks
    if NB == 0:
        return b""
    B = index.meta.block
    fd = index.fields
    P = fd.pos_slots if fd is not None else 0
    rows = np.empty((NB, payload_row_bytes(B, P)), np.uint8)
    docs = np.ascontiguousarray(index.block_docs.astype("<i4"))
    rows[:, :B * 4] = docs.view(np.uint8).reshape(NB, B * 4)
    rows[:, B * 4:B * 5] = index.block_tf.astype(np.uint8)
    if fd is not None:
        o = B * 5
        rows[:, o:o + B] = fd.block_nocc.astype(np.uint8)
        o += B
        rows[:, o:o + B * P] = fd.block_occ_field.astype(
            np.uint8).reshape(NB, B * P)
        o += B * P
        occp = np.ascontiguousarray(fd.block_occ_pos.astype("<u2"))
        rows[:, o:] = occp.view(np.uint8).reshape(NB, B * P * 2)
    return rows.tobytes()


def unpack_payload_rows(chunk: bytes, block: int, pos_slots: int = 0):
    """Decode a contiguous payload row range → (docs (n,B) int32,
    tf (n,B) uint8) for v1 rows, plus (nocc (n,B) uint8,
    occ_field (n,B,P) uint8, occ_pos (n,B,P) uint16) when ``pos_slots``
    names a v2 pitch."""
    B, P = block, pos_slots
    row = payload_row_bytes(B, P)
    n = len(chunk) // row
    rows = np.frombuffer(chunk, np.uint8, count=n * row).reshape(n, row)
    docs = rows[:, :B * 4].copy().view("<i4").astype(np.int32, copy=False)
    docs = docs.reshape(n, B)
    tf = rows[:, B * 4:B * 5].copy()
    if not P:
        return docs, tf
    o = B * 5
    nocc = rows[:, o:o + B].copy()
    o += B
    occf = rows[:, o:o + B * P].copy().reshape(n, B, P)
    o += B * P
    occp = rows[:, o:].copy().view("<u2").astype(np.uint16, copy=False)
    return docs, tf, nocc, occf, occp.reshape(n, B, P)


def write_segment(index: PackedIndex, directory: RamDirectory | None = None) -> RamDirectory:
    """Serialize to Directory files (then publish via AssetCatalog)."""
    d = directory if directory is not None else RamDirectory()
    d.write("meta.json", index.meta.to_json())
    d.write("vocab.json", orjson.dumps(index.vocab))
    for name in SEGMENT_FILES:
        d.write(name + ".npy", _npy_bytes(getattr(index, name)))
    if index.fields is not None:        # v2 eager twin files
        d.write(FIELDS_FILE, orjson.dumps(_fields_header(index.fields)))
        for name in FIELD_NPY_FILES:
            d.write(name + ".npy", _npy_bytes(getattr(index.fields, name)))
    # lazy-hydration layout: header ahead of the interleaved block payload
    d.write(SUPERINDEX_FILE, pack_superindex(index))
    d.write(PAYLOAD_FILE, pack_payload(index))
    return d


def read_segment(directory: Directory) -> PackedIndex:
    """Hydrate a PackedIndex through any Directory (Ram or Store-backed).

    Reading through :class:`StoreDirectory` charges simulated network time to
    the store's stats — that is the cold-start hydration cost the runtime
    bills (paper §2 cold/warm distinction).
    """
    meta = IndexMeta.from_json(directory.open_input("meta.json").read_all())
    vocab = orjson.loads(directory.open_input("vocab.json").read_all())
    arrays = {
        name: _npy_load(directory.open_input(name + ".npy").read_all())
        for name in SEGMENT_FILES
    }
    fields = None
    try:
        # v2 sidecar probe: a miss raises before any simulated network
        # charge, so v1 full hydration pays nothing extra (a LIST here
        # would bill a metadata round-trip on every v1 cold start)
        hdr = orjson.loads(directory.open_input(FIELDS_FILE).read_all())
    except DirectoryError:
        hdr = None
    if hdr is not None:
        fnpy = {name: _npy_load(
            directory.open_input(name + ".npy").read_all())
            for name in FIELD_NPY_FILES}
        fields = FieldData(field_names=hdr["field_names"],
                           pos_slots=hdr["pos_slots"],
                           facet_names=hdr["facet_names"],
                           facet_values=hdr["facet_values"], **fnpy)
    return PackedIndex(meta=meta, vocab=vocab, fields=fields, **arrays)


# -- NRT: combining base + delta segments at hydration ---------------------------


def combine_segments(packs: list[PackedIndex], *, vocab: dict[str, int],
                     stats: dict, tombstones: Iterable[int] = ()) -> PackedIndex:
    """Fuse one base segment + its ordered deltas into ONE PackedIndex.

    The TPU analogue of Lucene's multi-segment reader: fixed-shape jitted
    evaluation wants one array set per compiled fn, so segments fuse at
    HYDRATION (per generation, off the query path) instead of per query —
    base + deltas then score in one vmapped device call.

    * Doc ids concatenate: pack ``i``'s local ids shift by the doc count of
      packs before it (delta docs append after the base, in commit order).
    * Per term, blocks concatenate across packs and re-sort by impact under
      the LIVE stats, preserving the impact-ordering truncation contract.
      The whole fuse is vectorized over blocks (one lexsort by (term,
      -block_max)), never a Python loop over the vocab — hydration cost
      scales with postings, not V × segments.
    * ``stats``/``vocab`` are the generation's live values: idf and avgdl
      are recomputed HERE, at hydration — segment blocks carry only tf and
      doc lengths, which is what makes a delta-served index score exactly
      like a from-scratch rebuild of the live corpus.
    * ``tombstones`` are INTERNAL doc positions in the combined id space
      (a doc deleted and later re-added gets a fresh position, so the old
      copy's tombstone can never kill the new copy). Their postings' tf
      zeroes out, so deleted docs score exactly 0 and can never enter the
      partition-local top-k — subtraction BEFORE top-k, not
      post-filtering (a post-filter would silently shrink k).
    """
    if not packs:
        raise ValueError("combine_segments needs at least a base segment")
    V = len(vocab)
    B = packs[0].meta.block
    k1, b = packs[0].meta.k1, packs[0].meta.b
    for p in packs[1:]:
        if p.meta.block != B or (p.meta.k1, p.meta.b) != (k1, b):
            raise ValueError("segments disagree on block size or BM25 params")

    doc_offsets, n_docs = [], 0
    for p in packs:
        doc_offsets.append(n_docs)
        n_docs += p.meta.n_docs
    doc_ids: list[str] = []
    for p in packs:
        doc_ids.extend(p.meta.doc_ids)
    dead_mask = np.zeros(n_docs + 1, dtype=bool)
    dead_mask[np.asarray(sorted(tombstones), dtype=np.int64)] = True

    n_live = int(stats["n_docs"])
    avgdl = float(stats["avgdl"]) or 1.0
    df_map = stats["df"]
    df = np.zeros(V, dtype=np.float64)
    for t, i in vocab.items():
        df[i] = df_map.get(t, 0)
    idf = np.log(1.0 + (n_live - df + 0.5) / (df + 0.5)).astype(np.float32)

    doc_len = np.concatenate(
        [p.doc_len[:p.meta.n_docs] for p in packs] + [[1.0]]).astype(np.float32)

    # v2 carry-through: occurrence/field/facet arrays ride the SAME block
    # permutation as docs/tf when every pack is structured (a mixed tier
    # degrades to a v1 combine — positions can't be trusted half-present)
    have_fields = all(p.fields is not None for p in packs)
    if have_fields:
        P = packs[0].fields.pos_slots
        fnames0 = packs[0].fields.facet_names
        have_fields = all(p.fields.pos_slots == P
                          and p.fields.facet_names == fnames0
                          for p in packs)
    if have_fields:
        # combined field-id space: union by name, first-seen across packs
        field_names: list[str] = []
        fmap: dict[str, int] = {}
        for p in packs:
            for nm in p.fields.field_names:
                if nm not in fmap:
                    fmap[nm] = len(field_names)
                    field_names.append(nm)
        fid_remaps = [np.asarray([fmap[nm] for nm in p.fields.field_names]
                                 + [0], np.int64) for p in packs]
        # facet value vocabs: union by string per facet field, -1 preserved
        NF = len(fnames0)
        facet_values: list[list[str]] = []
        facet_remaps: list[list[np.ndarray]] = []  # [facet][pack] id remap
        for fi in range(NF):
            vals: list[str] = []
            vmap: dict[str, int] = {}
            remaps = []
            for p in packs:
                r = []
                for v in p.fields.facet_values[fi]:
                    if v not in vmap:
                        vmap[v] = len(vals)
                        vals.append(v)
                    r.append(vmap[v])
                remaps.append(np.asarray(r, np.int64))
            facet_values.append(vals)
            facet_remaps.append(remaps)

    # per pack, vectorized over ALL its blocks at once: shift local ids to
    # the combined space, zero tombstoned/pad tf, recompute block_max under
    # the live stats
    cat_docs, cat_tf, cat_max, cat_term = [], [], [], []
    cat_nocc, cat_occf, cat_occp = [], [], []
    flen_rows, facet_rows = [], []
    for pi, p in enumerate(packs):
        if have_fields:
            fd = p.fields
            # field_len remapped into the combined field-id space
            flen = np.zeros((p.meta.n_docs, len(field_names)), np.float32)
            src = fd.field_len[:p.meta.n_docs]
            if src.shape[1]:
                flen[:, fid_remaps[pi][:src.shape[1]]] = src
            flen_rows.append(flen)
            if NF:
                old = fd.facet_ids.astype(np.int64)
                new = np.empty_like(old, dtype=np.int32)
                for fi in range(NF):
                    remap = facet_remaps[fi][pi]
                    col = old[:, fi]
                    new[:, fi] = np.where(
                        col < 0, -1,
                        remap[np.maximum(col, 0)] if remap.size else -1)
                facet_rows.append(new)
            else:
                facet_rows.append(np.zeros((p.meta.n_docs, 0), np.int32))
        if p.meta.n_blocks == 0:
            continue
        docs = p.block_docs.astype(np.int64)             # (NB_p, B)
        pad = docs >= p.meta.n_docs
        docs = np.where(pad, n_docs, docs + doc_offsets[pi])
        dead = pad | dead_mask[docs]
        tf = np.where(dead, 0, p.block_tf).astype(np.uint8)
        to = p.term_offsets.astype(np.int64)
        n_blk = to[1:] - to[:-1]                         # (V_p,)
        term_of_block = np.repeat(np.arange(len(n_blk)), n_blk)
        dl = doc_len[np.minimum(docs, n_docs)]
        tff = tf.astype(np.float64)
        imp = idf[term_of_block][:, None] * tff / np.where(
            tff > 0, tff + k1 * (1 - b + b * dl / avgdl), 1.0)
        cat_docs.append(docs.astype(np.int32))
        cat_tf.append(tf)
        cat_max.append(imp.max(axis=1))
        cat_term.append(term_of_block)
        if have_fields:
            fd = p.fields
            # tombstoned postings lose their occurrences too (tf is the
            # match indicator; stale positions must not resurrect phrases)
            nocc = np.where(dead, 0, fd.block_nocc).astype(np.uint8)
            slot = np.arange(P)
            live_slot = slot[None, None, :] < nocc[..., None]
            occf = np.where(
                live_slot,
                fid_remaps[pi][fd.block_occ_field.astype(np.int64)], 0
            ).astype(np.uint8)
            occp = np.where(live_slot, fd.block_occ_pos, 0).astype(np.uint16)
            cat_nocc.append(nocc)
            cat_occf.append(occf)
            cat_occp.append(occp)

    if cat_docs:
        docs_all = np.concatenate(cat_docs)
        tf_all = np.concatenate(cat_tf)
        max_all = np.concatenate(cat_max)
        term_all = np.concatenate(cat_term)
        # group by term, impact-descending within; lexsort is stable, so
        # equal-impact blocks keep pack order (base before deltas)
        order = np.lexsort((-max_all, term_all))
        docs_all, tf_all = docs_all[order], tf_all[order]
        max_all, term_all = max_all[order], term_all[order]
        if have_fields:
            nocc_all = np.concatenate(cat_nocc)[order]
            occf_all = np.concatenate(cat_occf)[order]
            occp_all = np.concatenate(cat_occp)[order]
    else:
        docs_all = np.zeros((0, B), np.int32)
        tf_all = np.zeros((0, B), np.uint8)
        max_all = np.zeros(0)
        term_all = np.zeros(0, np.int64)
        if have_fields:
            nocc_all = np.zeros((0, B), np.uint8)
            occf_all = np.zeros((0, B, P), np.uint8)
            occp_all = np.zeros((0, B, P), np.uint16)
    new_off = np.zeros(V + 1, dtype=np.int32)
    new_off[1:] = np.cumsum(np.bincount(term_all, minlength=V)[:V])

    NB = docs_all.shape[0]
    meta = IndexMeta(
        n_docs=n_docs, n_terms=V, n_blocks=NB, block=B,
        avgdl=avgdl, k1=k1, b=b, doc_ids=doc_ids)
    fields = None
    if have_fields:
        field_len = np.concatenate(
            flen_rows + [np.ones((1, len(field_names)), np.float32)]) \
            if flen_rows else np.ones((1, len(field_names)), np.float32)
        facet_ids = np.concatenate(facet_rows) if facet_rows \
            else np.zeros((0, NF), np.int32)
        fields = FieldData(
            field_names=field_names, pos_slots=P, field_len=field_len,
            block_nocc=nocc_all, block_occ_field=occf_all,
            block_occ_pos=occp_all, facet_names=list(fnames0),
            facet_values=facet_values, facet_ids=facet_ids)
    return PackedIndex(
        meta=meta, vocab=dict(vocab), term_offsets=new_off,
        block_docs=docs_all, block_tf=tf_all,
        block_max=max_all.astype(np.float32),
        doc_len=doc_len, idf=idf, fields=fields)


# -- dense-vector tier (hybrid retrieval) -----------------------------------------
#
# "Vector Search with OpenAI Embeddings: Lucene Is All You Need" — a dense
# tier rides the exact same segment machinery as the BM25 tier: immutable
# base + delta segments referenced from the generation manifest, tombstoned
# at query time, served eagerly OR through the same header+range-readable
# twin layout the lazy cold path reads. Row-major (doc, dim) embeddings:
# scoring is one matvec per query (kernels/dot_topk.py), and row r of the
# payload is doc r's vector, so partial hydration can pull exactly the LIVE
# rows of a tombstone-carrying segment with coalesced range reads.

VECTOR_META_FILE = "vec_meta.json"
VECTOR_NPY_FILE = "vectors.npy"
VECTOR_SUPERINDEX_FILE = "vec_superindex.bin"
VECTOR_ROWS_FILE = "vec_rows.bin"
_VECTOR_SUPERINDEX_MAGIC = b"SUPV"
VECTOR_DTYPES = ("float32", "int8")


@dataclasses.dataclass
class VectorMeta:
    n_docs: int
    dim: int
    dtype: str                  # "float32" | "int8" (scale-dequantized)
    scale: float                # f32 value = int8 code × scale (1.0 for f32)
    doc_ids: list[str]          # external ids, position = internal id

    def to_json(self) -> bytes:
        return orjson.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, data: bytes) -> "VectorMeta":
        return cls(**orjson.loads(data))


@dataclasses.dataclass
class PackedVectors:
    """The hydrated, array-form dense tier of one segment."""

    meta: VectorMeta
    vectors: np.ndarray         # (n_docs, dim) in the STORED dtype

    def as_f32(self) -> np.ndarray:
        if self.meta.dtype == "float32":
            return self.vectors.astype(np.float32, copy=False)
        return (self.vectors.astype(np.float32)
                * np.float32(self.meta.scale))

    @property
    def nbytes(self) -> int:
        return self.vectors.nbytes


def pack_vectors(embeddings: np.ndarray, doc_ids: list[str], *,
                 dtype: str = "float32") -> PackedVectors:
    """Pack (n_docs, dim) f32 embeddings as a dense segment tier.

    ``dtype="int8"`` scalar-quantizes symmetrically (scale = max|v|/127),
    trading recall for 4× smaller segments; the dequantized f32 values are
    what the scorer sees, so delta-vs-rebuild parity holds per stored
    representation."""
    emb = np.asarray(embeddings, dtype=np.float32)
    if emb.ndim != 2 or emb.shape[0] != len(doc_ids):
        raise ValueError(f"embeddings {emb.shape} do not match "
                         f"{len(doc_ids)} doc ids")
    if dtype not in VECTOR_DTYPES:
        raise ValueError(f"vector dtype must be one of {VECTOR_DTYPES}, "
                         f"got {dtype!r}")
    if dtype == "int8":
        amax = float(np.abs(emb).max(initial=0.0))
        scale = amax / 127.0 if amax else 1.0
        codes = np.clip(np.round(emb / scale), -127, 127).astype(np.int8)
        meta = VectorMeta(n_docs=len(doc_ids), dim=emb.shape[1],
                          dtype="int8", scale=scale, doc_ids=list(doc_ids))
        return PackedVectors(meta=meta, vectors=codes)
    meta = VectorMeta(n_docs=len(doc_ids), dim=emb.shape[1],
                      dtype="float32", scale=1.0, doc_ids=list(doc_ids))
    return PackedVectors(meta=meta, vectors=emb)


def vector_row_bytes(dim: int, dtype: str) -> int:
    """Bytes per payload row: one doc's ``dim`` elements in the stored
    dtype — the range-read unit of the dense tier's lazy layout."""
    return dim * (4 if dtype == "float32" else 1)


def pack_vector_superindex(pv: PackedVectors) -> bytes:
    """The dense tier's header: just the meta (ids, shape, dtype, scale) —
    everything a partial view needs except the rows themselves."""
    blob = pv.meta.to_json()
    out = io.BytesIO()
    out.write(_VECTOR_SUPERINDEX_MAGIC)
    out.write(len(blob).to_bytes(4, "little"))
    out.write(blob)
    return out.getvalue()


def unpack_vector_superindex(data: bytes) -> VectorMeta:
    if data[:4] != _VECTOR_SUPERINDEX_MAGIC:
        raise ValueError("not a vector superindex blob")
    n = int.from_bytes(data[4:8], "little")
    return VectorMeta.from_json(data[8:8 + n])


def pack_vector_rows(pv: PackedVectors) -> bytes:
    """Row-major payload: row r = doc r's vector, little-endian stored
    dtype — contiguous row ranges are one coalesced ranged GET each."""
    dt = "<f4" if pv.meta.dtype == "float32" else "i1"
    return np.ascontiguousarray(pv.vectors.astype(dt)).tobytes()


def unpack_vector_rows(chunk: bytes, dim: int, dtype: str) -> np.ndarray:
    dt = "<f4" if dtype == "float32" else "i1"
    row = vector_row_bytes(dim, dtype)
    n = len(chunk) // row
    arr = np.frombuffer(chunk, dtype=dt, count=n * dim).reshape(n, dim)
    return arr.astype(np.float32 if dtype == "float32" else np.int8)


def write_vector_segment(pv: PackedVectors,
                         directory: RamDirectory | None = None) -> RamDirectory:
    """Serialize the dense tier: eager npy + the same header/range-readable
    twin layout the BM25 tier carries, so PR 7's lazy cold hydration
    applies to vectors unchanged."""
    d = directory if directory is not None else RamDirectory()
    d.write(VECTOR_META_FILE, pv.meta.to_json())
    d.write(VECTOR_NPY_FILE, _npy_bytes(pv.vectors))
    d.write(VECTOR_SUPERINDEX_FILE, pack_vector_superindex(pv))
    d.write(VECTOR_ROWS_FILE, pack_vector_rows(pv))
    return d


def read_vector_segment(directory: Directory) -> PackedVectors:
    """Eager (full) hydration of one dense-tier segment."""
    meta = VectorMeta.from_json(
        directory.open_input(VECTOR_META_FILE).read_all())
    vectors = _npy_load(directory.open_input(VECTOR_NPY_FILE).read_all())
    return PackedVectors(meta=meta, vectors=vectors)


def combine_vector_segments(packs: list[PackedVectors],
                            tombstones: Iterable[int] = ()
                            ) -> tuple[np.ndarray, list[str], np.ndarray]:
    """Fuse base + ordered delta vector segments into one row-major view.

    Returns (vectors (n_docs, dim) f32, doc_ids, live (n_docs,) bool).
    Row positions concatenate in segment order — the SAME internal id
    space the BM25 tier's :func:`combine_segments` builds, so one
    tombstone list kills a doc in both tiers. Dead rows stay in place
    (ids must not shift) but are flagged ``live=False``; the dense scorer
    excludes them BEFORE its top-k, the dense analogue of
    subtraction-before-top-k (dense scores are legitimately negative, so
    zeroing a dead doc's score would not remove it from the ranking)."""
    if not packs:
        raise ValueError("combine_vector_segments needs at least a base")
    dim = packs[0].meta.dim
    for p in packs[1:]:
        if p.meta.dim != dim:
            raise ValueError("vector segments disagree on dim")
    vectors = np.concatenate([p.as_f32() for p in packs], axis=0)
    doc_ids: list[str] = []
    for p in packs:
        doc_ids.extend(p.meta.doc_ids)
    live = np.ones(len(doc_ids), dtype=bool)
    ts = np.asarray(sorted(tombstones), dtype=np.int64)
    if ts.size:
        live[ts] = False
    return vectors, doc_ids, live


@dataclasses.dataclass
class MergePolicy:
    """Size-tiered delta compaction: when does the delta tier fold back
    into the base segment?

    A growing delta tier costs on three axes — more blocks to hydrate and
    evaluate per query, dead weight (a tombstoned posting's tf zeroes at
    hydration, but it still occupies a block slot that gathers, scores to
    0, and pads the doc-id space — wasted lanes and accumulator width),
    and manifest bloat. Compaction rebuilds the partition's base from its
    LIVE docs (purging tombstones) at the cost of one full re-pack +
    re-upload. Triggers, any of:

    * ``max_deltas``  — the tier is longer than this many segments;
    * ``ratio``       — delta-tier docs outgrow ``ratio`` × base docs
                        (the size-tiered criterion);
    * ``tombstone_ratio`` — deleted docs outgrow this fraction of all docs
                        (the dead-weight bound).
    """

    max_deltas: int = 4
    ratio: float = 0.5
    tombstone_ratio: float = 0.2

    def should_merge(self, base_docs: int, delta_docs: int,
                     n_deltas: int, n_tombstones: int) -> bool:
        total = base_docs + delta_docs
        if n_deltas == 0 and n_tombstones == 0:
            return False
        return (n_deltas > self.max_deltas
                or delta_docs > self.ratio * max(1, base_docs)
                or n_tombstones > self.tombstone_ratio * max(1, total))
