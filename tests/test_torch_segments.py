"""Segment format parity: for the same docs, the port writes the reference's
bytes file by file (v1 with its range layout, v2 fielded, vector), and each
package reads the other's segments.
"""

import dataclasses

import numpy as np
import pytest

from repro.data.corpus import hash_embedder, synth_corpus, synth_fielded_corpus
from repro.index import builder as jb
from repro_torch.core.directory import RamDirectory as TRamDirectory
from repro_torch.index import builder as tb


def _files(directory):
    return {n: directory.open_input(n).read_all() for n in sorted(directory.list())}


def _pack(mod, docs, **kw):
    w = mod.IndexWriter(**kw)
    w.add_many(docs)
    return w.pack()


CASES = {
    "v1": (lambda: synth_corpus(250, vocab=600, seed=8), {}),
    "v2": (lambda: synth_fielded_corpus(120, vocab=300, seed=9),
           {"structured": True, "facet_fields": ("cat",)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_segment_bytes_identical(case):
    make, kw = CASES[case]
    docs = make()
    want = _files(jb.write_segment(_pack(jb, docs, **kw)))
    got = _files(tb.write_segment(_pack(tb, docs, **kw)))
    assert sorted(got) == sorted(want)
    assert jb.SUPERINDEX_FILE in got and jb.PAYLOAD_FILE in got   # range layout
    for name in want:
        assert got[name] == want[name], f"{case}: {name} differs"


def _assert_packed_equal(a, b):
    assert dataclasses.asdict(a.meta) == dataclasses.asdict(b.meta)
    assert a.vocab == b.vocab
    for name in jb.SEGMENT_FILES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert (a.fields is None) == (b.fields is None)
    if a.fields is not None:
        for name in jb.FIELD_NPY_FILES:
            np.testing.assert_array_equal(getattr(a.fields, name), getattr(b.fields, name))


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_segment(case):
    make, kw = CASES[case]
    docs = make()
    ref_seg = jb.write_segment(_pack(jb, docs, **kw))
    port_seg = tb.write_segment(_pack(tb, docs, **kw))
    from_ref = tb.read_segment(TRamDirectory(_files(ref_seg)))
    from_port = jb.read_segment(jb.RamDirectory(_files(port_seg)))
    _assert_packed_equal(from_ref, jb.read_segment(ref_seg))
    _assert_packed_equal(from_port, tb.read_segment(port_seg))


def test_vector_segment_bytes_identical():
    docs = synth_corpus(60, vocab=200, seed=10)
    embed = hash_embedder(16)
    emb = np.stack([embed(text) for _, text in docs])
    ids = [d for d, _ in docs]
    for dtype in ("float32", "int8"):
        want = _files(jb.write_vector_segment(jb.pack_vectors(emb, ids, dtype=dtype)))
        got = _files(tb.write_vector_segment(tb.pack_vectors(emb, ids, dtype=dtype)))
        assert got == want, dtype
