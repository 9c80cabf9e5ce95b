"""The hand-written CUDA kernels against their plain twins on the card,
bitwise (K5's bf16 kernels within a stated tolerance), at the parity
sweep's small shapes and at shapes past the old 65,535 grid limit. Imports
no JAX, so it runs on a machine with the card:
``python -m pytest -q -m gpu tests/test_torch_cuda.py``. Without a card
every test skips."""

import numpy as np
import pytest
import torch

from repro_torch.data.corpus import synth_pruned_blocks
from repro_torch.kernels import ref
from repro_torch.kernels.bm25_block import bm25_block_impacts, bm25_block_scores
from repro_torch.kernels import bm25_pruned
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk, range_docs
from repro_torch.kernels.dot_topk import dot_topk_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import flash_attention, variant
from repro_torch.kernels.topk import topk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_F32 = (np.float32(0.9), np.float32(0.4), np.float32(12.0))

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _on(device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _bits(a, b):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))
    return np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 1, 128), (16, 3, 128), (3, 16, 64, 128), (3, 5, 7, 102)])
def test_bm25_block_kernel_equals_twin(cuda, shape):
    rng = np.random.default_rng(3)
    tf = rng.integers(0, 20, shape).astype(np.uint8)
    dl = rng.uniform(1.0, 200.0, shape).astype(np.float32)
    idf = rng.uniform(0.1, 8.0, shape[:-2]).astype(np.float32)
    tf, dl, idf = _on(cuda, tf, dl, idf)
    before = bm25_block_scores.launches
    got = bm25_block_scores(tf, dl, idf, *_F32)
    assert bm25_block_scores.launches == before + 1
    assert _bits(got, ref.bm25_block_scores_ref(tf, dl, idf, *_F32))


def impacts_case(seed, shape, n_docs, invalid=0.3):
    """numpy (tf, docs, valid, doc_len, idf) of a fused K3 call over
    (..., T, M, B): about a fifth of the docs pads (n_docs), a twentieth of
    tf 0, a share ``invalid`` of the rows invalid."""
    rng = np.random.default_rng(seed)
    tf = rng.integers(0, 20, shape).astype(np.uint8)
    docs = rng.integers(0, n_docs, shape).astype(np.int32)
    docs[rng.random(shape) < 0.2] = n_docs
    valid = rng.random((*shape[:-1], 1)) >= invalid
    doc_len = rng.uniform(1.0, 200.0, n_docs + 1).astype(np.float32)
    idf = rng.uniform(0.1, 8.0, shape[:-2]).astype(np.float32)
    return tf, docs, valid, doc_len, idf


# (Q, T, M, B): one row; B 102 and 37 (groups of 4 postings span two rows,
# and a tail of 2 postings follows the last group); the search path's Q 64 x
# 16 x 64 x 128.
K3_FUSED_SHAPES = [(1, 1, 1, 128), (3, 5, 7, 102), (2, 3, 5, 37), (64, 16, 64, 128)]


@pytest.mark.parametrize("invalid", [0.3, 1.0])
@pytest.mark.parametrize("shape", K3_FUSED_SHAPES)
def test_bm25_block_impacts_kernel_equals_twin(cuda, shape, invalid):
    """K3's fused entry point: one launch a call, bitwise equal to its twin
    (the reference-shaped twin over the gathered doc_len, masked), with
    pads, zero tf and invalid rows — all of them in the second case."""
    n_docs = 1_000_000
    args = _on(cuda, *impacts_case(sum(shape), shape, n_docs, invalid))
    before = bm25_block_impacts.launches
    got = bm25_block_impacts(*args, *_F32, n_docs)
    assert bm25_block_impacts.launches == before + 1
    want = ref.bm25_block_impacts_ref(*args, *_F32, n_docs)
    assert _bits(got, want)
    if invalid == 1.0:
        assert not got.any()


@pytest.mark.parametrize("offset", ["tf", "docs", "out-of-16"])
def test_bm25_block_impacts_kernel_on_unaligned_views(cuda, offset):
    """Both entry points on views that are not 16-byte aligned (tf one byte
    in, docs and dl one element in; or tf 16 bytes in, docs 4 elements: the
    vector path): the scalar loop takes them, bitwise equal to the twins."""
    shape, n_docs = (4, 8, 6, 128), 5000
    tf, docs, valid, doc_len, idf = impacts_case(11, shape, n_docs)
    skip = {"tf": (1, 0), "docs": (0, 1), "out-of-16": (16, 4)}[offset]
    tf_buf = torch.zeros(tf.size + skip[0], dtype=torch.uint8, device=cuda)
    tf_buf[skip[0]:] = torch.from_numpy(tf.reshape(-1)).to(cuda)
    doc_buf = torch.zeros(docs.size + skip[1], dtype=torch.int32, device=cuda)
    doc_buf[skip[1]:] = torch.from_numpy(docs.reshape(-1)).to(cuda)
    tf_v, docs_v = tf_buf[skip[0]:].view(shape), doc_buf[skip[1]:].view(shape)
    aligned = tf_v.data_ptr() % 16 == 0 and docs_v.data_ptr() % 16 == 0
    assert aligned == (offset == "out-of-16")
    valid, doc_len, idf = _on(cuda, valid, doc_len, idf)
    got = bm25_block_impacts(tf_v, docs_v, valid, doc_len, idf, *_F32, n_docs)
    assert _bits(got, ref.bm25_block_impacts_ref(tf_v, docs_v, valid, doc_len, idf, *_F32,
                                                 n_docs))
    dl_buf = torch.zeros(docs.size + skip[1], dtype=torch.float32, device=cuda)
    dl_buf[skip[1]:] = doc_len[torch.clamp(docs_v, max=n_docs).long()].reshape(-1)
    dl_v = dl_buf[skip[1]:].view(shape)
    got = bm25_block_scores(tf_v, dl_v, idf, *_F32)
    assert _bits(got, ref.bm25_block_scores_ref(tf_v, dl_v, idf, *_F32))


@pytest.mark.parametrize("N,k,chunk", [(1000, 10, 256), (100_000, 100, 16384), (13, 6, 8)])
def test_topk_kernel_equals_twin(cuda, N, k, chunk):
    rng = np.random.default_rng(N)
    s = torch.from_numpy(rng.standard_normal((3, N)).astype(np.float32)).to(cuda)
    s[1, : N // 2] = 0.5                                     # wide ties
    s[2, ::3] = float("-inf")
    gv, gi = topk(s, k, chunk=chunk)
    wv, wi = ref.topk_ref(s, k)
    assert _bits(gv, wv) and _bits(gi, wi)


def test_topk_kernel_past_the_old_grid_limit(cuda):
    """Q = 70,000 rows, past the 65,535 of the old grid.y; bitwise."""
    rng = np.random.default_rng(70_000)
    s = torch.from_numpy(rng.standard_normal((70_000, 64)).astype(np.float32)).to(cuda)
    s[::7, :40] = 0.25                                       # ties
    gv, gi = topk(s, 5)
    wv, wi = ref.topk_ref(s, 5)
    assert gv.shape == (70_000, 5) and _bits(gv, wv) and _bits(gi, wi)


def _k2_case(case, k, rng, device):
    """Score rows for K2's select at its edges, as a (Q, n) tensor on
    ``device`` (a strided view for "stride_n_plus_1")."""
    if case == "signed_zeros":       # ±0.0 tied across chunks, a few hits
        s = np.where(rng.random((3, 40_000)) < 0.5, np.float32(-0.0), np.float32(0.0))
        s[:, rng.integers(0, 40_000, 5)] = 1.5
        s[1, ::997] = -0.0
    elif case == "sparse_1m":        # a 1M-wide accumulator, all 0.0 but a few hits
        s = np.zeros((2, 1_000_000), np.float32)
        s[0, rng.integers(0, 1_000_000, 7)] = rng.uniform(1, 9, 7)
        s[1, rng.integers(0, 1_000_000, 300)] = rng.uniform(1, 9, 300)
    elif case == "stride_n_plus_1":  # K1's acc[:, :n_docs]: rows of stride n_docs + 1
        n = 100_003
        acc = np.zeros((4, n + 1), np.float32)
        acc[:, rng.integers(0, n, 400)] = rng.integers(1, 4, 400)
        acc[:, n] = 99.0                                     # the dump slot, past the view
        view = torch.from_numpy(acc).to(device)[:, :n]
        assert view.stride(0) == n + 1
        return view
    elif case == "few_live":         # fewer finite values than k
        s = np.full((3, 5000), -np.inf, np.float32)
        s[:, rng.integers(0, 5000, k // 2)] = rng.standard_normal(k // 2)
    else:                            # "logits": a handful of exponents, wide ties
        s = rng.standard_normal((3, 70_001)).astype(np.float32)
        s[2, ::5] = s[2, 1]
    return torch.from_numpy(s.astype(np.float32)).to(device)


@pytest.mark.parametrize("k", [1, 10, 100, 1024])
@pytest.mark.parametrize("case", ["signed_zeros", "sparse_1m", "stride_n_plus_1", "few_live",
                                  "logits"])
def test_topk_select_edges_equal_twin(cuda, case, k):
    """K2's radix select, bitwise against the twin: signed zeros, skewed
    and mostly-zero rows, unaligned strided rows, fewer live values than k."""
    s = _k2_case(case, k, np.random.default_rng(k), cuda)
    gv, gi = topk(s, k)
    wv, wi = ref.topk_ref(s.cpu(), k)            # the CPU's stable sort ties ±0.0 by index
    assert gv.shape == (s.shape[0], k) and _bits(gv, wv) and _bits(gi, wi)
    if case == "stride_n_plus_1":
        assert not (gi == s.shape[1]).any()                  # never the dump slot


def test_topk_kernel_at_bert4rec_width(cuda):
    """Q 8 × 1,048,578 logits (bert4rec's n_items + 2) at k 100."""
    g = torch.Generator(cuda).manual_seed(8)
    s = torch.randn(8, 1_048_578, device=cuda, generator=g) * 3
    s[3, 16300:16450] = s[3].max()                           # 150 tied across a chunk edge
    before = topk.launches
    gv, gi = topk(s, 100)
    assert topk.launches == before + 3          # 129 chunks of 8,192, then 2 and 1 merge blocks
    wv, wi = ref.topk_ref(s, 100)
    assert _bits(gv, wv) and _bits(gi, wi)


@pytest.mark.parametrize("T,M,n_docs,k", [(1, 1, 200, 10), (8, 4, 2000, 25), (16, 8, 4000, 10),
                                          (1, 2, 300, 200)])
def test_bm25_pruned_kernel_equals_twin(cuda, T, M, n_docs, k):
    batch = [synth_pruned_blocks(T + q, n_terms=T, max_blocks=M, n_docs=n_docs, zipf_a=1.3)
             for q in range(4)]
    args = _on(cuda, *[np.stack(p) for p in zip(*batch)])
    got = bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs)
    want = ref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    assert all(_bits(g, w) for g, w in zip(got, want))



# The smoke's 1M-doc index (T 16, M 64: about 20 ranges a query) at Q 1, 64
# and 100; at k 100 and 200 (the range's floor 0, the merge by the radix
# select); k 1,000 on an 8.8M-doc index (MS MARCO's passages: the P·k
# survivors do not fit in a range, so the merge reads them from device
# memory); T·B = 8,192 first-block postings (64 terms of 128).
K1_RANGE_CASES = ([(16, 64, 1_000_000, 10, Q) for Q in (1, 64, 100)]
                  + [(16, 64, 1_000_000, k, 4) for k in (100, 200)]
                  + [(16, 8, 8_800_000, 1000, 2), (64, 2, 1_000_000, 10, 2)])


@pytest.mark.parametrize("T,M,n_docs,k,Q", K1_RANGE_CASES)
def test_bm25_pruned_kernel_equals_ranges_twin(cuda, T, M, n_docs, k, Q):
    """One launch count a call; values, ids and touched bitwise equal to the
    range-split twin at the kernel's R and to the dense twin."""
    batch = [synth_pruned_blocks(T + q, n_terms=T, max_blocks=M, n_docs=n_docs, zipf_a=1.3)
             for q in range(Q)]
    args = _on(cuda, *[np.stack(p) for p in zip(*batch)])
    before = bm25_pruned_topk.launches
    got = bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs)
    assert bm25_pruned_topk.launches == before + 1
    ranges = ref.bm25_pruned_ranges_ref(*args, *_F32, k=k, n_docs=n_docs,
                                        range_docs=range_docs(T, k))
    dense = ref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    assert all(_bits(g, r) and _bits(g, d) for g, r, d in zip(got, ranges, dense))


RANGES_K = {"tie_edge": 6, "few_positive": 100, "short": 40, "synth": 10}


def ranges_case(case, n_docs, R):
    """(args, k), numpy arrays of a Q=3 batch cut into ranges of R docs:
    "synth" blocks; "tie_edge", every posting one impact, so the k-th score
    ties across the first range edge; "few_positive", fewer positive docs
    than k, so zero-score ids fill the top k across ranges; "short", T·B < k
    (θ = 0)."""
    rng = np.random.default_rng(n_docs)
    k = min(n_docs, RANGES_K[case])
    if case == "synth":
        batch = [synth_pruned_blocks(n_docs + q, n_terms=4, max_blocks=3, n_docs=n_docs,
                                     block=16, zipf_a=1.3) for q in range(3)]
        return [np.stack(p) for p in zip(*batch)], k
    T, M, B = (2, 2, 16) if case == "short" else (2, 3, 128)
    docs = np.full((3, T, M, B), n_docs, np.int32)
    for q in range(3):
        for t in range(T):
            if case == "tie_edge":      # 12 docs about the first edge, the terms' disjoint
                d = np.arange(R - 6 + t, min(n_docs, R + 6 - q), 2)
            elif case == "few_positive":
                d = rng.choice(n_docs, 2, replace=False)
            else:
                d = rng.choice(n_docs, min(n_docs, M * B), replace=False)
            docs[q, t].reshape(-1)[:d.size] = d
    live = docs < n_docs
    tf = np.where(live, 1 if case == "tie_edge" else rng.integers(1, 9, docs.shape), 0)
    dl = np.where(live, 12.0 if case == "tie_edge" else rng.uniform(5, 40, docs.shape), 1.0)
    idf_q = np.ones((3, T)) if case == "tie_edge" else rng.uniform(0.5, 3.0, (3, T))
    valid = live.any(-1)
    ub = np.where(valid, 10.0, 0.0)
    return [tf.astype(np.uint8), dl.astype(np.float32), docs, idf_q.astype(np.float32),
            ub.astype(np.float32), valid], k


@pytest.mark.parametrize("ranges,extra", [(1, 1), (3, 7)])
@pytest.mark.parametrize("case", ["tie_edge", "few_positive"])
def test_bm25_pruned_kernel_across_range_edges(cuda, case, ranges, extra):
    """At n_docs R + 1 and 3R + 7 for the kernel's own R (the last range
    not full, at R + 1 one doc): a k-th score tied across a range edge goes
    to the lower id, and with fewer positive docs than k, which lie in any
    range, the lowest zero-score ids fill the top k; bitwise equal to both
    twins."""
    R = range_docs(2, RANGES_K[case])
    n_docs = ranges * R + extra
    arrays, k = ranges_case(case, n_docs, R)
    args = _on(cuda, *arrays)
    got = bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs)
    split = ref.bm25_pruned_ranges_ref(*args, *_F32, k=k, n_docs=n_docs, range_docs=R)
    dense = ref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    assert all(_bits(g, r) and _bits(g, d) for g, r, d in zip(got, split, dense))
    vals, ids = got[0].cpu().numpy(), got[1].cpu().numpy()
    if case == "tie_edge":                  # the k-th score ties with the next range's
        assert (vals == vals[:, :1]).all() and (ids[:, -1] < R).all()
        full = ref.bm25_pruned_topk_ref(*args, *_F32, k=k + 1, n_docs=n_docs)
        assert (full[0][:, -1].cpu().numpy() == vals[:, -1]).all()
        assert (full[1][:, -1].cpu().numpy() >= R).all()
    else:               # the lowest zero-score ids fill the top k, the last range's too
        pos = vals > 0
        assert (pos.sum(1) < k).all() and (vals[:, -1] == 0).all()
        for q in range(3):
            zeros = ids[q][~pos[q]]
            lowest = np.setdiff1d(np.arange(k + 4), ids[q][pos[q]])[:zeros.size]
            assert np.array_equal(zeros, lowest)


@pytest.mark.parametrize("T,B,k,n_docs,fits", [
    (64, 128, 10, 1_000_000, True),       # T·B 8,192 at k 10
    (16, 128, 1000, 8_800_000, True),     # 166 ranges × k 1,000 survivors
    (65, 128, 10, 1_000_000, False),      # T·B 8,320: θ's sort does not fit
    (64, 128, 10, 200_000_000, True),     # 64 terms × 3,622 ranges of counts
])
def test_bm25_pruned_plan_limits(cuda, T, B, k, n_docs, fits):
    """What the card's K1 takes and refuses, before it allocates anything:
    θ's shared memory grows with T·B; T × ranges no longer limits it (the
    counts go to device memory where they outgrow shared memory)."""
    if fits:
        R, P = bm25_pruned._plan(T, B, k, n_docs)
        assert R == range_docs(T, k) and P == -(-n_docs // R)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            bm25_pruned._plan(T, B, k, n_docs)


def test_bm25_pruned_kernel_past_the_old_range_limit(cuda):
    """64 terms over 200M docs at k 10 — 3,622 ranges, whose 64 × 3,622
    counts no block's shared memory holds — bitwise equal to the dense twin
    (a 0.8 GB accumulator); one launch count."""
    T, M, n_docs, k = 64, 8, 200_000_000, 10
    arrays = synth_pruned_blocks(64, n_terms=T, max_blocks=M, n_docs=n_docs, zipf_a=1.3)
    args = _on(cuda, *[a[None] for a in arrays])
    assert -(-n_docs // range_docs(T, k)) * (T + 2) > 58_000
    before = bm25_pruned_topk.launches
    got = bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs)
    assert bm25_pruned_topk.launches == before + 1
    want = ref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    assert all(_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("budget", ["cursors in shared memory", "none"])
@pytest.mark.parametrize("case", ["1M", "tie_edge"])
def test_bm25_pruned_kernel_with_counts_in_device_memory(cuda, monkeypatch, case, budget):
    """K1's device-memory paths at small sizes: with the shared-memory
    budget lowered to 4·P bytes the counts are scanned in device memory and
    the scatter's cursors stay in shared memory; at 0 the count's histogram
    and the cursors are device-memory atomics. Bitwise equal to both twins,
    on the 1M-doc synthetic blocks and on a k-th score tied across a range
    edge."""
    if case == "1M":
        T, n_docs, k = 16, 1_000_000, 10
        batch = [synth_pruned_blocks(T + q, n_terms=T, max_blocks=64, n_docs=n_docs,
                                     zipf_a=1.3) for q in range(3)]
        arrays = [np.stack(p) for p in zip(*batch)]
        R = range_docs(T, k)
    else:
        R = range_docs(2, RANGES_K[case])
        n_docs = 3 * R + 7
        arrays, k = ranges_case(case, n_docs, R)
    P = -(-n_docs // R)
    monkeypatch.setattr(bm25_pruned, "SMEM_BUDGET", 4 * P if budget != "none" else 0)
    args = _on(cuda, *arrays)
    got = bm25_pruned_topk(*args, *_F32, k=k, n_docs=n_docs)
    split = ref.bm25_pruned_ranges_ref(*args, *_F32, k=k, n_docs=n_docs, range_docs=R)
    dense = ref.bm25_pruned_topk_ref(*args, *_F32, k=k, n_docs=n_docs)
    assert all(_bits(g, r) and _bits(g, d) for g, r, d in zip(got, split, dense))


# The dense tier's width (D=768, k=10) at every N and Q; then widths that
# are no multiple of 4 (D 13: 4-byte copies) or of the kernel's 32-column
# slab (D 100: a partial last slab), k of 1, 100 and the largest, 1,024
# (above the 128 rows of a tile), and Q past one 64-query tile.
K4_CASES = ([(N, Q, 768, 10) for N in (53, 1091, 250_000) for Q in (1, 7, 64)]
            + [(1091, 7, 13, 10), (250_000, 64, 13, 1), (1091, 64, 100, 100),
               (53, 7, 100, 100), (250_000, 1, 100, 100), (4096, 7, 768, 1),
               (3000, 7, 13, 1024), (250_000, 100, 768, 10), (53, 100, 13, 10),
               (250_000, 33, 768, 100)])


@pytest.mark.parametrize("N,Q,D,k", K4_CASES)
def test_dot_topk_kernel_equals_twin(cuda, N, Q, D, k):
    """K4 + K2's merge against the twin, bitwise. Rows 0 and 1 of the first
    chunk repeat in the last one, so ties across chunks must resolve to the
    lowest row; row 0 is scaled up so that it is query 0's best row."""
    rng = np.random.default_rng(N + Q + D + k)
    c = rng.standard_normal((N, D)).astype(np.float32)
    c[0] *= 4
    c[-2:] = c[:2]
    q = rng.standard_normal((Q, D)).astype(np.float32)
    q[0] = c[0]                                        # its best row is tied
    c, q = _on(cuda, c, q)
    before = dot_topk_batch.launches
    gv, gi = dot_topk_batch(q, c, k)
    assert dot_topk_batch.launches == before + 1
    wv, wi = ref.dot_topk_batch_ref(q, c, k)
    assert gv.shape == (Q, k) and _bits(gv, wv) and _bits(gi, wi)
    assert int(gi[0, 0]) == 0
    # a query's bits do not depend on its batch neighbours
    v1, i1 = dot_topk_batch(q[-1:], c, k)
    assert _bits(v1[0], gv[-1]) and _bits(i1[0], gi[-1])


# K5: (B, Hq, Hkv, Sq, Skv, D, Dv, masks, dtype). Every kernel and block
# shape: f32 on the CUDA cores (4, 16 and 64 rows), bf16 split-KV (up to 16
# folded rows) and bf16 on the tensor cores (padded widths 64, 80, 128,
# 256); head dims 48, 80 (h2o-danube) and 256, Dv != D on both sides of 128,
# the window, kv_len on a ring and nothing visible; the LM's exact prefill
# and decode shapes; the recsys encoders' bidirectional shapes; then
# B·Hkv past 65,535, the old limit of grid.y.
K5_CASES = [
    (1, 2, 2, 128, 128, 32, 32, dict(causal=True), torch.float32),
    (2, 4, 2, 130, 130, 80, 80, dict(causal=True, window=40), torch.float32),
    (2, 4, 2, 130, 130, 80, 80, dict(causal=True, window=40), torch.bfloat16),
    (2, 8, 2, 1, 300, 80, 80, dict(kv_len=77), torch.bfloat16),
    (2, 32, 8, 1, 4096, 80, 80, dict(kv_len=4096), torch.bfloat16),
    (1, 8, 1, 1, 256, 32, 32, dict(kv_len=200), torch.float32),
    (1, 4, 4, 128, 128, 48, 32, dict(causal=True), torch.float32),
    (1, 4, 4, 100, 700, 64, 200, dict(kv_len=650, window=300), torch.bfloat16),
    (1, 2, 1, 64, 64, 256, 256, dict(causal=True), torch.bfloat16),
    (1, 4, 2, 1, 64, 16, 16, dict(kv_len=0), torch.float32),
    (16, 8, 8, 21, 21, 4, 4, {}, torch.float32),           # BST: dh 4, history + target
    (4, 2, 2, 200, 200, 32, 32, {}, torch.float32),         # BERT4Rec: dh 32, 200 items
    (2, 4, 2, 300, 300, 48, 48, dict(causal=True), torch.bfloat16),
    (1, 4, 1, 200, 200, 256, 256, dict(causal=True, window=77), torch.bfloat16),
    (1, 4, 2, 200, 520, 192, 96, dict(kv_len=500), torch.bfloat16),
    (1, 2, 1, 96, 96, 20, 12, dict(causal=True), torch.bfloat16),   # no 16-byte rows
    (1, 4, 1, 4, 600, 20, 12, dict(window=250), torch.bfloat16),
    (1, 2, 2, 3, 64, 16, 16, dict(kv_len=0), torch.bfloat16),
    (4, 32, 8, 1, 4096, 80, 80, dict(kv_len=4096), torch.bfloat16),     # the LM's decode
    (4, 32, 8, 1, 4096, 80, 80, dict(kv_len=3000), torch.bfloat16),
    (4, 32, 8, 6144, 6144, 80, 80, dict(causal=True, window=4096), torch.bfloat16),  # prefill
    (70_000, 1, 1, 4, 4, 4, 4, dict(causal=True), torch.float32),
    (35_000, 2, 2, 4, 4, 8, 8, dict(causal=True), torch.bfloat16),
    (35_000, 4, 2, 16, 16, 8, 8, dict(causal=True), torch.bfloat16),
]


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def _sdpa(q, k, v, causal=False, window=None, kv_len=None):
    """``scaled_dot_product_attention`` with K5's masks as a boolean mask;
    a row that sees no key is 0, as K5 defines it."""
    Sq, Skv = q.shape[2], k.shape[2]
    qpos = torch.arange(Sq, device=q.device) + (Skv - Sq)
    mask = ref.attention_mask(qpos, torch.arange(Skv, device=q.device), causal=causal,
                              window=window, kv_len=Skv if kv_len is None else kv_len)
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                           enable_gqa=True)
    return torch.nan_to_num(out, nan=0.0)


def assert_k5_tolerance(got, want, sdpa):
    """The bf16 kernels' bound against the twin, on the whole output: twice
    SDPA's own distance from the twin on the same inputs, or 2^-8 of the
    twin's largest value; and on each row: twice SDPA's distance on that
    row, or one bf16 ulp of the row's largest value (in (2^-8, 2^-7] of it:
    the output's own rounding can differ by that much where two f32 results
    straddle a rounding step), so that rows of small values are not held to
    the bound of the rows with the largest."""
    if not want.numel():
        return
    g, w, sd = got.float(), want.float(), sdpa.float()
    err = (g - w).abs()
    tol = max(2 * float((sd - w).abs().max()), 2.0 ** -8 * float(w.abs().max()))
    assert float(err.max()) <= tol, (float(err.max()), tol)
    top = w.abs().amax(-1)
    ulp = torch.where(top > 0, torch.exp2(torch.frexp(top).exponent.float() - 8), 0.0)
    row_tol = torch.maximum(2 * (sd - w).abs().amax(-1), ulp)
    bad = (err.amax(-1) > row_tol).nonzero()
    assert not len(bad), (len(bad), bad[0].tolist(), float(err.amax(-1)[tuple(bad[0])]),
                          float(row_tol[tuple(bad[0])]))


ORACLE_SCORES = 1 << 22         # f32 scores per (batch, head) the dense oracle may hold


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,Dv,kw,dtype", K5_CASES)
def test_flash_attention_kernel_equals_twin(cuda, B, Hq, Hkv, Sq, Skv, D, Dv, kw, dtype):
    """f32: bitwise equal to the twin. bf16 (tensor cores or split-KV):
    within :func:`assert_k5_tolerance` of it. Both within 2e-2 of the dense
    oracle on every query row where its scores fit ``ORACLE_SCORES``; past
    that (the LM's 6,144-token prefill), on as many last rows and, for a
    causal prefill, as many first rows, which see only the first keys."""
    g = torch.Generator(device=cuda).manual_seed(B * Skv + D)
    q = torch.randn(B, Hq, Sq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(B, Hkv, Skv, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(B, Hkv, Skv, Dv, generator=g, device=cuda).to(dtype)
    kind = variant(dtype, Hq // Hkv * Sq)
    before, by = flash_attention.launches, flash_attention.launches_by[kind]
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by[kind] == by + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, Hq, Sq, Dv)
    if dtype == torch.float32:
        assert _same_bits(got, want)
    else:
        assert_k5_tolerance(got, want, _sdpa(q, k, v, **kw))
    rows = max(1, min(Sq, ORACLE_SCORES // Skv))
    spans = [(slice(Sq - rows, Sq), slice(None))]
    if rows < Sq and Sq == Skv and kw.get("causal") and "kv_len" not in kw:
        spans.append((slice(0, rows), slice(0, rows)))
    for qs, ks in spans:
        oracle = ref.mha_attention_ref(q[:, :, qs].float(), k[:, :, ks].float(),
                                       v[:, :, ks].float(), **kw)
        torch.testing.assert_close(got[:, :, qs].float(), oracle, rtol=2e-2, atol=2e-2)


# K6: (B, L, D, table dtype). FM's linear table (D 1) and tower (D 10),
# DCN-v2's (D 16), BST's and wider rows; B no multiple of a block's bags;
# L past one staged tile of slots (15 at D 1); D past one block's 256
# columns; a bag of length 0.
K6_CASES = [(37, 39, 1, torch.float32), (1000, 64, 1, torch.bfloat16),
            (300, 39, 10, torch.float32), (17, 26, 16, torch.float32),
            (17, 26, 16, torch.bfloat16), (5, 64, 32, torch.float32),
            (9, 20, 128, torch.bfloat16), (3, 40, 300, torch.float32),
            (33, 0, 8, torch.float32)]


@pytest.mark.parametrize("B,L,D,dtype", K6_CASES)
def test_embedding_bag_kernel_equals_twin(cuda, B, L, D, dtype):
    """Pads (-1) scattered through the bags, bag 0 all pads, repeated ids."""
    rng = np.random.default_rng(B * 131 + L * 7 + D)
    V = 5000
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(cuda, dtype)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    idx[rng.random((B, L)) < 0.25] = -1
    idx[0] = -1
    w = rng.standard_normal((B, L)).astype(np.float32)
    idx, w = _on(cuda, idx, w)
    before = embedding_bag.launches
    got = embedding_bag(table, idx, w)
    assert embedding_bag.launches == before + 1
    want = ref.embedding_bag_ref(table, idx, w)
    torch.cuda.synchronize()
    assert got.shape == (B, D) and _bits(got, want)
    assert not got[0].any()



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 200])
@pytest.mark.parametrize("D", [2, 3, 4, 10])
@pytest.mark.parametrize("offset", ["row", "element"])
def test_embedding_bag_kernel_on_unaligned_tables(cuda, offset, D, L, dtype):
    """K6's vector widths on a table whose base is not 16-byte aligned (a
    view one row or one element in), NaN and inf weights on pad slots."""
    rng = np.random.default_rng(D * 1000 + L)
    V, B = 3000, 67
    skip = D if offset == "row" else 1
    flat = torch.from_numpy(rng.standard_normal(V * D + skip).astype(np.float32))
    table = flat.to(cuda, dtype)[skip:].view(V, D)
    assert table.data_ptr() % 16 != 0 or D == 4 and offset == "row" and dtype == torch.float32
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    idx[rng.random((B, L)) < 0.3] = -1
    w = rng.standard_normal((B, L)).astype(np.float32)
    pads = np.flatnonzero(idx < 0)
    w.reshape(-1)[pads[::2]] = np.nan
    w.reshape(-1)[pads[1::2]] = np.inf
    idx, w = _on(cuda, idx, w)
    got = embedding_bag(table, idx, w)
    want = ref.embedding_bag_ref(table, idx, w)
    torch.cuda.synchronize()
    assert got.shape == (B, D) and _bits(got, want) and bool(torch.isfinite(got).all())

def test_kernels_refuse_wrong_dtypes(cuda):
    tf = torch.zeros(2, 2, 128, dtype=torch.int32, device=cuda)
    dl = torch.ones(2, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="u8/f32/f32"):
        bm25_block_scores(tf, dl, torch.ones(2, device=cuda), *_F32)
    q = torch.zeros(1, 2, 4, 16, dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention(q, q, q)


# -- the structured evaluator and a commit on the card ------------------------------


def _fielded(n, seed):
    from repro_torch.data.corpus import synth_fielded_corpus
    docs = synth_fielded_corpus(n, vocab=n // 2, seed=seed)
    # one doc whose positions run past the uint16 clamp
    return docs + [("far", {"title": "far away", "body": " ".join(["filler"] * 65_530)
                            + " alpha beta gamma alpha beta gamma", "cat": "c0"})]


def test_structured_evaluator_on_card_equals_cpu(cuda):
    """``evaluate_structured`` on the card equals the same function on the
    CPU (scores and eligibility bitwise, facets exact) for term, fielded,
    phrase and scoped-phrase leaves, and the batch's top-k — one K2 call on
    the card — equals the CPU twin's ids and score bits."""
    from repro_torch.data.corpus import synth_structured_queries
    from repro_torch.index.builder import IndexWriter, compute_global_stats, field_avgdl
    from repro_torch.search.query import parse_query
    from repro_torch.search.structured import (StructuredState, evaluate_structured,
                                               facet_counts, structured_topk)
    docs = _fielded(4000, seed=5)
    w = IndexWriter(structured=True, facet_fields=("cat",))
    w.add_many(docs)
    packed = w.pack()
    card = StructuredState.from_packed(packed, device=cuda)
    cpu = StructuredState.from_packed(packed, device="cpu")
    stats = compute_global_stats(docs, fields=True)
    favg = {f: field_avgdl(stats, f) for f in stats["fields"]}
    qs = synth_structured_queries(docs, 40, seed=16) + [
        '"alpha beta"', '"beta gamma"', 'body:"gamma alpha beta"', "filler^2 OR title:far"]
    got, want = [], []
    for sq in qs:
        a, ea = evaluate_structured(card, parse_query(sq), field_avgdl=favg)
        b, eb = evaluate_structured(cpu, parse_query(sq), field_avgdl=favg)
        assert _bits(a, b) and _bits(ea, eb), sq
        assert facet_counts(card, ea, "cat") == facet_counts(cpu, eb, "cat"), sq
        got.append(a)
        want.append(b)
    topk.launches = 0
    gv, gi = structured_topk(torch.stack(got), 100)
    assert topk.launches > 0
    wv, wi = structured_topk(torch.stack(want), 100)
    assert _bits(gv, wv) and _bits(gi, wi)


def test_commit_on_the_card_matches_the_cpu(cuda):
    """The same structured fleet with a dense tier on the card and on the
    CPU (pruned + kernels, modeled clock): every response — sparse, dense,
    hybrid and structured with facets — and every commit body is equal,
    through a commit of adds and deletes inside an open window, and no
    deleted id is served after it."""
    from repro_torch.core.gateway import WindowPolicy
    from repro_torch.core.partition import (FleetSpec, GatewaySpec, IndexSpec,
                                            ReplicationSpec, VectorSpec)
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.data.corpus import synth_queries, synth_structured_queries
    from repro_torch.index.tokenizer import flatten_text
    from repro_torch.search.searcher import SearchConfig
    from repro_torch.search.service import build_partitioned_search_app
    docs = _fielded(3000, seed=7)[:-1]
    base, incoming = docs[:2600], docs[2600:]
    sqs = synth_structured_queries(base, 12, seed=16)
    bag = synth_queries([(e, flatten_text(t)) for e, t in base], 12, seed=17)

    def build(device):
        return build_partitioned_search_app(base, FleetSpec(
            n_parts=4, replication=ReplicationSpec(replicas=2),
            gateway=GatewaySpec(window=WindowPolicy(max_window_s=0.5, sparse_qps=0.0)),
            index=IndexSpec(structured=True, facet_fields=("cat",),
                            vector=VectorSpec(dim=64)),
            search_config=SearchConfig(accumulator="pruned", use_kernel=True,
                                       use_topk_kernel=True, k=20, sim_exec_s=0.002,
                                       sim_write_s=0.02),
            runtime_config=RuntimeConfig(seed=0)), device=device)

    def run(app):
        out = []
        for q, sq in zip(bag, sqs):
            for mode in ("sparse", "dense", "hybrid"):
                out.append(app.query(q, k=10, mode=mode, t_arrival=app.runtime.clock + 0.05))
            out.append(app.query(sq=sq, k=10, facets=["cat"], snippets=True,
                                 t_arrival=app.runtime.clock + 0.05))
        t0 = app.runtime.clock + 1.0
        pre = [app.submit(sq=sq, k=10, facets=["cat"], t_arrival=t0 + 0.001 * i)
               for i, sq in enumerate(sqs[:6])]
        out.append(app.add_documents(incoming, t_arrival=t0 + 0.01))
        out.append(app.delete_documents([e for e, _ in base[::13]], t_arrival=t0 + 0.01))
        out.append(app.commit(t_arrival=t0 + 0.02))
        post = [app.submit(sq=sq, k=10, facets=["cat"], t_arrival=app.runtime.clock + 0.001 * i)
                for i, sq in enumerate(sqs[6:])]
        app.flush()
        out += [h.response for h in pre + post]
        for q, sq in zip(bag, sqs):
            for mode in ("sparse", "dense", "hybrid"):
                out.append(app.query(q, k=10, mode=mode, t_arrival=app.runtime.clock + 0.05))
            out.append(app.query(sq=sq, k=10, facets=["cat"], t_arrival=app.runtime.clock + 0.05))
        return out

    on_card, on_cpu = run(build(cuda)), run(build("cpu"))
    assert len(on_card) == len(on_cpu)
    for a, b in zip(on_card, on_cpu):
        assert (a.status, a.latency_s, a.body) == (b.status, b.latency_s, b.body)
    committed = next(r for r in on_card if r.body.get("committed"))
    assert committed.body["gen"] == 2 and not committed.body["merged"]
    deleted = {e for e, _ in base[::13]}
    after = [r for r in on_card if r.body.get("generation") == 2]
    assert len(after) == 6 + 4 * len(sqs)
    assert not deleted & {e for r in after for e in r.body["ext_ids"]}


# -- hand kernels have no backward: K5 and K6 refuse to cut autograd -----------------


def test_k5_and_k6_refuse_inputs_that_require_grad(cuda):
    """On the card K5 and K6 write into fresh outputs with no ``grad_fn``:
    with grad enabled, an input that requires grad is refused (through
    ``attention``'s default route too); under ``inference_mode``, ``no_grad``
    or on inputs that need no grad the same calls run."""
    from repro_torch.models.attention import attention
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, device=cuda, generator=g) for _ in range(3))
    table = torch.randn(40, 8, device=cuda, generator=g)
    idx = torch.randint(0, 40, (5, 3), device=cuda, generator=g, dtype=torch.int32)
    w = torch.ones(5, 3, device=cuda)
    qg, tg = q.clone().requires_grad_(), table.clone().requires_grad_()
    for call in (lambda: flash_attention(qg, k, v), lambda: attention(qg, k, v),
                 lambda: embedding_bag(tg, idx, w)):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            assert _bits(flash_attention(qg, k, v), flash_attention(q, k, v))
            assert _bits(embedding_bag(tg, idx, w), embedding_bag(table, idx, w))
    assert flash_attention(q, k, v).grad_fn is None
    assert embedding_bag(table, idx, w).shape == (5, 8)


# -- the mesh path stacked on the card ------------------------------------------------


def test_stacked_mesh_search_on_the_card_equals_the_cpu(cuda):
    """Eight partitions stacked on the card as a (4, 2) mesh: every
    (accumulator, gather) answers with the CPU's ids and score bits, and K2
    carries the top-k."""
    import torch_mesh_ranks as ranks
    from repro_torch.parallel.compat import StackedMesh
    before = topk.launches
    card = ranks.search_outputs(StackedMesh((4, 2), device=cuda))
    assert topk.launches > before
    cpu = ranks.search_outputs(StackedMesh((4, 2), device="cpu"))
    assert sorted(card) == sorted(cpu)
    for key in cpu:
        assert np.array_equal(card[key].view(np.uint8), cpu[key].view(np.uint8)), key
    lookup = ranks.lookup_outputs(StackedMesh((2, 4), device=cuda))["rows"]
    table, ids = ranks.lookup_inputs()
    assert np.array_equal(lookup.view(np.uint32), table[ids].view(np.uint32))


def test_bert4rec_sharded_topk_on_the_card_equals_unsharded(cuda):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys import bert4rec_serve_topk, recsys_param_defs
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    cfg = get_arch("bert4rec").reduced_config()
    params = init_params(recsys_param_defs(cfg), torch.Generator().manual_seed(4), "cuda")
    seq = np.random.default_rng(5).integers(0, cfg.n_items, (6, cfg.seq_len)).astype(np.int32)
    want = bert4rec_serve_topk(params, seq, cfg, k=10)
    with use_mesh(StackedMesh((1, 4), device=cuda)):
        got = bert4rec_serve_topk(params, seq, dataclasses.replace(cfg, sharded_topk=True), k=10)
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])


@pytest.mark.parametrize("T,E,k", [(16_384, 64, 8), (4_096, 160, 6), (4, 64, 8), (2, 160, 6)])
def test_topk_kernel_at_router_widths(cuda, T, E, k):
    """K2 on MoE router probabilities (olmoe: 64 experts top-8, deepseek-v2:
    160 top-6; prefill and decode rows), one launch a call, bitwise; ties
    in every row go to the lowest expert id."""
    g = torch.Generator(device=cuda).manual_seed(T + E)
    probs = torch.softmax(torch.randn(T, E, generator=g, device=cuda), dim=-1)
    probs[::7, : E // 2] = 1.0 / E                          # wide ties
    before = topk.launches
    gv, gi = topk(probs, k)
    assert topk.launches == before + 1
    wv, wi = ref.topk_ref(probs, k)
    assert _bits(gv, wv) and _bits(gi, wi)


def test_flash_attention_tc_at_mla_widths(cuda):
    """K5's tensor-core prefill at deepseek-v2's MLA widths (qk dim 192, v
    dim 128, MHA, sm_scale 1/sqrt(192)): within :func:`assert_k5_tolerance`
    of the twin and 2e-2 of the dense oracle."""
    g = torch.Generator(device=cuda).manual_seed(192)
    B, H, S, D, Dv = 2, 16, 600, 192, 128
    q, k = (torch.randn(B, H, S, D, generator=g, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(B, H, S, Dv, generator=g, device=cuda).to(torch.bfloat16)
    kw = dict(causal=True, sm_scale=D ** -0.5)
    assert variant(q.dtype, S) == "tc"
    before = flash_attention.launches_by["tc"]
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches_by["tc"] == before + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    mask = ref.attention_mask(torch.arange(S, device=cuda), torch.arange(S, device=cuda),
                              causal=True, window=None, kv_len=S)
    sdpa = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                            scale=kw["sm_scale"])
    assert got.shape == (B, H, S, Dv)
    assert_k5_tolerance(got, want, sdpa)
    oracle = ref.mha_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), oracle, rtol=2e-2, atol=2e-2)


def test_moe_combine_is_deterministic_on_the_card(cuda):
    """The MoE FFN in bf16 on the card, run twice: equal bit for bit (the
    combine sums each token's slots in ascending expert order, no atomics);
    expert parallelism on a stacked (1, 1) mesh gives the same bits, and on
    (1, 4) the global dispatch's slot tables."""
    from repro_torch.models import moe
    from repro_torch.models.common import init_params
    from repro_torch.models.moe_ep import ep_moe_ffn, ep_tables
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    cfg = moe.MoEConfig(n_experts=64, top_k=8, d_model=256, d_ff=128, n_shared=1)
    params = init_params(moe.moe_defs(cfg, torch.bfloat16), torch.Generator().manual_seed(0),
                         cuda)
    x = torch.randn(4, 512, 256, generator=torch.Generator().manual_seed(1)).to(
        cuda, torch.bfloat16)
    y1, aux1 = moe.moe_ffn(params, x, cfg)
    y2, aux2 = moe.moe_ffn(params, x, cfg)
    same = lambda a, b: torch.equal(a.view(torch.int16), b.view(torch.int16))  # noqa: E731
    assert same(y1, y2) and float(aux1) == float(aux2)
    with use_mesh(StackedMesh((1, 1), device=cuda)):
        ye, _ = ep_moe_ffn(params, x, cfg)
    assert same(ye, y1)
    _, keep, slots = moe._tables(params, x, cfg)
    with use_mesh(StackedMesh((1, 4), device=cuda)):
        ep_keep, ep_slots = ep_tables(params, x, cfg)
    assert torch.equal(ep_keep, keep) and torch.equal(ep_slots, slots)


# -- training: the kernels refuse grad; the plain paths train ------------------------------


def _grad_inputs(name, device):
    """(call, the float inputs that may require grad) of K1–K4 at a small shape."""
    g = torch.Generator().manual_seed(0)
    if name == "K3":
        tf = torch.randint(0, 5, (2, 3, 128), generator=g, dtype=torch.uint8).to(device)
        dl = (torch.rand(2, 3, 128, generator=g) * 50 + 1).to(device)
        idf = torch.rand(2, generator=g).to(device)
        return (lambda dl, idf: bm25_block_scores(tf, dl, idf, *_F32)), (dl, idf)
    if name == "K2":
        return (lambda s: topk(s, 5)), (torch.randn(3, 200, generator=g).to(device),)
    if name == "K4":
        return ((lambda q, c: dot_topk_batch(q, c, 5)),
                (torch.randn(2, 16, generator=g).to(device),
                 torch.randn(300, 16, generator=g).to(device)))
    tf, dl, docs, idf_q, ub, valid = (torch.as_tensor(x).to(device) for x in synth_pruned_blocks(
        0, n_terms=2, max_blocks=2, n_docs=1000))
    return ((lambda dl, idf_q: bm25_pruned_topk(tf, dl, docs, idf_q, ub, valid, *_F32, k=5,
                                                n_docs=1000)),
            (dl.float(), idf_q.float()))


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4"])
def test_kernels_refuse_inputs_that_require_grad(cuda, name):
    call, inputs = _grad_inputs(name, cuda)
    call(*inputs)                                       # launches without grad
    live = [x.clone().requires_grad_(True) for x in inputs]
    with pytest.raises(RuntimeError, match="no backward"):
        call(*live)
    with torch.no_grad():
        call(*live)


def test_moe_train_step_gives_the_router_its_cpu_gradient(cuda):
    """olmoe's reduced config (global dispatch) on the card: K2 picks the
    experts, the gates come from the probabilities, so the router gets a
    nonzero gradient, the CPU twin's within f32 tolerance."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params, tree_map
    from repro_torch.models.transformer import lm_loss, lm_param_defs
    from repro_torch.train.steps import value_and_grad
    cfg = get_arch("olmoe-1b-7b").reduced_config()
    params = init_params(lm_param_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int64)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    from repro_torch.kernels import topk as k2
    before = k2.topk.launches
    out = {}
    for dev in ("cpu", cuda):
        on = tree_map(lambda t: t.to(dev), params)
        loss, _, grads = value_and_grad(lambda p, b: lm_loss(p, b, cfg), on, batch)
        out[str(dev)] = (float(loss), grads["layers"]["ffn"]["router"].cpu())
    assert k2.topk.launches > before                    # the router's top-k ran on K2
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert float(g_gpu.abs().sum()) > 0
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=1e-3, atol=1e-6)


GNN_REPEAT = r"""
import os, sys
import numpy as np, torch
torch.use_deterministic_algorithms(True)
from repro_torch.configs import get_arch
from repro_torch.data.graphs import NeighborSampler, synth_graph
from repro_torch.models.common import init_params, tree_leaves
from repro_torch.models.gnn import gnn_loss, gnn_param_defs
from repro_torch.train.optim import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step
cfg = get_arch("graphcast").full_config(d_feat=64, n_layers=4, aggregator="mean")
g = synth_graph(20_000, avg_degree=10, d_feat=64, seed=0)
sub = NeighborSampler(g, fanout=(15, 10), seed=0).sample(np.arange(128), step=0)
sub["target"] = np.random.default_rng(1).normal(size=(len(sub["feat"]), 227)).astype(np.float32)
step = make_train_step(lambda p, b: gnn_loss(p, b, cfg), OptConfig(lr=1e-3, warmup_steps=1))
runs = []
for _ in range(2):
    state = init_train_state(init_params(gnn_param_defs(cfg), torch.Generator().manual_seed(0),
                                         "cuda"))
    for _ in range(2):
        state, m = step(state, sub)
    runs.append([t.cpu() for t in tree_leaves(state)])
same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(*runs))
print("SAME" if same else "DIFFERENT")
"""


def test_graphcast_train_steps_repeat_bitwise_under_deterministic_algorithms(cuda, tmp_path):
    """Two graphcast steps (4 layers at d 512, mean aggregation — a segment
    sum over the sorted edges, divided by the counts — on a fanout-15-10
    sample) run twice from one init: the same bits. Under
    ``torch.use_deterministic_algorithms(True)`` (cuBLAS's workspace set
    before it starts, so in a process of its own), an op without a
    deterministic kernel on the card raises and names itself."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", GNN_REPEAT], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1] == "SAME"
