"""The hand-written CUDA kernels against their plain twins on the card,
bitwise, at the parity sweep's small shapes. Imports no JAX, so it runs on
a machine with the card: ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Without a card every test skips."""

import numpy as np
import pytest
import torch

from repro_torch.data.corpus import synth_pruned_blocks
from repro_torch.kernels import ref
from repro_torch.kernels.bm25_block import bm25_block_scores
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk
from repro_torch.kernels.dot_topk import dot_topk_batch
from repro_torch.kernels.topk import topk

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


@pytest.mark.parametrize("shape", [(1, 1, 128), (16, 3, 128), (3, 16, 64, 128)])
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


@pytest.mark.parametrize("N,k,chunk", [(1000, 10, 256), (100_000, 100, 16384), (13, 6, 8)])
def test_topk_kernel_equals_twin(cuda, N, k, chunk):
    rng = np.random.default_rng(N)
    s = torch.from_numpy(rng.standard_normal((3, N)).astype(np.float32)).to(cuda)
    s[1, : N // 2] = 0.5                                     # wide ties
    s[2, ::3] = float("-inf")
    gv, gi = topk(s, k, chunk=chunk)
    wv, wi = ref.topk_ref(s, k)
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


# The dense tier's width (D=768, k=10) at every N and Q; then widths that
# are no multiple of the kernel's 8-column tile (its partial last tile), and
# k of 1, 100 and a whole chunk.
K4_CASES = ([(N, Q, 768, 10) for N in (53, 1091, 250_000) for Q in (1, 7, 64)]
            + [(1091, 7, 13, 10), (250_000, 64, 13, 1), (1091, 64, 100, 100),
               (53, 7, 100, 100), (250_000, 1, 100, 100), (4096, 7, 768, 1),
               (3000, 7, 13, 1024)])


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


def test_kernels_refuse_wrong_dtypes(cuda):
    tf = torch.zeros(2, 2, 128, dtype=torch.int32, device=cuda)
    dl = torch.ones(2, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="u8/f32/f32"):
        bm25_block_scores(tf, dl, torch.ones(2, device=cuda), *_F32)
