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


def test_kernels_refuse_wrong_dtypes(cuda):
    tf = torch.zeros(2, 2, 128, dtype=torch.int32, device=cuda)
    dl = torch.ones(2, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="u8/f32/f32"):
        bm25_block_scores(tf, dl, torch.ones(2, device=cuda), *_F32)
