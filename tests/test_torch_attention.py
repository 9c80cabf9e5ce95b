"""K5's plain twin and the port's attention against the JAX package: the
Pallas kernel in interpret mode, ``mha_attention_ref`` and
``chunked_attention``. The CUDA kernel against the twin on the card is in
``test_torch_cuda.py``.

Inputs are made with numpy from a seed and handed to both packages, f32.
Tolerance across packages: ``rtol=atol=2e-5`` — both sides are online or
dense softmaxes in f32 that round their sums in other orders (the
reference's own kernel tests hold Pallas to the oracle at 2e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import attention, chunked_attention

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops: one intra-op thread each keeps these
    tests from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, Dv or D)).astype(np.float32)
    return q, k, v


def _both(fn_t, fn_j, arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    return got, want


# test_kernels.py's flash cases (MHA, GQA, MQA, decode), then the model's
# head dim 80 (h2o-danube) in prefill and decode
CASES = [
    (1, 2, 2, 128, 128, 32),
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 128, 256, 32),
    (2, 4, 4, 1, 384, 64),
    (2, 8, 2, 96, 96, 80),
    (2, 8, 2, 1, 200, 80),
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (*case, causal) for case in CASES for causal in (False, True)
    if not causal or case[3] in (case[4], 1)])          # causal needs aligned positions
def test_twin_matches_pallas_and_oracle(B, Hq, Hkv, Sq, Skv, D, causal):
    arrays = _qkv(B * Skv + D, B, Hq, Hkv, Sq, Skv, D)
    got, pallas = _both(flash_attention, lambda *a, **kw: jops.flash_attention(
        *a, interpret=True, **kw), arrays, causal=causal)
    np.testing.assert_allclose(got, pallas, **TOL)
    _, oracle = _both(tref.mha_attention_ref, jref.mha_attention_ref, arrays, causal=causal)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("kw,shape", [
    (dict(causal=True, window=64), (1, 2, 2, 256, 256, 32)),      # test_flash_attention_window
    (dict(kv_len=100), (2, 2, 2, 1, 512, 32)),                     # _kv_len_mask
    (dict(causal=True, window=40), (2, 8, 2, 150, 150, 80)),       # window, D=80, ragged tile
    (dict(kv_len=77), (4, 32, 8, 1, 128, 80)),                     # decode on a ring, G=4
    (dict(kv_len=0), (1, 4, 2, 1, 64, 16)),                        # nothing visible → 0
])
def test_twin_masks_match_pallas_and_oracle(kw, shape):
    arrays = _qkv(sum(shape), *shape)
    got, pallas = _both(flash_attention, lambda *a, **k: jops.flash_attention(
        *a, interpret=True, **k), arrays, **kw)
    np.testing.assert_allclose(got, pallas, **TOL)
    _, oracle = _both(tref.mha_attention_ref, jref.mha_attention_ref, arrays, **kw)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_twin_mla_vdim():
    """v head dim ≠ qk head dim (MLA shapes), test_flash_attention_mla_vdim."""
    arrays = _qkv(5, 1, 4, 4, 128, 128, 48, Dv=32)
    got, pallas = _both(flash_attention, lambda *a, **k: jops.flash_attention(
        *a, interpret=True, **k), arrays, causal=True)
    assert got.shape == (1, 4, 128, 32)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("kw,block_q", [
    (dict(causal=True), 64),                    # test_flash_vs_chunked_attention
    (dict(causal=True, window=24), 32),
    (dict(kv_len=50), 512),
])
def test_chunked_matches_reference(kw, block_q):
    Sq = 1 if "kv_len" in kw else 256
    arrays = _qkv(6, 2, 4, 2, Sq, 256, 32)
    got, want = _both(chunked_attention, j_chunked, arrays, block_q=block_q, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    flash = attention(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    np.testing.assert_allclose(flash, want, **TOL)


def test_attention_dispatch():
    """No ``impl`` → K5's wrapper (the twin, on a CPU tensor); ``"chunked"``
    → the plain path; anything else is refused."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 4, 2, 64, 64, 16))
    before = flash_attention.launches
    a = attention(q, k, v, causal=True)
    b = attention(q, k, v, impl="chunked", causal=True, block_q=32)
    assert torch.equal(a, tref.flash_attention_ref(q, k, v, causal=True))
    torch.testing.assert_close(a, b, **TOL)
    assert flash_attention.launches == before          # twins launch nothing
    with pytest.raises(ValueError):
        attention(q, k, v, impl="pallas")
