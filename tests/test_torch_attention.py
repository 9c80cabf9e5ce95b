"""K5's plain twin and the port's attention against the JAX package: the
Pallas kernel in interpret mode, ``mha_attention_ref`` and
``chunked_attention``. The CUDA kernel against the twin on the card is in
``test_torch_cuda.py``.

Inputs are made with numpy from a seed and handed to both packages, f32.
Tolerance across packages: ``rtol=atol=2e-5`` — both sides are online or
dense softmaxes in f32 that round their sums in other orders (the
reference's own kernel tests hold Pallas to the oracle at 2e-3).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels import backend
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (DECODE_ROWS, MAX_HEAD_DIM, SHORT_HEAD_DIM,
                                                 SHORT_KEYS, SHORT_ROWS, flash_attention,
                                                 simt_path, split_plan, variant)
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
# head dim 80 (h2o-danube) in prefill and decode, then the recsys encoders'
# shapes: bst's 8 heads of 4 over [history; target] (21 tokens, K5's short
# path) and bert4rec's 2 heads of 32 over 200 items (its tiled path)
CASES = [
    (1, 2, 2, 128, 128, 32),
    (2, 4, 2, 128, 128, 64),
    (1, 8, 1, 128, 256, 32),
    (2, 4, 4, 1, 384, 64),
    (2, 8, 2, 96, 96, 80),
    (2, 8, 2, 1, 200, 80),
    (3, 8, 8, 21, 21, 4),
    (2, 2, 2, 200, 200, 32),
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


def _k_begin(shape, kw):
    """The first key that K5's split plan streams for this case."""
    B, _, Hkv, Sq, Skv = shape[:5]
    return split_plan(B * Hkv, Sq, Skv, window=kw.get("window"),
                      kv_end=min(kw.get("kv_len", Skv), Skv))[0]


def _masked_splits(shape, kw, split):
    """(row, split) pairs of batch 0, kv head 0 in which the row sees no key."""
    B, Hq, Hkv, Sq, Skv = shape[:5]
    kv_end = min(kw.get("kv_len", Skv), Skv)
    k_begin = _k_begin(shape, kw)
    qpos = torch.arange(Hq // Hkv * Sq) % Sq + (Skv - Sq)
    return sum(int((~tref.attention_mask(qpos, torch.arange(s0, min(s0 + split, kv_end)),
                                         causal=kw.get("causal", False),
                                         window=kw.get("window"), kv_len=kv_end)
                    .any(dim=1)).sum())
               for s0 in range(k_begin, kv_end, split))


# K5's split-KV decode algorithm in plain PyTorch: (shape, masks, split).
# Decode on a ring with kv_len < slots (G 4, the LM's heads); a window that
# starts the splits past key 0; causal rows at several positions with small
# splits, so that some (row, split) pairs see nothing (m = -inf); a row that
# sees no key at all; Dv != D.
SPLIT_CASES = [
    ((2, 8, 2, 1, 300, 80), dict(kv_len=77), 128),
    ((2, 32, 8, 1, 512, 80), dict(kv_len=400), 128),
    ((1, 4, 2, 1, 300, 32), dict(window=100), 32),
    ((1, 2, 1, 8, 200, 16), dict(causal=True, window=20), 4),
    ((1, 4, 2, 1, 64, 16), dict(kv_len=0), 128),
    ((2, 4, 4, 4, 96, 48, 32), dict(causal=True, kv_len=90), 32),
]


@pytest.mark.parametrize("shape,kw,split", SPLIT_CASES)
def test_split_ref_matches_twin_and_pallas(shape, kw, split):
    """Split-KV's partials and their log-sum-exp merge give the twin's
    softmax to rtol 1e-5 (atol 1e-6: an f32 softmax summed in another order)
    and the Pallas kernel's to the cross-package tolerance."""
    arrays = _qkv(sum(shape) + split, *shape)
    k_begin = _k_begin(shape, kw)
    got, pallas = _both(lambda *a, **k: tref.flash_attention_split_ref(
                            *a, k_begin=k_begin, split=split, **k),
                        lambda *a, **k: jops.flash_attention(*a, interpret=True, **k),
                        arrays, **kw)
    twin = tref.flash_attention_ref(*(torch.from_numpy(a) for a in arrays), **kw).numpy()
    np.testing.assert_allclose(got, twin, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, **TOL)
    if kw.get("kv_len") == 0:
        assert not got.any()
    if kw.get("causal") and "window" in kw:
        assert _masked_splits(shape, kw, split) > 0


def test_variant_dispatch():
    """f32 takes the bit-exact CUDA-core kernel at any shape; bf16 takes
    split-KV up to DECODE_ROWS folded rows (G·Sq) and the tensor cores past
    it; other dtypes are refused. The LM's decode (G 4 · Sq 1) and prefill
    (G 4 · 6144) and the recsys encoders (f32) land where PERF.md says."""
    assert variant(torch.float32, 1) == variant(torch.float32, 4 * 6144) == "simt"
    assert variant(torch.float32, 21) == variant(torch.float32, 200) == "simt"
    assert variant(torch.bfloat16, 4 * 1) == "split"
    assert variant(torch.bfloat16, DECODE_ROWS) == "split"
    assert variant(torch.bfloat16, DECODE_ROWS + 1) == "tc"
    assert variant(torch.bfloat16, 4 * 6144) == "tc"
    with pytest.raises(ValueError, match="f32 or bf16"):
        variant(torch.float16, 4)


def test_simt_path():
    """The f32 kernel's path is a function of the shape alone: bst's bulk
    and p99 encoders (21 rows, 21 keys, head dim 4) take the short path;
    bert4rec's chunk (200 rows and keys, 32) and the LM's f32 prefill (4 ·
    4,608 rows, 80) the tiled one; and at the edges, one key, one row or
    one head dim too many sends a shape to the tiled path."""
    assert simt_path(21, 21, 4, 4) == "short"                 # (a) and (b): bst
    assert simt_path(200, 200, 32, 32) == "tiled"             # (c): bert4rec
    assert simt_path(4 * 4608, 4608, 80, 80) == "tiled"       # (d): the LM's f32 check
    assert simt_path(4, 4616, 80, 80) == "tiled"              # its decode
    assert (SHORT_KEYS, SHORT_ROWS, SHORT_HEAD_DIM) == (64, 256, 32)
    assert simt_path(21, 63, 4, 4) == simt_path(21, 64, 4, 4) == "short"
    assert simt_path(21, 65, 4, 4) == "tiled"
    assert simt_path(256, 64, 32, 32) == "short"
    assert simt_path(257, 64, 32, 32) == "tiled"
    assert simt_path(1, 1, 32, 8) == simt_path(1, 1, 8, 32) == "short"
    assert simt_path(1, 1, 33, 8) == simt_path(1, 1, 8, 33) == "tiled"


def test_simt_limits_match_kernel_source():
    """The limits :func:`simt_path` picks the path by are the ones the C
    entry point of ``csrc/flash_attention.cu`` checks a path against: one
    key tile (``BK``), a thread a row (``THREADS``), the short path's head
    width (``SHORT_DMAX``) and the tiled path's (``MAX_D``)."""
    src = (backend.CSRC / "flash_attention.cu").read_text()
    c = {name: int(n) for name, n in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (c["BK"], c["THREADS"], c["SHORT_DMAX"], c["MAX_D"]) == (
        SHORT_KEYS, SHORT_ROWS, SHORT_HEAD_DIM, MAX_HEAD_DIM)
    assert "kv_seq > BK || rows > THREADS || D > SHORT_DMAX || Dv > SHORT_DMAX" in src


@pytest.mark.parametrize("Hq,Hkv,Sq,D,Dv,path", [(4, 2, 5, 16, 16, "short"),
                                                 (4, 1, 300, 64, 48, "tiled")])
def test_empty_key_axis(Hq, Hkv, Sq, D, Dv, path):
    """Skv = 0 is a shape like any other: the path is chosen as for one key
    and every row is 0 with lse −inf, as the twin gives."""
    assert simt_path(Hq // Hkv * Sq, 0, D, Dv) == path
    q = torch.from_numpy(_qkv(5, 2, Hq, Hkv, Sq, 0, D, Dv)[0])
    k, v = torch.zeros(2, Hkv, 0, D), torch.zeros(2, Hkv, 0, Dv)
    out, lse = flash_attention(q, k, v, causal=path == "tiled", return_lse=True)
    assert out.shape == (2, Hq, Sq, Dv) and not out.any()
    assert lse.shape == (2, Hq, Sq) and bool((lse == float("-inf")).all())


def test_cpu_f32_call_counts_no_path():
    """An f32 call on CPU tensors takes the twin: neither the variant nor the
    path counters move."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 2, 8, 8, 21, 21, 4))
    before, by = dict(flash_attention.launches_by), dict(flash_attention.launches_by_path)
    assert torch.equal(flash_attention(q, k, v), tref.flash_attention_ref(q, k, v))
    assert flash_attention.launches_by == before and flash_attention.launches_by_path == by


def test_split_plan():
    """The keys split-KV streams start at the first key a row's window
    admits and end at kv_len; a split is whole 128-key tiles, as few as
    keep all heads' splits within 264 blocks (two a SM): 512 keys for the
    LM's 32 heads over 4,096 slots, one tile for 8 heads; one split of a
    4-key axis at 70,000 heads; none when kv_len is 0."""
    assert split_plan(1, 1, 4096, window=None, kv_end=3000) == (0, 128, 24)
    assert split_plan(1, 1, 300, window=100, kv_end=300) == (200, 128, 1)
    assert split_plan(32, 1, 4096, window=None, kv_end=4096) == (0, 512, 8)
    assert split_plan(32, 1, 4096, window=None, kv_end=3000) == (0, 384, 8)
    assert split_plan(8, 1, 4096, window=None, kv_end=4096) == (0, 128, 32)
    assert split_plan(4, 1, 8192, window=4096, kv_end=8192) == (4096, 128, 32)
    assert split_plan(70_000, 4, 4, window=None, kv_end=4) == (0, 128 * 266, 1)
    assert split_plan(32, 1, 64, window=None, kv_end=0)[2] == 0


def test_cpu_call_counts_no_variant():
    """On a CPU tensor the wrapper answers with the twin and counts nothing."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(8, 1, 4, 2, 1, 64, 16))
    before, by = flash_attention.launches, dict(flash_attention.launches_by)
    assert torch.equal(flash_attention(q, k, v), tref.flash_attention_ref(q, k, v))
    assert flash_attention.launches == before and flash_attention.launches_by == by
