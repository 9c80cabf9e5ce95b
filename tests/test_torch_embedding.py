"""K6's plain twin and the port's ``models/embedding.py`` against the JAX
package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
reference's Pallas ``embedding_bag`` cannot run on the installed jax (it
calls ``pl.load``, which jax 0.9 no longer has), so the twin is held
against the reference's own plain version, ``ref.embedding_bag_ref``, an
``einsum`` whose summation order is unspecified; and the offsets form
against ``models/embedding.py::embedding_bag`` (gather, scale,
``segment_sum``). Tolerance across packages: ``|port − ref| ≤ 2e-6 ·
Σ_l |w_l·row_l|`` per output element — the same f32 sum in another order.
Inside the port the wrapper on a CPU tensor IS the twin, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import embedding as jemb
from repro_torch.kernels import ref
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models import common as tcommon
from repro_torch.models import embedding as temb

TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops: one intra-op thread each keeps these
    tests from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bag_inputs(V, D, B, L, seed, pad=0.3):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    idx[rng.random((B, L)) < pad] = -1
    w = rng.standard_normal((B, L)).astype(np.float32)
    return table, idx, w


def _scale(table, idx, w):
    """Σ_l |w_l · row_l| per (bag, column), in float64."""
    rows = np.abs(table.astype(np.float64)[np.maximum(idx, 0)])
    return np.einsum("bld,bl->bd", rows, np.where(idx >= 0, np.abs(w), 0.0))


def _assert_sums_close(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= TOL * scale).all(), np.abs(got - want).max()


# test_kernels.py's three (V, D, B, L) cases, then D = 1 (FM's linear
# table), a long bag, and bags that are all padding
CASES = [(64, 8, 4, 3), (1000, 32, 16, 10), (50, 128, 7, 5), (300, 1, 33, 39),
         (500, 16, 5, 64)]


@pytest.mark.parametrize("V,D,B,L", CASES)
def test_embedding_bag_twin_vs_reference(V, D, B, L):
    table, idx, w = _bag_inputs(V, D, B, L, seed=V + D)
    idx[0] = -1                                        # one bag of pads only
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w))
    t, i, ww = (torch.from_numpy(a) for a in (table, idx, w))
    got = ref.embedding_bag_ref(t, i, ww)
    _assert_sums_close(got, want, _scale(table, idx, w))
    assert got.dtype == torch.float32 and torch.equal(got[0], torch.zeros(D))
    # on a CPU tensor the wrapper is the twin, bit for bit
    assert torch.equal(embedding_bag(t, i, ww).view(torch.int32), got.view(torch.int32))


def test_embedding_bag_twin_order_and_pads():
    """The twin's order is the kernel's: slot by slot from +0.0; a pad slot
    leaves the sum as it was (it is skipped, not weighted by 0, so the row
    a pad would gather cannot turn the sum into NaN); a bf16 table is summed
    in f32 exactly as its f32 copy."""
    table = torch.tensor([[float("inf")], [1e8], [1.0], [-1e8]])
    idx = torch.tensor([[1, 2, 3, -1], [-1, -1, 2, -1], [-1, -1, -1, -1]], dtype=torch.int32)
    w = torch.ones(3, 4)
    got = ref.embedding_bag_ref(table, idx, w)
    assert got[:, 0].tolist() == [0.0, 1.0, 0.0]       # (1e8 + 1) − 1e8 in f32 is 0
    tab, i, ww = (torch.from_numpy(a) for a in _bag_inputs(90, 12, 6, 9, seed=3))
    bf = tab.to(torch.bfloat16)
    assert torch.equal(ref.embedding_bag_ref(bf, i, ww), ref.embedding_bag_ref(bf.float(), i, ww))


def test_embedding_bag_refuses_bad_inputs():
    """Shapes and dtypes are checked on the CPU as on the card."""
    t, i, w = torch.zeros(5, 3), torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, 4)
    assert embedding_bag(t, i, w).shape == (2, 3)
    for bad in ((t.half(), i, w), (t, i.long(), w), (t, i, w.double()), (t, i, w[:, :3]),
                (t[0], i, w)):
        with pytest.raises(ValueError):
            embedding_bag(*bad)


# (lengths of the bags, n_bags): empty bags first, in the middle and last;
# a lone long bag; offsets past the end
OFFSETS = {
    "ragged": ([3, 0, 5, 1, 0, 7, 2, 0], 8),
    "one-long": ([40], 1),
    "all-empty": ([0, 0, 0], 3),
}


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", sorted(OFFSETS))
def test_offsets_embedding_bag_vs_reference(mode, weighted, layout):
    lengths, n_bags = OFFSETS[layout]
    rng = np.random.default_rng(len(lengths) + 10 * weighted)
    L = sum(lengths)
    table = rng.standard_normal((70, 6)).astype(np.float32)
    indices = rng.integers(0, 70, L).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int32)
    weights = rng.standard_normal(L).astype(np.float32) if weighted else None
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(indices), jnp.asarray(offsets),
                              n_bags, weights=None if weights is None else jnp.asarray(weights),
                              mode=mode)
    got = temb.embedding_bag(torch.from_numpy(table), indices, offsets, n_bags,
                             weights=weights, mode=mode)
    # the same sums in padded form: bag b's slots are its indices in order
    idx = np.full((n_bags, max(lengths + [1])), -1, np.int32)
    w = np.zeros(idx.shape, np.float32)
    for b, (o, n) in enumerate(zip(offsets, lengths)):
        idx[b, :n] = indices[o:o + n]
        w[b, :n] = 1.0 if weights is None else weights[o:o + n]
    scale = _scale(table, idx, w)
    if mode == "mean":
        scale = scale / np.maximum(lengths, 1)[:, None]
    assert got.dtype == torch.float32
    _assert_sums_close(got, want, scale)


def test_offsets_embedding_bag_edges():
    """Positions before offsets[0] belong to no bag; ``mode`` is checked."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = temb.embedding_bag(table, [5, 1, 2, 3], [2, 3], 2)
    assert got.tolist() == [[4.0, 5.0], [6.0, 7.0]]
    want = jemb.embedding_bag(jnp.asarray(table.numpy()), jnp.asarray([5, 1, 2, 3]),
                              jnp.asarray([2, 3]), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        temb.embedding_bag(table, [1], [0], 1, mode="max")


def test_embedding_lookup_matches_take():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((40, 5)).astype(np.float32)
    idx = rng.integers(0, 40, (3, 7)).astype(np.int32)
    got = temb.embedding_lookup(torch.from_numpy(table), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take(jnp.asarray(table), idx,
                                                                   axis=0)))


def test_sharded_lookup_matches_reference():
    """(1, 1), as ``tests/test_models.py::test_sharded_lookup_matches_take``:
    the port's shard_map'd lookup against the reference's, bit for bit."""
    from repro.parallel import compat as jcompat
    from repro_torch.parallel.compat import StackedMesh
    rng = np.random.default_rng(4)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    idx = rng.integers(0, 64, 16).astype(np.int32)
    jmesh = jcompat.make_mesh((1, 1), ("data", "model"))
    with jcompat.use_mesh(jmesh):
        want = np.asarray(jemb.sharded_lookup_shardmap(jmesh, jnp.asarray(table),
                                                       jnp.asarray(idx)))
    got = temb.sharded_lookup_shardmap(StackedMesh((1, 1), device="cpu"), table, idx)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, table[idx])


@pytest.mark.parametrize("shape,batch_axis,dtype", [
    ((2, 4), "data", torch.float32), ((4, 2), "data", torch.float32),
    ((1, 8), None, torch.float32), ((2, 4), "data", torch.bfloat16)])
def test_stacked_sharded_lookup_equals_index_select(shape, batch_axis, dtype):
    """Rows sharded over "model", the batch over ``batch_axis``, every
    partition on the CPU: exactly ``index_select`` (one shard owns each
    row, the others add zeros)."""
    from repro_torch.parallel import compat
    rng = np.random.default_rng(sum(shape))
    table = torch.from_numpy(rng.standard_normal((96, 6)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 96, (8, 3)).astype(np.int32))
    mesh = compat.StackedMesh(shape, device="cpu")
    with compat.use_mesh(mesh):
        got = temb.sharded_lookup_shardmap(None, table, idx, batch_axis=batch_axis)
    want = temb.embedding_lookup(table, idx)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16 else got.view(torch.int32),
                       want.view(torch.int16) if dtype == torch.bfloat16 else want.view(torch.int32))


def test_layer_norm_and_mlp_stack_match_reference():
    """f32 on both sides; the population variance (``jnp.var``). rtol/atol
    1e-6: the same f32 arithmetic, reductions in other orders."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 5, 24)) * 3 + 1).astype(np.float32)
    g, b = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tcommon.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    dims = (24, 16, 8, 3)
    jdefs, tdefs = jcommon.mlp_stack_defs(dims, jnp.float32), tcommon.mlp_stack_defs(
        dims, torch.float32)
    assert sorted(jdefs) == sorted(tdefs)
    assert all(jdefs[k].shape == tdefs[k].shape and jdefs[k].axes == tdefs[k].axes
               and jdefs[k].init == tdefs[k].init for k in jdefs)
    p = {k: rng.standard_normal(d.shape).astype(np.float32) for k, d in jdefs.items()}
    want = jcommon.mlp_stack({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tcommon.mlp_stack({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
