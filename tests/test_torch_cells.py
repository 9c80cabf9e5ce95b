"""The port's cell builders against the JAX package's, on the CPU.

* Every reduced cell of ``build_cells`` (the ten assigned architectures ×
  four shapes, on both mesh kinds, plus anlessini's two, bound to a 1 × 1
  mesh): the same ``kind``, ``donate``, ``skip`` and ``note``, and leaf for
  leaf the same argument shapes, dtypes and partition specs.
* The port's analogue of ``tests/test_system.py::test_smoke_cell``: every
  reduced cell runs materialized (parameters and batches from numpy): a
  train cell's loss is finite, its parameters finite and its first leaf
  moved; any other cell's outputs are finite, with the shapes of the same
  function traced on the cell's meta arguments.
* One cell of each (family × kind), and anlessini's ``serve_q1``: the same
  numpy inputs through the reference's ``cell.fn`` (under ``jax.jit``) and
  the port's, at the tolerances the port's tests of those functions use:
  LM logits and caches ``rtol=atol=1e-4`` (``test_torch_lm.py``); a train
  step's loss and gradient norm ``rtol=1e-4`` (``test_torch_train.py``'s
  steps); recsys logits ``rtol=atol=1e-5`` and top-k values within
  ``2e-6·Σ_d|u_d·c_d|`` (``test_torch_recsys.py``); search scores
  ``rtol=1e-6`` with ids equal but inside tied scores (``test_torch_mesh.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.parallel import compat as jcompat
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.configs.cells import CellSpec
from repro_torch.models.common import tree_leaves
from repro_torch.parallel.compat import StackedMesh
from repro_torch.train import steps as tsteps

LM_TOL = dict(rtol=1e-4, atol=1e-4)
STEP_RTOL = 1e-4
RECSYS_TOL = dict(rtol=1e-5, atol=1e-5)
TOPK_TOL = 2e-6
SEARCH_RTOL = 1e-6

ALL = [(arch, shape) for arch in tconfigs.ASSIGNED
       for shape in tconfigs.build_cells(arch, reduced=True)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread keeps these tests from crowding
    the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tleaves(tree) -> list:
    """The port's leaves of nested dicts and tuples, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tleaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields") \
            and type(tree).__name__ != "P":
        return [x for t in tree for x in _tleaves(t)]
    return [tree]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_unflatten(t, it) for t in tree)
    return next(it)


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


def _jspecs(specs) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))]


def _compare(jcell, tcell, jargs, jspecs, targs, tspecs):
    assert (tcell.kind, tcell.donate, tcell.skip, tcell.note) == (
        jcell.kind, tuple(jcell.donate), jcell.skip, jcell.note)
    jl, tl = jax.tree_util.tree_leaves(jargs), _tleaves(targs)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [_dtype(t) for t in tl] == [str(j.dtype) for j in jl]
    assert all(t.device.type == "meta" for t in tl)
    assert [tuple(s) for s in _tleaves(tspecs)] == _jspecs(jspecs)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ASSIGNED)
def test_reduced_cells_match_reference(arch, multi_pod):
    jcells = jconfigs.build_cells(arch, multi_pod=multi_pod, reduced=True)
    tcells = tconfigs.build_cells(arch, multi_pod=multi_pod, reduced=True)
    assert list(tcells) == list(jcells)
    for shape, jcell in jcells.items():
        tcell = tcells[shape]
        assert isinstance(tcell, CellSpec) and tcell.name == f"{arch}/{shape}"
        _compare(jcell, tcell, jcell.args, jcell.in_specs, tcell.args, tcell.in_specs)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_anlessini_cells_match_reference(multi_pod):
    jcells = jconfigs.build_cells("anlessini", multi_pod=multi_pod, reduced=True)
    tcells = tconfigs.build_cells("anlessini", multi_pod=multi_pod, reduced=True)
    assert list(tcells) == list(jcells) == ["serve_q1", "serve_q64"]
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    jmesh = jcompat.make_mesh((1,) * len(names), names)
    tmesh = StackedMesh((1,) * len(names), names, device="cpu")
    for shape, jcell in jcells.items():
        tcell = tcells[shape]
        _, jargs, jspecs = jcell.build(jmesh)
        _, targs, tspecs = tcell.build(tmesh)
        _compare(jcell, tcell, jargs, jspecs, targs, tspecs)
    assert set(jconfigs.ASSIGNED) == set(tconfigs.ASSIGNED) and len(tconfigs.ASSIGNED) == 10
    assert list(tconfigs.all_cells(reduced=True)) == list(jconfigs.all_cells(reduced=True))


# -- materialized cells ---------------------------------------------------------------


def _numpy_leaves(abstract: list, seed: int, *, params: bool) -> list:
    """``tests/test_system.py``'s materialisation, from numpy: parameters
    normal × 0.05; batch integers in [0, 4), floats |normal × 0.05|."""
    rng = np.random.default_rng(seed)
    out = []
    for t in abstract:
        shape = tuple(t.shape)
        if not t.is_floating_point():
            out.append(rng.integers(0, 4, shape).astype(np.int32))
        elif params:
            out.append((rng.standard_normal(shape) * 0.05).astype(np.float32))
        else:
            out.append(np.abs(rng.standard_normal(shape) * 0.05).astype(np.float32))
    return out


def _torch_tree(abstract_tree, arrays):
    leaves = _tleaves(abstract_tree)
    it = iter(torch.tensor(a, dtype=t.dtype) for a, t in zip(arrays, leaves))
    return _unflatten(abstract_tree, it)


def _materialize(cell, args, seed: int = 0):
    """(numpy leaves per argument, the port's tensors) of a cell's args;
    a train cell's first argument is its parameters alone."""
    out_np, out_t = [], []
    for i, a in enumerate(args):
        tree = a["params"] if (cell.kind == "train" and i == 0) else a
        arrays = _numpy_leaves(_tleaves(tree), seed + 100 * i, params=i == 0)
        out_np.append(arrays)
        t = _torch_tree(tree, arrays)
        out_t.append(tsteps.init_train_state(t) if (cell.kind == "train" and i == 0) else t)
    return out_np, out_t


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in _tleaves(tree)
               if isinstance(t, torch.Tensor) and t.is_floating_point())


@pytest.mark.parametrize("arch,shape", ALL, ids=[f"{a}-{s}" for a, s in ALL])
def test_smoke_cell(arch, shape):
    cell = tconfigs.build_cells(arch, reduced=True)[shape]
    if cell.skip:
        # the reference's smoke test skips these: they stay inapplicable here
        assert cell.fn is None and cell.args == () and "full-attention" in cell.note
        return
    _, args = _materialize(cell, cell.args)
    if cell.kind == "train":
        state, batch = args
        before = tree_leaves(state["params"])[0].clone()
        new_state, metrics = cell.fn(state, batch)
        assert np.isfinite(float(metrics["loss"])), metrics
        assert _finite(new_state["params"])
        assert not torch.allclose(before, tree_leaves(new_state["params"])[0])
        want = cell.fn(*cell.args)
        got_leaves, want_leaves = _tleaves(new_state), _tleaves(want[0])
    else:
        out = cell.fn(*args)
        assert _finite(out)
        want = cell.fn(*cell.args)        # the same function on the meta arguments
        got_leaves, want_leaves = _tleaves(out), _tleaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype, (g.shape, w.shape)


# -- one cell of each (family × kind) against the reference ---------------------------


def _both(arch, shape, seed=0):
    jcell = jconfigs.build_cells(arch, reduced=True)[shape]
    tcell = tconfigs.build_cells(arch, reduced=True)[shape]
    arrays, targs = _materialize(tcell, tcell.args, seed)
    jargs = []
    for i, (a, nps) in enumerate(zip(jcell.args, arrays)):
        tree = a["params"] if (jcell.kind == "train" and i == 0) else a
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        j = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x, dtype=l.dtype) for x, l in zip(nps, leaves)])
        jargs.append(jsteps.init_train_state(j) if (jcell.kind == "train" and i == 0) else j)
    return jcell, tcell, jargs, targs


def _close(got, want, **tol):
    gl, wl = _tleaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("arch,shape", [("h2o-danube-1.8b", "train_4k"),
                                        ("graphcast", "full_graph_sm"),
                                        ("fm", "train_batch")])
def test_train_cells_match_reference(arch, shape):
    jcell, tcell, jargs, targs = _both(arch, shape)
    _, jm = jax.jit(jcell.fn)(*jargs)
    _, tm = tcell.fn(*targs)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=STEP_RTOL)
    assert int(tm["step"]) == int(jm["step"]) == 1


def test_lm_prefill_and_decode_cells_match_reference():
    jcell, tcell, jargs, targs = _both("h2o-danube-1.8b", "prefill_32k", seed=1)
    jlogits, jcache = jax.jit(jcell.fn)(*jargs)
    tlogits, tcache = tcell.fn(*targs)
    _close(tlogits, jlogits, **LM_TOL)
    _close(tcache, jcache, **LM_TOL)
    jcell, tcell, jargs, targs = _both("h2o-danube-1.8b", "decode_32k", seed=2)
    jlogits, jcache = jax.jit(jcell.fn)(*jargs)
    tlogits, tcache = tcell.fn(*targs)
    _close(tlogits, jlogits, **LM_TOL)
    _close(tcache, jcache, **LM_TOL)


def test_recsys_serve_cell_matches_reference():
    jcell, tcell, jargs, targs = _both("dcn-v2", "serve_p99", seed=3)
    _close(tcell.fn(*targs), jax.jit(jcell.fn)(*jargs), **RECSYS_TOL)


def test_recsys_retrieval_cell_matches_reference():
    """The reference's cell ranks with ``lax.top_k``, the port's with K4's
    twin: values within TOPK_TOL·Σ_d|u_d·c_d| at each rank, ids equal but
    where the two rows' exact scores lie within it."""
    from repro.models import recsys as jr
    jcell, tcell, jargs, targs = _both("fm", "retrieval_cand", seed=4)
    wv, wi = jax.jit(jcell.fn)(*jargs)
    gv, gi = tcell.fn(*targs)
    assert gi.dtype == torch.int32 and tuple(gv.shape) == tuple(wv.shape)
    jcfg = jconfigs.get_arch("fm").reduced_config()
    u = np.asarray(jr.user_vector(jargs[0], jargs[1], jcfg), np.float64)[0]
    c = np.asarray(jargs[2], np.float64)
    wv, wi = np.asarray(wv, np.float64), np.asarray(wi)
    tol = TOPK_TOL * np.abs(c[wi] * u).sum(-1)
    assert (np.abs(gv.double().numpy() - wv) <= tol).all()
    exact = c @ u
    for r in np.flatnonzero(gi.numpy() != wi):
        assert abs(exact[gi[r]] - exact[wi[r]]) <= 2 * tol[r]


def _search_state(cfg, seed: int):
    """A consistent partitioned index of ``cfg``'s shapes, from numpy:
    sorted term offsets, docs in [0, n_docs] (n_docs = pad), tf, lengths."""
    rng = np.random.default_rng(seed)
    Pn, NB, B, V, n = cfg.n_parts, cfg.n_blocks_local, cfg.block, cfg.vocab, cfg.n_docs_local
    offsets = np.sort(rng.integers(0, NB + 1, (Pn, V + 1)), axis=1).astype(np.int32)
    offsets[:, 0], offsets[:, -1] = 0, NB
    docs = rng.integers(0, n + 1, (Pn, NB, B)).astype(np.int32)
    tf = np.where(docs < n, rng.integers(1, 6, (Pn, NB, B)), 0).astype(np.uint8)
    return {"term_offsets": offsets, "block_docs": docs, "block_tf": tf,
            "block_max": rng.uniform(0.5, 4.0, (Pn, NB)).astype(np.float32),
            "doc_len": rng.uniform(5.0, 60.0, (Pn, n + 1)).astype(np.float32),
            "idf": rng.uniform(0.1, 5.0, V).astype(np.float32),
            "params": np.array([0.9, 0.4, 30.0], np.float32)}


def test_anlessini_serve_q1_cell_matches_reference():
    jcell = jconfigs.build_cells("anlessini", reduced=True)["serve_q1"]
    tcell = tconfigs.build_cells("anlessini", reduced=True)["serve_q1"]
    jfn, jargs, _ = jcell.build(jcompat.make_mesh((1, 1), ("data", "model")))
    tmesh = StackedMesh((1, 1), device="cpu")
    tfn, targs, _ = tcell.build(tmesh)
    from repro_torch.configs.anlessini import reduced_config
    state = _search_state(reduced_config(1), seed=5)
    rng = np.random.default_rng(6)
    Q, T = targs[1].shape
    tids = rng.integers(0, reduced_config(1).vocab, (Q, T)).astype(np.int32)
    qtf = rng.integers(1, 3, (Q, T)).astype(np.float32)
    with jcompat.use_mesh(jcompat.make_mesh((1, 1), ("data", "model"))):
        wv, wi = jax.jit(jfn)({k: jnp.asarray(v) for k, v in state.items()},
                              jnp.asarray(tids), jnp.asarray(qtf))
    gv, gi = tfn({k: torch.from_numpy(v) for k, v in state.items()}, tids, qtf)
    wv, wi = np.asarray(wv), np.asarray(wi)
    np.testing.assert_allclose(gv.numpy(), wv, rtol=SEARCH_RTOL, atol=0)
    for q in range(Q):
        for r in np.flatnonzero(gi[q].numpy() != wi[q]):
            tied = np.abs(wv[q] - wv[q, r]) <= SEARCH_RTOL * abs(wv[q, r])
            assert tied.sum() > 1, (q, r)
