"""The recsys serve and retrieval cells' sharded functions
(``cell.build(mesh)``, :func:`repro_torch.models.recsys.sharded_cell_fn`),
on the CPU.

* Against the reference: the four reduced archs × ``serve_p99``,
  ``serve_bulk``, ``retrieval_cand`` (12 cases). The same seeded numpy
  parameters and inputs (``tests/torch_mesh_ranks.py::serve_inputs``, the
  port's through ``models/weights.py``) go through the reference's
  ``cell.fn`` jitted with the cell's ``in_shardings`` on an 8-host-device
  (2, 2, 2) (pod, data, model) mesh, in one subprocess as
  ``tests/test_distributed.py`` runs it, and through the port's sharded
  function on a stacked (2, 2, 2) mesh. Tolerances as
  ``tests/test_torch_cells.py``'s: logits and top-k values RECSYS_TOL
  (``rtol=atol=1e-5``), ids equal but where the two values lie within it;
  retrieval values within TOPK_TOL·Σ_d|u_d·c_d| (2e-6), ids equal but where
  the two rows' exact scores lie within twice that.
* Against the unsharded port: the same 12 cases on a stacked (2, 2) mesh
  against the plain ``cell.fn``. Ids equal; values bitwise, except where
  the sharded K6 sums a bag in another order (fm's first-order term, the
  fm and dcn-v2 user vectors): there within the two orders' bound,
  2·(F-1)·2⁻²⁴·Σ_f|row_f| a dimension, carried through what follows
  (:func:`_bag_tol`).
* Stacked against ranks: a (2, 2) rank mesh over 4 gloo processes (one
  subprocess, ``tests/torch_mesh_ranks.py sharded_serve 4``) gives every
  cell's outputs bit for bit as the stacked (2, 2) mesh, on every rank.
* Refusals: a batch that the batch axes do not divide, or a table whose
  rows ``model`` does not divide, raises; nothing is padded.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.models.recsys import _flat_ids
from repro_torch.parallel import compat
from repro_torch.parallel.compat import StackedMesh

ROOT = Path(__file__).resolve().parents[1]
RECSYS_TOL = dict(rtol=1e-5, atol=1e-5)
TOPK_TOL = 2e-6
U = 2.0 ** -24                     # f32's unit roundoff
CASES = ranks.SERVE_CELLS
IDS = [f"{a}-{s}" for a, s in CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def _leaves(out) -> list:
    return [t.numpy() for t in (out if isinstance(out, tuple) else (out,))]


def _flat(tree) -> list:
    """Leaves of nested dicts (sorted keys) and tuples, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _stacked(shape, names=("data", "model")):
    return StackedMesh(shape, names, device="cpu")


def _sharded(arch, shape, mesh, *, multi_pod=False):
    cell, cfg, args = ranks.serve_inputs(arch, shape, multi_pod=multi_pod)
    targs = ranks.serve_args_on(cfg, args)
    return cell, cfg, args, targs, cell.build(mesh)[0](*targs)


# -- against the reference ---------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import build_cells, get_arch
from repro.models import recsys as jr
from repro.parallel import compat
workdir = sys.argv[1]
mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {}
for arch, shape in json.loads(open(workdir + "/cases.json").read()):
    cell = build_cells(arch, multi_pod=True, reduced=True)[shape]
    data = np.load(f"{workdir}/{arch}__{shape}.npz")
    leaves, treedef = jax.tree_util.tree_flatten(cell.args)
    args = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(data[f"x{i}"], dtype=l.dtype) for i, l in enumerate(leaves)])
    sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), cell.in_specs,
                                is_leaf=lambda x: isinstance(x, P))
    with compat.use_mesh(mesh):
        res = jax.jit(cell.fn, in_shardings=sh)(*args)
    for i, r in enumerate(jax.tree_util.tree_leaves(res)):
        out[f"{arch}/{shape}/{i}"] = np.asarray(r)
    if cell.kind == "retrieval":
        cfg = get_arch(arch).reduced_config()
        out[f"{arch}/{shape}/u"] = np.asarray(jr.user_vector(args[0], args[1], cfg))
np.savez(workdir + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 12 jitted, sharded cells on (2, 2, 2), in one
    subprocess with 8 host devices."""
    workdir = tmp_path_factory.mktemp("sharded_serve_reference")
    for arch, shape in CASES:
        _, _, args = ranks.serve_inputs(arch, shape, multi_pod=True)
        np.savez(workdir / f"{arch}__{shape}.npz",
                 **{f"x{i}": a for i, a in enumerate(_flat(args))})
    (workdir / "cases.json").write_text(json.dumps(CASES))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(workdir)],
                       capture_output=True, text=True, timeout=600,
                       env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(workdir / "reference.npz"))


def _ids_within(gi, wi, gv, wv, tol):
    """Ids equal at each rank, but where the two values lie within ``tol``."""
    for r in zip(*np.nonzero(gi != wi)):
        assert abs(float(gv[r]) - float(wv[r])) <= float(np.broadcast_to(tol, gv.shape)[r]), r


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_sharded_cell_matches_reference(arch, shape, reference):
    mesh = _stacked((2, 2, 2), ("pod", "data", "model"))
    cell, cfg, args, _, out = _sharded(arch, shape, mesh, multi_pod=True)
    got = _leaves(out)
    want = [reference[f"{arch}/{shape}/{i}"] for i in range(len(got))]
    assert [g.shape for g in got] == [w.shape for w in want]
    if cell.kind == "retrieval":
        (gv, gi), (wv, wi) = got, want
        assert gi.dtype == np.int32
        u = reference[f"{arch}/{shape}/u"][0].astype(np.float64)
        c = args[2].astype(np.float64)
        tol = TOPK_TOL * np.abs(c[wi] * u).sum(-1)
        assert (np.abs(gv.astype(np.float64) - wv) <= tol).all()
        exact = c @ u
        for r in np.flatnonzero(gi != wi):
            assert abs(exact[gi[r]] - exact[wi[r]]) <= 2 * tol[r], r
    elif cfg.kind == "bert4rec":
        (gv, gi), (wv, wi) = got, want
        np.testing.assert_allclose(gv, wv, **RECSYS_TOL)
        _ids_within(gi, wi, gv, wv, RECSYS_TOL["atol"] + RECSYS_TOL["rtol"] * np.abs(wv))
    else:
        np.testing.assert_allclose(got[0], want[0], **RECSYS_TOL)


# -- against the unsharded port ------------------------------------------------------


def _bag_tol(table: torch.Tensor, ids: torch.Tensor) -> np.ndarray:
    """Two orders of a K6 bag's F-term sum differ by at most
    2·(F-1)·2⁻²⁴·Σ_f|row_f| in each dimension: (B, D)."""
    rows = table.double()[ids.long()].abs().sum(1)
    return (2 * (ids.shape[1] - 1) * U * rows).numpy()


def _unsharded_tol(cell, cfg, targs, want) -> np.ndarray:
    """The bound on |sharded − unsharded| where the sharded K6 sums in
    another order. fm's logit: the first-order term's bound, plus 2⁻²² of
    the logit's terms for the two adds after it. A retrieval score: each
    user vector dimension's bound δu_d (dcn-v2's mean: δu_d / F and the
    division's rounding, 2⁻²³·|u_d|), as Σ_d |c_d|·δu_d, plus the two
    D-term dots' rounding, 2·γ_D·Σ_d|u_d·c_d|."""
    params, batch = targs[:2]
    ids = _flat_ids(cfg, batch["sparse"])
    if cell.kind == "serve":                       # fm
        terms = (params["bias"].double().abs() + params["linear"].double()[ids.long()]
                 .abs().sum((1, 2))).numpy() + np.abs(want[0])
        return _bag_tol(params["linear"], ids)[:, 0] + 4 * U * terms
    u = params["emb"].double()[ids.long()].sum(1)[0].numpy()
    du = _bag_tol(params["emb"], ids)[0]
    if cfg.kind == "dcn":
        u, du = u / cfg.n_sparse, du / cfg.n_sparse + 2 * U * np.abs(u / cfg.n_sparse)
    c = targs[2].double().numpy()[want[1]]
    D = c.shape[1]
    gamma = D * U / (1 - D * U)
    return np.abs(c) @ du + 2 * gamma * (np.abs(c) @ (np.abs(u) + du))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_sharded_cell_matches_unsharded_port(arch, shape):
    cell, cfg, _, targs, out = _sharded(arch, shape, _stacked((2, 2)))
    got, want = _leaves(out), _leaves(cell.fn(*targs))
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    if cell.kind == "retrieval" or cfg.kind == "bert4rec":
        assert np.array_equal(got[1], want[1])                     # ids
    pooled = cfg.kind in ("fm", "dcn") and (cell.kind == "retrieval" or cfg.kind == "fm")
    if not pooled:
        assert all(np.array_equal(_bits(g), _bits(w)) for g, w in zip(got, want))
        return
    tol = _unsharded_tol(cell, cfg, targs, want)
    assert (np.abs(got[0].astype(np.float64) - want[0]) <= tol).all()


# -- stacked against ranks, refusals --------------------------------------------------


def test_rank_mesh_serving_equals_stacked(tmp_path):
    """(2, 2) over 4 gloo ranks == the stacked (2, 2) mesh, bitwise, every
    cell, on every rank."""
    stacked = ranks.sharded_serve_outputs(_stacked((2, 2)))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                        "sharded_serve", "4", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for rank in range(4):
        out = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert sorted(out) == sorted(stacked)
        for key, want in stacked.items():
            assert out[key].shape == want.shape and np.array_equal(
                _bits(out[key]), _bits(want)), (rank, key)


@pytest.mark.parametrize("mesh_shape,what", [((3, 2), "batch"), ((2, 5), "table")])
def test_uneven_splits_are_refused(mesh_shape, what):
    """fm's reduced serve_p99: a batch of 8 over data = 3, or 768 table rows
    over model = 5, raises before anything runs."""
    cell, cfg, args = ranks.serve_inputs("fm", "serve_p99")
    fn = cell.build(_stacked(mesh_shape))[0]
    with pytest.raises(ValueError, match="does not split"):
        fn(*ranks.serve_args_on(cfg, args))
    assert (cfg.n_sparse * cfg.rows_per_field % mesh_shape[1] != 0) == (what == "table")


def test_sharded_bag_matches_the_unsharded_bag():
    """``sharded_bag_local`` over a stacked (2, 2) mesh (its one K6 call
    the twin on the CPU): the unsharded bag's sum within the two orders'
    bound; 5 bags over data = 2 are refused."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.embedding import sharded_bag_local
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, (5, 6)).astype(np.int32))
    mesh = _stacked((2, 2))
    fn = compat.shard_map(lambda t, i: sharded_bag_local(t, i), mesh,
                          in_specs=(compat.P("model", None), compat.P("data", None)),
                          out_specs=compat.P("data"))
    with pytest.raises(ValueError):            # 5 bags over data = 2
        fn(table, ids)
    ids = ids[:4]
    got = fn(table, ids)
    want = kops.embedding_bag(table, ids, torch.ones(ids.shape))
    assert (np.abs(got.double().numpy() - want.double().numpy()) <= _bag_tol(table, ids)).all()
