"""The dense LMs' prefill and decode cells' sharded functions
(``cell.build(mesh)``, :func:`repro_torch.models.transformer.sharded_cell_fn`),
on the CPU.

* Against the reference: starcoder2-3b's, stablelm-3b's and
  h2o-danube-1.8b's reduced ``prefill_32k`` and ``decode_32k``, and
  h2o-danube-1.8b's ``long_500k`` (7 cases). The same seeded numpy
  parameters and inputs (``tests/torch_mesh_ranks.py::lm_inputs``) go
  through the reference's ``cell.fn`` jitted with the cell's
  ``in_shardings`` on a 4-host-device (2, 2) mesh, in one subprocess, and
  through the port's sharded function on a stacked (2, 2) mesh: logits and
  caches at LM_TOL (``rtol=atol=1e-4``, ``tests/test_torch_cells.py``'s).
  The decodes run at LM_POS: one sequence shard full and one partial
  (decode_32k), the ring past its wrap (long_500k).
* Against the unsharded port, on stacked meshes that split a head: (1, 4)
  and (1, 8) (half a head of ``wq`` a shard at 8, a quarter of ``wk``), and
  a six-head starcoder2 on (1, 4), 1.5 heads a shard; decodes at positions
  that leave full, partial and empty sequence shards together, and
  long_500k before and after its ring wraps. Logits and caches within
  :func:`~repro_torch.models.transformer.sharded_bound`; the next token's
  argmax equal, but where the unsharded top two lie within it.
* Stacked against ranks: a (2, 2) rank mesh over 4 gloo processes (one
  subprocess, ``tests/torch_mesh_ranks.py sharded_lm 4``) gives every
  cell's logits and cache bit for bit as the stacked (2, 2) mesh, on every
  rank: on the CPU K5 is its twin, row by row the same arithmetic in a
  call over any number of rows, and each decode partition is its own call.
* Refusals: a batch, a ring or heads that the axes do not divide raise;
  nothing is padded.
* Prefill to decode: the sharded prefill's cache, fed to the sharded
  decode with no reshard, gives the unsharded prefill-then-decode's logits.
"""

import dataclasses
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
from repro_torch.configs import get_arch
from repro_torch.configs.cells import lm_cells
from repro_torch.models.transformer import prefill_heads, sharded_bound
from repro_torch.parallel.compat import StackedMesh
from repro_torch.parallel.sharding import lm_rules

ROOT = Path(__file__).resolve().parents[1]
LM_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = ranks.LM_CELLS
IDS = [f"{a}-{s}" for a, s in CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


def _flat(tree) -> list:
    """Leaves of nested dicts (sorted keys) and tuples, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _stacked(shape):
    return StackedMesh(shape, ("data", "model"), device="cpu")


def _outputs(out) -> list:
    logits, cache = out
    return [logits.numpy(), cache["k"].numpy(), cache["v"].numpy()]


# -- against the reference ---------------------------------------------------------

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import build_cells
from repro.parallel import compat
workdir = sys.argv[1]
mesh = compat.make_mesh((2, 2), ("data", "model"))
out = {}
for arch, shape in json.loads(open(workdir + "/cases.json").read()):
    cell = build_cells(arch, reduced=True)[shape]
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
np.savez(workdir + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 7 jitted, sharded cells on (2, 2), in one subprocess
    with 4 host devices."""
    workdir = tmp_path_factory.mktemp("sharded_lm_reference")
    for arch, shape in CASES:
        _, _, args = ranks.lm_inputs(arch, shape)
        np.savez(workdir / f"{arch}__{shape}.npz",
                 **{f"x{i}": a for i, a in enumerate(_flat(args))})
    (workdir / "cases.json").write_text(json.dumps(CASES))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE), str(workdir)],
                       capture_output=True, text=True, timeout=600,
                       env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                                JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(workdir / "reference.npz"))


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_sharded_lm_cell_matches_reference(arch, shape, reference):
    cell, _, args = ranks.lm_inputs(arch, shape)
    got = _outputs(cell.build(_stacked((2, 2)))[0](*ranks.lm_args_on(args)))
    # the reference's leaves: logits, then the cache's k and v (sorted keys)
    for i, g in enumerate(got):
        want = reference[f"{arch}/{shape}/{i}"]
        assert g.shape == want.shape, (i, g.shape, want.shape)
        np.testing.assert_allclose(g, want, **LM_TOL)


# -- against the unsharded port ------------------------------------------------------


def _six_heads():
    """starcoder2-3b's reduced config with 6 heads of 16 (d 96): on a
    4-wide ``model`` axis each shard holds 1.5 heads of ``wq`` and half a
    kv head of ``wk``."""
    cfg = dataclasses.replace(get_arch("starcoder2-3b").reduced_config(), d_model=96, n_heads=6,
                              name="starcoder2-3b-six-heads")
    return cfg, lm_cells("starcoder2-3b", cfg, lm_rules(), reduced=True)


def _unsharded_cases():
    """(arch, shape, mesh, decode position): every cell on (1, 4) and
    (1, 8); decode_32k (64 slots) at 20, which leaves a full, a partial and
    empty sequence shards on both meshes; long_500k (16 slots) at 6, before
    its wrap, and at 21, after it; the six-head starcoder2 on (1, 4)."""
    out = []
    for arch, shape in CASES + [("six-heads", "prefill_32k"), ("six-heads", "decode_32k")]:
        positions = {"prefill_32k": [None], "decode_32k": [20], "long_500k": [6, 21]}[shape]
        meshes = [(1, 4)] if arch == "six-heads" else [(1, 4), (1, 8)]
        out += [(arch, shape, m, p) for m in meshes for p in positions]
    return out


UNSHARDED = _unsharded_cases()


def _cell_and_args(arch, shape, pos, seed=0):
    """The cell and its seeded arguments as the port's tensors."""
    if arch != "six-heads":
        cell, cfg, args = ranks.lm_inputs(arch, shape, pos=pos, seed=seed)
        return cell, cfg, args
    from repro_torch.models.transformer import lm_param_defs
    cfg, cells = _six_heads()
    cell = cells[shape]
    defs = lm_param_defs(cfg)
    params = ranks._nested(defs, ranks.numpy_params(defs, seed))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (2, 64 if cell.kind == "prefill" else 1)).astype(np.int32)
    if cell.kind == "prefill":
        return cell, cfg, (params, tokens)
    cache = {k: np.abs(rng.standard_normal(tuple(cell.args[1][k].shape)) * 0.05
                       ).astype(np.float32) for k in sorted(cell.args[1])}
    return cell, cfg, (params, cache, tokens, np.int32(pos))


def _within(cfg, cell, mesh, got, want) -> None:
    """Logits and caches within :func:`sharded_bound` of the unsharded run;
    the argmax equal, but where the unsharded top two lie within it."""
    for name, g, w in zip(("logits", "k", "v"), got, want):
        tol = sharded_bound(cfg, cell.kind, mesh, cell.in_specs, torch.from_numpy(w))
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= tol, (name, err, tol)
        if name == "logits":
            top2 = np.sort(w, -1)[:, -2:]
            close = top2[:, 1] - top2[:, 0] <= tol
            assert ((g.argmax(-1) == w.argmax(-1)) | close).all()


@pytest.mark.parametrize("arch,shape,mesh_shape,pos", UNSHARDED,
                         ids=[f"{a}-{s}-{m[0]}x{m[1]}" + ("" if p is None else f"-pos{p}")
                              for a, s, m, p in UNSHARDED])
def test_sharded_lm_cell_matches_unsharded_port(arch, shape, mesh_shape, pos):
    cell, cfg, args = _cell_and_args(arch, shape, pos)
    mesh = _stacked(mesh_shape)
    if mesh_shape == (1, 8) or arch == "six-heads":     # a shard's wq columns split a head
        assert (cfg.n_heads * cfg.dh // mesh_shape[1]) % cfg.dh
    if arch == "six-heads":
        assert prefill_heads(cfg, 4) == (24, 2)
    got = _outputs(cell.build(mesh)[0](*ranks.lm_args_on(args)))
    want = _outputs(cell.fn(*ranks.lm_args_on(args)))
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    _within(cfg, cell, mesh, got, want)


def test_prefill_cache_feeds_the_sharded_decode():
    """h2o-danube-1.8b (ring of 16 slots) and starcoder2-3b: the sharded
    prefill's cache, with no reshard, into the sharded decode at the next
    position (past h2o's wrap, and starcoder2's ring of 64 wrapping to slot
    0), against the unsharded prefill and decode, on (1, 4)."""
    mesh = _stacked((1, 4))
    for arch in ("h2o-danube-1.8b", "starcoder2-3b"):
        pre, cfg, args = ranks.lm_inputs(arch, "prefill_32k")
        dec = ranks.lm_inputs(arch, "decode_32k")[0]
        params, tokens = ranks.lm_args_on(args)
        outs = []
        for prefill, decode in ((pre.build(mesh)[0], dec.build(mesh)[0]), (pre.fn, dec.fn)):
            logits, cache = prefill(params, tokens)
            nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
            outs.append(decode(params, cache, nxt, torch.tensor(tokens.shape[1]))[0])
        got, want = outs[0].numpy(), outs[1].numpy()
        # the decode's bound, over the partials of both steps
        tol = 2 * sharded_bound(cfg, "decode", mesh, dec.in_specs, outs[1])
        assert float(np.abs(got - want).max()) <= tol


# -- stacked against ranks, refusals --------------------------------------------------


def test_rank_mesh_sharded_lm_equals_stacked(tmp_path):
    """(2, 2) over 4 gloo ranks == the stacked (2, 2) mesh, bitwise, every
    cell, on every rank; the collectives too."""
    stacked = ranks.sharded_lm_outputs(_stacked((2, 2)))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                        "sharded_lm", "4", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for rank in range(4):
        out = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert sorted(out) == sorted(stacked)
        for key, want in stacked.items():
            got = out[key]
            same = (np.array_equal(got.view(np.int32), want.view(np.int32))
                    if want.dtype == np.float32 else np.array_equal(got, want))
            assert got.shape == want.shape and same, (rank, key)


@pytest.mark.parametrize("arch,shape,mesh_shape,what", [
    ("starcoder2-3b", "prefill_32k", (3, 1), "batch"),
    ("starcoder2-3b", "decode_32k", (1, 3), "heads"),
    ("h2o-danube-1.8b", "prefill_32k", (1, 32), "ring"),
    ("h2o-danube-1.8b", "long_500k", (8, 4), "ring")])
def test_uneven_splits_are_refused(arch, shape, mesh_shape, what):
    """A batch of 2 over data = 3; 64 wq columns over model = 3; h2o's ring
    of 16 slots over model = 32 (its prefill's cache) or over (data, model)
    = 32 (long_500k): each raises before anything runs."""
    cell, cfg, args = ranks.lm_inputs(arch, shape, pos=3)
    fn = cell.build(_stacked(mesh_shape))[0]
    with pytest.raises(ValueError, match="does not split"):
        fn(*ranks.lm_args_on(args))
    heads = cfg.n_heads * cfg.dh % mesh_shape[1] != 0
    assert heads == (what == "heads")


def test_sharded_cells_refuse_other_layouts():
    """The MoE and MLA LMs' cells keep no sharded build; FSDP specs are
    refused."""
    from repro_torch.configs import build_cells
    from repro_torch.models.transformer import sharded_cell_fn
    for arch in ("olmoe-1b-7b", "deepseek-v2-236b"):
        assert not any(hasattr(c, "build") for c in build_cells(arch, reduced=True).values())
    cfg = get_arch("stablelm-3b").reduced_config()
    cell = lm_cells("stablelm-3b", cfg, lm_rules(fsdp=True), reduced=True)["prefill_32k"]
    with pytest.raises(ValueError, match="FSDP"):
        sharded_cell_fn(cfg, "prefill", _stacked((2, 2)), cell.in_specs)
