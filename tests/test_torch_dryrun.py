"""The port's dry run (``repro_torch.launch.dryrun``) and the kernels' meta
shape rules, on the CPU.

* Per-device ``argument_bytes`` of the reduced h2o-danube-1.8b
  ``train_4k`` cell on a (2, 2, 2) (pod, data, model) mesh and of the
  reduced stablelm-3b ``train_4k`` on (4, 2) equal the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` — the reference
  compiled in one subprocess with 8 host devices, as
  ``tests/test_distributed.py`` runs it.
* ``python -m repro_torch.launch.dryrun --reduced`` with JAX unimportable:
  exit 0, one record a cell and mesh with the reference's keys, nothing
  written under ``benchmarks/``.
* Each wrapper of the six kernels on meta tensors returns its twin's
  shapes and dtypes (the twin run on the CPU at the same shapes), including
  k > n and padded slots, and records its cost.
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

from repro_torch.configs import build_cells
from repro_torch.kernels import backend
from repro_torch.kernels.bm25_block import bm25_block_impacts, bm25_block_scores
from repro_torch.kernels.bm25_pruned import bm25_pruned_topk
from repro_torch.kernels.dot_topk import dot_topk, dot_topk_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.topk import topk
from repro_torch.launch import dryrun
from repro_torch.parallel.compat import StackedMesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"h2o-danube-1.8b": ((2, 2, 2), True), "stablelm-3b": ((4, 2), False)}
RECORD_KEYS = {"cell", "mesh", "ok", "kind", "compile_s", "per_device", "collectives"}
PER_DEVICE = {"flops", "bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes",
              "peak_bytes"}
COLLECTIVES = {"bytes_by_op", "counts", "total_bytes"}
SHARDED_SERVING = {f"{arch}/{shape}" for arch in ("fm", "dcn-v2", "bst", "bert4rec")
                   for shape in ("serve_p99", "serve_bulk", "retrieval_cand")}
DENSE_LM = {f"{arch}/{shape}" for arch in ("starcoder2-3b", "stablelm-3b", "h2o-danube-1.8b")
            for shape in ("prefill_32k", "decode_32k")} | {"h2o-danube-1.8b/long_500k"}
SERVE_MESHES = {"pod2": ((2, 2, 2), True), "pod1": ((4, 2), False)}
SERVE_BYTES_CELLS = (("dcn-v2", "serve_p99"), ("fm", "retrieval_cand"))

REFERENCE = """
import json, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import build_cells
from repro.parallel import compat
out = {}
for arch, (shape, multi_pod) in json.loads(%r).items():
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = compat.make_mesh(tuple(shape), names)
    cell = build_cells(arch, multi_pod=multi_pod, reduced=True)["train_4k"]
    sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), cell.in_specs,
                                is_leaf=lambda x: isinstance(x, P))
    with compat.use_mesh(mesh):
        compiled = jax.jit(cell.fn, in_shardings=sh, donate_argnums=cell.donate
                           ).lower(*cell.args).compile()
    out[arch] = int(compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_argument_bytes():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE % json.dumps(MESHES)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", sorted(MESHES))
def test_argument_bytes_match_reference(arch, reference_argument_bytes, tmp_path):
    shape, multi_pod = MESHES[arch]
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = StackedMesh(shape, names, device="meta")
    cell = build_cells(arch, multi_pod=multi_pod, reduced=True)["train_4k"]
    rec = dryrun.run_cell(f"{arch}/train_4k", cell, mesh, "test", tmp_path, verbose=False)
    assert rec["ok"], rec
    assert rec["per_device"]["argument_bytes"] == reference_argument_bytes[arch]
    assert rec["per_device"]["peak_bytes"] >= rec["per_device"]["argument_bytes"]
    assert rec["collectives"]["total_bytes"] > 0 and rec["devices"] == mesh.size


def test_reduced_dry_run_needs_no_jax_and_writes_the_reference_keys(tmp_path):
    before = sorted(p.relative_to(ROOT) for p in (ROOT / "benchmarks").rglob("*"))
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.modules["repro"] = None        # and so does any import of repro
        from repro_torch.launch import dryrun
        code = dryrun.main(["--reduced", "--out", sys.argv[1]])
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
        assert not bad, bad
        sys.exit(code)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    assert "failures: 0" in r.stdout
    from repro_torch.configs import all_cells
    for mesh_name, multi_pod in dryrun.MESHES:
        files = sorted((tmp_path / mesh_name).glob("*.json"))
        names = all_cells(multi_pod=multi_pod, reduced=True)
        assert [f.name for f in files] == sorted(n.replace("/", "__") + ".json" for n in names)
        for f in files:
            rec = json.loads(f.read_text())
            assert rec["mesh"] == mesh_name and rec["cell"] in names
            if rec.get("skip"):
                assert "full-attention" in rec["note"]
                continue
            assert RECORD_KEYS <= set(rec) and rec["ok"] is True, rec
            assert set(rec["per_device"]) == PER_DEVICE
            assert all(v >= 0 for v in rec["per_device"].values())
            assert "evenly" in rec["note"]
            if rec["kind"] == "train":
                assert "not the port's sharded step" in rec["note"]
            if rec["kind"] == "train" or rec["cell"].startswith("anlessini/"):
                assert set(rec["collectives"]) == COLLECTIVES
            elif rec["collectives"] is None:
                assert "no sharded implementation" in rec["note"]
            if rec["cell"] in SHARDED_SERVING:
                assert set(rec["collectives"]) == COLLECTIVES
                assert rec["collectives"]["total_bytes"] > 0
                assert dryrun.NO_SHARDED not in rec["note"]
                assert dryrun.MODEL_REPEATS in rec["note"]
            if rec["cell"] in DENSE_LM:
                assert set(rec["collectives"]) == COLLECTIVES
                assert rec["collectives"]["total_bytes"] > 0
                assert dryrun.NO_SHARDED not in rec["note"] and dryrun.LM_REPEATS in rec["note"]
        # the reduced MoE LMs route their experts without EP, so their LM
        # serving cells alone are left unsharded
        unsharded = {json.loads(f.read_text())["cell"] for f in files
                     if dryrun.NO_SHARDED in json.loads(f.read_text()).get("note", "")}
        assert not unsharded & DENSE_LM and all(
            c.split("/")[0] in ("olmoe-1b-7b", "deepseek-v2-236b")
            and c.split("/")[1] in ("prefill_32k", "decode_32k", "long_500k") for c in unsharded)
    assert sorted(p.relative_to(ROOT) for p in (ROOT / "benchmarks").rglob("*")) == before


SERVE_REFERENCE = """
import json, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import build_cells
from repro.parallel import compat
meshes, cells = json.loads(%r)
out = {}
for mesh_name, (shape, multi_pod) in meshes.items():
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = compat.make_mesh(tuple(shape), names)
    for arch, cell_shape in cells:
        cell = build_cells(arch, multi_pod=multi_pod, reduced=True)[cell_shape]
        sh = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), cell.in_specs,
                                    is_leaf=lambda x: isinstance(x, P))
        with compat.use_mesh(mesh):
            compiled = jax.jit(cell.fn, in_shardings=sh).lower(*cell.args).compile()
        out[f"{mesh_name} {arch}/{cell_shape}"] = int(
            compiled.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_serving_bytes():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", SERVE_REFERENCE % json.dumps(
        [SERVE_MESHES, SERVE_BYTES_CELLS])], capture_output=True, text=True, env=env,
        timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh_name", sorted(SERVE_MESHES))
@pytest.mark.parametrize("arch,shape", SERVE_BYTES_CELLS)
def test_serving_argument_bytes_match_reference(arch, shape, mesh_name,
                                                reference_serving_bytes, tmp_path):
    """The sharded serve and retrieval cells' records (traced through
    ``cell.build``) keep the reference's per-device argument bytes."""
    mesh_shape, multi_pod = SERVE_MESHES[mesh_name]
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = StackedMesh(mesh_shape, names, device="meta")
    cell = build_cells(arch, multi_pod=multi_pod, reduced=True)[shape]
    rec = dryrun.run_cell(f"{arch}/{shape}", cell, mesh, "test", tmp_path, verbose=False)
    assert rec["ok"], rec
    assert rec["per_device"]["argument_bytes"] == \
        reference_serving_bytes[f"{mesh_name} {arch}/{shape}"]
    assert set(rec["collectives"]) == COLLECTIVES and dryrun.UNEVEN not in rec["note"]


def test_serving_collectives_match_a_rank_mesh(tmp_path):
    """fm's reduced ``serve_p99`` and starcoder2-3b's reduced
    ``prefill_32k`` and ``decode_32k`` on a stacked (2, 2) meta mesh: the
    dry run's collectives are what compat counts on a (2, 2) rank mesh of
    4 gloo processes, on every rank. The LM cells' counts are their
    bodies': a prefill layer gathers k and v (and q, where a shard's
    columns split a head) and sums two row-parallel projections, a decode
    layer gathers q, k and v and the slices' (out, lse) and sums the same
    two; the embedding's psum, and the outputs' gathers, once a call."""
    cells = {"fm/serve_p99": build_cells("fm", reduced=True)["serve_p99"]}
    lm = build_cells("starcoder2-3b", reduced=True)
    cells.update({f"starcoder2-3b/{s}": lm[s] for s in ("prefill_32k", "decode_32k")})
    recs = {name: dryrun.run_cell(name, cell, StackedMesh((2, 2), device="meta"), "test",
                                  tmp_path, verbose=False) for name, cell in cells.items()}
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                        "serve_collectives", "4", str(tmp_path)], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert recs["fm/serve_p99"]["collectives"]["counts"] == {"all-reduce": 2, "all-gather": 1}
    layers = lm["prefill_32k"].fn.keywords["cfg"].n_layers
    # prefill: per layer 1 gather, 2 sums; the embedding's sum; logits' and
    # the cache's k and v gathers over data and model (2 each)
    assert recs["starcoder2-3b/prefill_32k"]["collectives"]["counts"] == {
        "all-reduce": 2 * layers + 1, "all-gather": layers + 6}
    # decode: per layer 2 gathers, 2 sums; the embedding's sum; logits over
    # data and model (2), the new k and v rows over data (1 each)
    assert recs["starcoder2-3b/decode_32k"]["collectives"]["counts"] == {
        "all-reduce": 2 * layers + 1, "all-gather": 2 * layers + 4}
    for rank in range(4):
        out = np.load(tmp_path / f"rank{rank}.npz")
        assert json.loads(str(out["collectives"])) == recs["fm/serve_p99"]["collectives"], rank
        for name in ("starcoder2-3b/prefill_32k", "starcoder2-3b/decode_32k"):
            got = json.loads(str(out[f"{name}/collectives"]))
            assert got == recs[name]["collectives"], (rank, name)


# -- the wrappers' shape rules on meta ---------------------------------------------------


def _same_form(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype, (g, w)


def _check(name, fn, cpu_args, kw=None):
    kw = kw or {}
    want = fn(*cpu_args, **kw)
    meta_args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in cpu_args)
    with backend.record_costs() as log:
        got = fn(*meta_args, **kw)
    _same_form(got, want)
    assert [c.name for c in log] == [name] and log[0].bytes > 0 and log[0].flops >= 0


@pytest.mark.parametrize("Q,N,k", [(1, 7, 3), (4, 5, 9), (3, 300, 10)])
def test_topk_meta_shapes(Q, N, k):
    s = torch.from_numpy(np.random.default_rng(0).standard_normal((Q, N)).astype(np.float32))
    s[0, : N // 2] = float("-inf")                       # padded slots
    _check("topk", topk, (s, k))
    _check("topk", topk, (s[0], k))


@pytest.mark.parametrize("Q,N,D,k", [(1, 50, 8, 5), (3, 7, 4, 12), (0, 10, 4, 3)])
def test_dot_topk_meta_shapes(Q, N, D, k):
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    _check("dot_topk_batch", dot_topk_batch, (q, c, k))
    if Q:
        _check("dot_topk_batch", dot_topk, (q[0], c, k))


@pytest.mark.parametrize("B,L,V,D,dtype", [(3, 4, 10, 6, torch.float32),
                                           (2, 1, 5, 3, torch.bfloat16)])
def test_embedding_bag_meta_shapes(B, L, V, D, dtype):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(-1, V, (B, L)).astype(np.int32))   # -1: padding
    w = torch.ones(B, L)
    _check("embedding_bag", embedding_bag, (table, idx, w))


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,Dv,causal,window,kv_len", [
    (1, 4, 2, 6, 6, 8, 8, True, None, None),
    (2, 2, 1, 1, 9, 4, 6, False, None, 5),
    (1, 3, 3, 5, 5, 8, 8, True, 3, None)])
def test_flash_attention_meta_shapes(B, Hq, Hkv, Sq, Skv, D, Dv, causal, window, kv_len):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Sq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, Hkv, Skv, Dv)).astype(np.float32))
    kw = dict(causal=causal, window=window, kv_len=kv_len)
    for lse in (False, True):              # with return_lse: (out, (B, Hq, Sq) f32 lse)
        kw["return_lse"] = lse
        _check("flash_attention", flash_attention, (q, k, v), kw)
        _check("flash_attention", flash_attention, (q.bfloat16(), k.bfloat16(), v.bfloat16()),
               kw)


def _blocks(Q, T, M, B, n_docs, seed=4):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, n_docs + 1, (Q, T, M, B)).astype(np.int32)    # n_docs: a pad
    tf = np.where(docs < n_docs, rng.integers(1, 5, docs.shape), 0).astype(np.uint8)
    return torch.from_numpy(tf), torch.from_numpy(docs), rng


@pytest.mark.parametrize("Q,T,M,B,n_docs,k", [(2, 3, 2, 8, 20, 5), (1, 2, 1, 4, 3, 10)])
def test_bm25_meta_shapes(Q, T, M, B, n_docs, k):
    tf, docs, rng = _blocks(Q, T, M, B, n_docs)
    dl = torch.from_numpy(rng.uniform(1, 30, tf.shape).astype(np.float32))
    idf = torch.from_numpy(rng.uniform(0.1, 3, (Q, T)).astype(np.float32))
    valid = torch.ones(Q, T, M, 1, dtype=torch.bool)
    doc_len = torch.from_numpy(rng.uniform(1, 30, n_docs + 1).astype(np.float32))
    ub = torch.from_numpy(rng.uniform(0, 5, (Q, T, M)).astype(np.float32))
    params = (0.9, 0.4, 12.0)
    _check("bm25_block_scores", bm25_block_scores, (tf, dl, idf, *params))
    _check("bm25_block_impacts", bm25_block_impacts,
           (tf, docs, valid, doc_len, idf, *params, n_docs))
    for single in (False, True):
        args = (tf, dl, docs, idf, ub, valid[..., 0])
        if single:
            args = tuple(a[0] for a in args)
        kw = dict(k=k, n_docs=n_docs)
        _check("bm25_pruned_topk", bm25_pruned_topk, (*args, *params), kw)


def test_meta_calls_launch_nothing_and_record_only_when_asked():
    s = torch.empty(2, 100, device="meta")
    before = topk.launches
    vals, ids = topk(s, 4)                         # no record_costs block: nothing kept
    assert topk.launches == before and vals.shape == (2, 4) and ids.dtype == torch.int32
    with backend.record_costs() as log:
        topk(s, 4)
        flash_attention(*(torch.empty(1, 2, 3, 4, device="meta"),) * 3, causal=True)
    assert [c.name for c in log] == ["topk", "flash_attention"]
    assert log[0].flops == 200 and log[0].bytes == 200 * 4 + 2 * 4 * 8
    # causal over 3 queries at the end of 3 keys: 1 + 2 + 3 pairs a (batch, head)
    assert log[1].flops == 2 * (4 + 4) * 2 * 6
    assert backend.f32(torch.empty((), device="meta")) != backend.f32(0.0)     # NaN
    with pytest.raises(ValueError, match="several devices"):
        backend.route(torch.zeros(1), s)
