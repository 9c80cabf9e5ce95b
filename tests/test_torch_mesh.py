"""The port's mesh path against ``repro.search.distributed`` and
``repro.core.partition``: the mesh types' collectives, document-partitioned
BM25 on one partition in-process and on eight against the reference's
forced-8-device run, and the rank mesh (gloo, one process per partition)
against the stacked mesh.

Across packages: ids equal (except inside a group of reference scores tied
within the tolerance), scores at ``rtol=1e-6, atol=0``; exact
cross-partition ties (one text in partitions 1 and 2) resolve to the
reference's ids under both gathers. Inside the port: bitwise.

The reference's eight-partition run and every multi-rank run each go in one
``subprocess.run`` with a time limit; the multi-rank subprocess starts its
gloo ranks itself (``torch.multiprocessing.spawn``, a ``FileStore`` under
``tmp_path``), so this process never forks, spawns or joins a process group.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import anlessini as janlessini
from repro.core import partition as jpartition
from repro.data.corpus import synth_corpus, synth_queries
from repro.parallel import compat as jcompat
from repro.search import distributed as jdist
from repro.search.bm25 import encode_queries as j_encode
from repro_torch.configs import family, get_arch
from repro_torch.core import partition as tpartition
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P, StackedMesh
from repro_torch.search import distributed as tdist
from repro_torch.search.bm25 import encode_queries
from repro_torch.search.oracle import OracleSearcher
from test_torch_kernels import assert_topk_close

ROOT = Path(__file__).resolve().parents[1]
K = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
                **extra)


# -- the mesh types -------------------------------------------------------------------


def _stacked(shape):
    return StackedMesh(shape, ("data", "model"), device="cpu")


def _gathered(mesh, axes_seq):
    """Each partition's flat id, gathered along ``axes_seq`` in turn."""
    run = compat.shard_map(
        lambda pid: _gather_seq(pid, axes_seq), mesh, in_specs=(P(("data", "model")),),
        out_specs=P(("data", "model")))
    return run(torch.arange(mesh.size)).view(mesh.size, -1)


def _gather_seq(x, axes_seq):
    for axes in axes_seq:
        x = compat.all_gather(x, axes)
    return x


def test_stacked_all_gather_follows_the_rank_order():
    """(4, 2): the hierarchical gather (data, then model) puts partitions in
    the order 0, 2, 4, 6, 1, 3, 5, 7 on every partition, as two tiled JAX
    all_gathers do; the fused gather over (data, model) 0..7; one axis
    alone its own coordinates."""
    mesh = _stacked((4, 2))
    assert (_gathered(mesh, ["data", "model"]) == torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])).all()
    assert (_gathered(mesh, [("data", "model")]) == torch.arange(8)).all()
    by_model = _gathered(mesh, ["model"])
    assert by_model.tolist() == [[2 * (p // 2), 2 * (p // 2) + 1] for p in range(8)]
    by_data = _gathered(mesh, ["data"])
    assert by_data.tolist() == [[p % 2 + 2 * d for d in range(4)] for p in range(8)]


@pytest.mark.parametrize("fused", [False, True])
def test_out_spec_gather_is_the_in_body_all_gather(fused):
    """``make_dist_search_fn`` gathers the survivors through its out-spec
    over ``gather_axes``: the same order as the body's all-gathers would
    give (hierarchical 0, 2, 4, 6, 1, 3, 5, 7; fused 0..7)."""
    mesh = _stacked((4, 2))
    axes = ("data", "model")
    run = compat.shard_map(
        lambda pid: pid.view(-1, 1, 1).expand(-1, 3, 2), mesh,
        in_specs=(P(("data", "model")),),
        out_specs=P(None, tdist.gather_axes(axes, fused)))
    got = run(torch.arange(mesh.size))
    want = _gathered(mesh, [axes] if fused else list(axes))[0].repeat_interleave(2)
    assert got.shape == (3, 2 * mesh.size)
    assert (got == want).all()


@pytest.mark.parametrize("spec", [P("data", None), P(None, "model"), P("data", "model"),
                                  P(("data", "model"), None), P(("model", "data")), P()])
def test_stacked_shard_and_unshard_round_trip(spec):
    mesh = _stacked((2, 4))
    x = torch.arange(8 * 12, dtype=torch.float32).view(8, 12)
    local = mesh.shard(x, spec)
    assert local.shape[0] == mesh.size
    d, m = mesh.axis_index("data"), mesh.axis_index("model")
    for p in range(mesh.size):
        coord = {"data": int(d[p]), "model": int(m[p])}
        want = x
        for dim, e in enumerate(spec):
            axes = (e,) if isinstance(e, str) else tuple(e or ())
            if axes:
                idx, n = 0, 1
                for a in axes:
                    idx, n = idx * mesh.shape[a] + coord[a], n * mesh.shape[a]
                size = x.shape[dim] // n
                want = want.narrow(dim, idx * size, size)
        assert torch.equal(local[p], want), (spec, p)
    assert torch.equal(mesh.unshard(local, spec), x)


def test_stacked_psum_axis_index_and_flat_index():
    mesh = _stacked((2, 4))
    assert compat.flat_axis_index(("data", "model"), mesh).tolist() == list(range(8))
    assert compat.flat_axis_index(("model", "data"), mesh).tolist() == [
        m * 2 + d for d in range(2) for m in range(4)]
    x = torch.arange(8, dtype=torch.float32).view(8, 1) + 1
    got = mesh.psum(x, "model").view(-1)
    assert got.tolist() == [10.0] * 4 + [26.0] * 4
    assert mesh.psum(x, ("data", "model")).view(-1).tolist() == [36.0] * 8


def test_mesh_needs_a_mesh_and_the_rank_mesh_a_process_group():
    fn = compat.shard_map(lambda x: x, None, in_specs=(P(),), out_specs=P())
    with pytest.raises(ValueError, match="no ambient mesh"):
        fn(torch.zeros(2))
    with compat.use_mesh(_stacked((1, 2))):
        assert torch.equal(fn(torch.ones(2)), torch.ones(2))
        assert compat.ambient_mesh().shape == {"data": 1, "model": 2}
    assert compat.ambient_mesh() is None
    with pytest.raises(RuntimeError, match="default process group"):
        compat.RankMesh((1, 1), device="cpu")
    assert isinstance(compat.make_mesh((2, 2), device="cpu"), StackedMesh)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        _stacked((2, 2)).axis_index("pod")


# -- core/partition.py's mesh half ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partitioned_topk_matches_reference_and_global(seed):
    """One partition against the reference's ``partitioned_topk``; eight
    stacked partitions against the global top-k (ties to the lower id)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 4)).astype(np.float32)
    table = rng.standard_normal((96, 4)).astype(np.float32)
    table[17] = table[60]                       # an exact tie across partitions

    def tscore(query, t):
        return torch.matmul(query, t.transpose(1, 2))

    jmesh = jcompat.make_mesh((1, 1), ("data", "model"))
    jfn = jpartition.partitioned_topk(lambda qq, t: qq @ t.T, jmesh, "model", 5,
                                      in_specs=(jax.sharding.PartitionSpec("model", None),))
    with jcompat.use_mesh(jmesh):
        wv, wi = map(np.asarray, jfn(jnp.asarray(q), jnp.asarray(table)))
    tfn = tpartition.partitioned_topk(tscore, _stacked((1, 1)), "model", 5,
                                      in_specs=(P("model", None),))
    gv, gi = tfn(q, table)
    for r in range(3):
        assert_topk_close(gv[r].numpy(), gi[r].numpy(), wv[r], wi[r])
    mesh = _stacked((1, 8))
    gv, gi = tpartition.partitioned_topk(tscore, mesh, "model", 5,
                                         in_specs=(P("model", None),))(q, table)
    per_part = tscore(torch.from_numpy(q).expand(8, 3, 4),
                      torch.from_numpy(table).view(8, 12, 4))        # (8, 3, 12)
    flat = per_part.permute(1, 0, 2).reshape(3, 96).numpy()
    order = np.lexsort((np.arange(96)[None].repeat(3, 0), -flat), axis=-1)[:, :5]
    assert np.array_equal(gi.numpy(), order)
    assert np.array_equal(_bits(gv.numpy()), _bits(np.take_along_axis(flat, order, 1)))


# -- the mesh search path ---------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    # 300 docs / vocab 500: every term's postings fit 64 blocks × 128 lanes
    return synth_corpus(300, vocab=500, seed=21)


@pytest.fixture(scope="module")
def queries(corpus):
    return synth_queries(corpus, 12, seed=23)


def assert_matches_oracle(got, want, ctx=""):
    """``tests/test_parity.py``'s standard: scores rank by rank to float
    tolerance; ids equal unless score-tied."""
    assert len(got) >= min(len(want), K), (ctx, len(got), len(want))
    for r, ((wd, ws), (gd, gs)) in enumerate(zip(want, got)):
        assert gs == pytest.approx(ws, rel=2e-4), (ctx, r, want[:5], got[:5])
        tied = any(abs(ws - w2) < 1e-5 for d2, w2 in want if d2 != wd)
        assert wd == gd or tied, (ctx, r, want[:8], got[:8])


def _run_reference_one(corpus, queries, hint):
    state, cfg, vocab = jdist.build_partitioned_state(corpus, 1, hint)
    mesh = jcompat.make_mesh((1, 1), ("data", "model"))
    fn = jdist.make_dist_search_fn(cfg, ("data", "model"), mesh=mesh)
    tids, qtf = j_encode(vocab, queries, max_terms=cfg.max_terms, idf=state["idf"])
    with jcompat.use_mesh(mesh):
        s, i = jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, state), tids, qtf)
    return np.asarray(s), np.asarray(i), tids


@pytest.mark.parametrize("accumulator,fused,compact", [
    ("dense", False, False), ("dense", True, False), ("pruned", False, False),
    ("pruned", True, False), ("dense", False, True)])
def test_one_partition_matches_reference(corpus, queries, accumulator, fused, compact):
    """(1, 1), in-process, as ``tests/test_parity.py``'s mesh tests: the
    port's ``make_dist_search_fn`` against the reference's, and against the
    port's own oracle."""
    hint = {"k": K, "max_blocks": 64, "accumulator": accumulator, "fused_gather": fused,
            "compact_ids": compact}
    wv, wi, wt = _run_reference_one(corpus, queries, hint)
    state, cfg, vocab = tdist.build_partitioned_state(corpus, 1, hint, device="cpu")
    assert cfg.compact_ids == compact
    assert state["block_docs"].dtype == (torch.uint16 if compact else torch.int32)
    tids, qtf = encode_queries(vocab, queries, max_terms=cfg.max_terms,
                               idf=state["idf"].numpy())
    assert np.array_equal(tids, wt)
    gv, gi = tdist.make_dist_search_fn(cfg, ("data", "model"), mesh=_stacked((1, 1)))(
        state, tids, qtf)
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32 and gv.shape == (12, K)
    oracle = OracleSearcher(corpus)
    for q in range(len(queries)):
        assert_topk_close(gv[q].numpy(), gi[q].numpy(), wv[q], wi[q])
        got = [(int(i), float(v)) for v, i in zip(gv[q], gi[q]) if v > 0]
        assert_matches_oracle(got, oracle.search(queries[q], k=K), ctx=(accumulator, q))


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_pruned_bit_identical_to_mesh_dense(stacked8, fused):
    """Eight stacked partitions: the pruned accumulator's answers are the
    dense one's, ids and score bits."""
    key = int(fused)
    assert np.array_equal(_bits(stacked8[f"dense_{key}_scores"]),
                          _bits(stacked8[f"pruned_{key}_scores"]))
    assert np.array_equal(stacked8[f"dense_{key}_ids"], stacked8[f"pruned_{key}_ids"])


def test_stacked_bits_do_not_depend_on_partitions_per_call(stacked8, monkeypatch):
    """One partition a scoring call, as a rank holds it, against all eight
    in one call: the same bits."""
    monkeypatch.setattr(tdist, "POSTINGS_PER_CALL", 1)
    assert tdist.partitions_per_call(get_arch("anlessini").full_config(8), 64, 16) == 1
    assert _same(ranks.search_outputs(_stacked((4, 2))), stacked8)


def test_state_specs_abstract_state_and_extent_check():
    cfg = get_arch("anlessini").full_config(256)
    assert (cfg.n_docs_local, cfg.n_blocks_local, cfg.vocab, cfg.k) == (34560, 15360, 1 << 19, 100)
    jcfg = jdist.DistSearchConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    assert jcfg == janlessini.full_config(256)
    state = tdist.abstract_dist_state(cfg)
    jstate = jdist.abstract_dist_state(jcfg)
    assert sorted(state) == sorted(jstate)
    for name, t in state.items():
        assert t.device.type == "meta" and tuple(t.shape) == jstate[name].shape
        assert str(t.dtype).split(".")[1] == str(jstate[name].dtype), name
    assert tdist.dist_state_specs(("data", "model")) == {
        k: P(*v) for k, v in jdist.dist_state_specs(("data", "model")).items()}
    compact = tdist.DistSearchConfig(**{**vars(cfg), "compact_ids": True})
    assert tdist.abstract_dist_state(compact)["block_docs"].dtype == torch.uint16
    with pytest.raises(ValueError, match="compact_ids"):
        tdist.abstract_dist_state(tdist.DistSearchConfig(
            n_parts=1, n_docs_local=70000, n_blocks_local=1, vocab=4, compact_ids=True))
    small = get_arch("anlessini").reduced_config(2)
    with pytest.raises(ValueError, match="must equal the mesh extent"):
        tdist.make_dist_search_fn(small, mesh=_stacked((1, 1)))(None, np.zeros((1, 8)),
                                                                np.zeros((1, 8)))
    mod = get_arch("anlessini")
    assert family("search") == ["anlessini"] and mod.SHAPES["serve_q64"] == {"Q": 64}
    rules = mod.rules()                     # the reference's rules since the sharding port
    assert dict(rules.mapping) == {} and tuple(rules.batch) == ("data",)
    with pytest.raises(NotImplementedError, match="item 10"):
        mod.cells(rules)


def test_heterogeneous_packs_are_refused(corpus):
    from repro_torch.index.builder import IndexWriter
    packs = []
    for part in (corpus[:150], corpus[150:]):
        w = IndexWriter()                       # local stats and vocab: not one index
        w.add_many(part)
        packs.append(w.pack())
    with pytest.raises(ValueError, match="heterogeneous"):
        tdist.stack_partitions(packs, 150, device="cpu")


# -- eight partitions: the reference's forced-8-device run ------------------------------

_REFERENCE8 = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.parallel import compat
from repro.search.bm25 import encode_queries
from repro.search.distributed import build_partitioned_state, make_dist_search_fn
assert len(jax.devices()) == 8, jax.devices()
workdir = sys.argv[1]
data = json.load(open(workdir + "/inputs.json"))
docs = [tuple(d) for d in data["docs"]]
mesh = compat.make_mesh((4, 2), ("data", "model"))
out = {}
for acc, fused in data["cases"]:
    state, cfg, vocab = build_partitioned_state(
        docs, 8, {"k": 10, "max_blocks": 64, "accumulator": acc, "fused_gather": fused})
    tids, qtf = encode_queries(vocab, data["queries"], max_terms=cfg.max_terms)
    fn = make_dist_search_fn(cfg, ("data", "model"), mesh=mesh)
    with compat.use_mesh(mesh):
        s, i = jax.jit(fn)(jax.tree_util.tree_map(jnp.asarray, state), tids, qtf)
    out[f"{acc}_{int(fused)}_scores"] = np.asarray(s)
    out[f"{acc}_{int(fused)}_ids"] = np.asarray(i)
    out["tids"] = tids
np.savez(workdir + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("reference8")
    docs = ranks.mesh_corpus()
    (workdir / "inputs.json").write_text(json.dumps({
        "docs": docs, "queries": ranks.mesh_queries(docs), "cases": ranks.SEARCH_CASES}))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE8), str(workdir)],
                       capture_output=True, text=True, timeout=300,
                       env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(workdir / "reference.npz"))


@pytest.fixture(scope="module")
def stacked8():
    return ranks.search_outputs(_stacked((4, 2)))


@pytest.mark.parametrize("acc,fused", ranks.SEARCH_CASES)
def test_eight_partitions_match_reference(reference8, stacked8, acc, fused):
    key = f"{acc}_{int(fused)}"
    wv, wi = reference8[f"{key}_scores"], reference8[f"{key}_ids"]
    gv, gi = stacked8[f"{key}_scores"], stacked8[f"{key}_ids"]
    docs = ranks.mesh_corpus()
    from repro_torch.search.distributed import build_partitioned_state
    _, cfg, vocab = build_partitioned_state(docs, 8, {"max_blocks": 64}, device="cpu")
    tids, _ = encode_queries(vocab, ranks.mesh_queries(docs), max_terms=cfg.max_terms)
    assert np.array_equal(tids, reference8["tids"])
    for q in range(len(gv)):
        assert_topk_close(gv[q], gi[q], wv[q], wi[q])
    # the exact cross-partition tie: the hierarchical gather sees partition 2
    # before partition 1, the fused one partition 1 first; the port's ids are
    # the reference's in both
    a, b = ranks.TIE
    row = list(wi[-1])
    assert a in row and b in row and wv[-1][row.index(a)] == wv[-1][row.index(b)]
    assert (row.index(b) < row.index(a)) == (not fused)
    assert list(gi[-1]) == row


# -- the rank mesh: gloo, one process per partition, in its own subprocess ---------------


def _ranks(case: str, world: int, workdir: Path) -> list[dict]:
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"), case,
                        str(world), str(workdir)],
                       capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return [dict(np.load(workdir / f"rank{rank}.npz")) for rank in range(world)]


def _same(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].shape == b[k].shape and np.array_equal(_bits(a[k]), _bits(b[k])) for k in a)


def test_rank_mesh_search_equals_stacked(stacked8, tmp_path):
    """(4, 2) over 8 gloo ranks == the stacked (4, 2) mesh, bitwise, dense
    and pruned, both gathers, on every rank."""
    for out in _ranks("search", 8, tmp_path):
        assert _same(out, stacked8)


def test_rank_mesh_sharded_lookup_equals_stacked(tmp_path):
    table, idx = ranks.lookup_inputs()
    stacked = ranks.lookup_outputs(_stacked((2, 4)))
    assert np.array_equal(_bits(stacked["rows"]), _bits(table[idx]))
    for out in _ranks("lookup", 8, tmp_path):
        assert _same(out, stacked)


def test_rank_mesh_bert4rec_sharded_topk_equals_stacked(tmp_path):
    stacked = ranks.bert4rec_outputs(_stacked((1, 4)))
    for out in _ranks("bert4rec", 4, tmp_path):
        assert _same(out, stacked)
