"""The port's recsys serving path against the JAX package's, on the CPU in
f32: for the reduced config of each of the four architectures (fm,
dcn-v2, bst, bert4rec), ``recsys_forward`` logits, ``user_vector``,
``retrieval_topk`` on both routes and ``bert4rec_serve_topk``; the full
configs' parameter defs leaf by leaf; the synthetic click-log streams bit
for bit. The reference's own ``init_params`` values are carried across
with ``recsys_params_from_numpy``; batches come from the streams.

Tolerances across packages. Logits and user vectors: ``rtol=atol=1e-5`` —
the same f32 arithmetic with sums in other orders (K6's twin sums a bag
slot by slot where the reference calls ``jnp.sum``; XLA's and PyTorch's
matmuls block differently); they differ by a few 1e-7. Top-k: values
within ``2e-6·Σ_d|u_d·c_d|`` of the reference's at each rank, ids equal
except where the two ids' exact scores lie within that tolerance of each
other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import recsys_data as jdata
from repro.models import recsys as jr
from repro.models.common import init_params as j_init_params
from repro_torch.configs import family, get_arch
from repro_torch.data import recsys_data as tdata
from repro_torch.kernels.dot_topk import dot_topk_batch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.topk import topk
from repro_torch.models import recsys as tr
from repro_torch.models.common import count_params, tree_leaves
from repro_torch.models.weights import recsys_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
TOPK_TOL = 2e-6
ARCHS = family("recsys")
B = 8
N_CANDS = 512          # the reduced retrieval_cand shape


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops: one intra-op thread each keeps these
    tests from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, batch: int, seed: int = 0, step: int = 0, data=tdata) -> dict:
    """A serving batch from the repo's synthetic streams, as the reference's
    recsys cells shape it."""
    if cfg.kind == "bert4rec":
        return {"seq": data.SequenceStream(n_items=cfg.n_items, seq_len=cfg.seq_len,
                                           batch=batch, seed=seed).batch_at(step)["seq"]}
    out = data.CTRStream(n_sparse=cfg.n_sparse, rows_per_field=cfg.rows_per_field, batch=batch,
                         n_dense=cfg.n_dense, seq_len=cfg.seq_len if cfg.kind == "bst" else 0,
                         n_items=cfg.n_items, seed=seed).batch_at(step)
    keys = {"fm": ("sparse",), "dcn": ("dense", "sparse"), "bst": ("seq", "target")}[cfg.kind]
    return {k: out[k] for k in keys}


def _models(name):
    jcfg, tcfg = j_get_arch(name).reduced_config(), get_arch(name).reduced_config()
    jparams = j_init_params(jr.recsys_param_defs(jcfg), jax.random.PRNGKey(len(name)))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, recsys_params_from_numpy(tree, tcfg, device="cpu")


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_topk_close(u, c, got_v, got_i, want_v, want_i):
    """Per query and rank: values within TOPK_TOL·Σ_d|u_d·c_d| of the
    reference's; where the ids differ, the two rows' exact (float64) scores
    lie within that tolerance of each other."""
    gv, gi = np.asarray(got_v, np.float64).reshape(-1), np.asarray(got_i).reshape(-1)
    wv, wi = np.asarray(want_v, np.float64).reshape(-1), np.asarray(want_i).reshape(-1)
    assert gv.shape == wv.shape and gi.shape == wi.shape
    u, c = np.asarray(u, np.float64), np.asarray(c, np.float64)
    tol = TOPK_TOL * np.abs(c[wi] * u).sum(-1)
    assert (np.abs(gv - wv) <= tol).all(), (gv - wv, tol)
    exact = c @ u
    for r in np.flatnonzero(gi != wi):
        assert abs(exact[gi[r]] - exact[wi[r]]) <= 2 * tol[r], f"rank {r}: {gi[r]} != {wi[r]}"


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_user_vector_match_reference(name):
    jcfg, tcfg, jparams, params = _models(name)
    batch = _batch(tcfg, B, seed=len(name))
    want = jr.recsys_forward(jparams, _j(batch), jcfg)
    got = tr.recsys_forward(params, batch, tcfg, device="cpu")
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jr.user_vector(jparams, _j(batch), jcfg)
    got = tr.user_vector(params, batch, tcfg, device="cpu")
    assert tuple(got.shape) == want.shape == (B, tcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_retrieval_topk_matches_reference(name, use_kernel):
    """One user against N_CANDS candidates, k = 100 (the reduced
    ``retrieval_cand`` cell): the K4 route (``use_kernel=True``) and the
    plain matmul + K2 route against the reference's same route."""
    jcfg, tcfg, jparams, params = _models(name)
    one = {k: v[:1] for k, v in _batch(tcfg, B, seed=3).items()}
    cand = np.random.default_rng(5).standard_normal((N_CANDS, tcfg.embed_dim)).astype(np.float32)
    wv, wi = jr.retrieval_topk(jparams, _j(one), jcfg, jnp.asarray(cand), 100,
                               use_kernel=use_kernel)
    gv, gi = tr.retrieval_topk(params, one, tcfg, cand, 100, use_kernel=use_kernel, device="cpu")
    assert gi.dtype == torch.int32 and gv.shape == (100,)
    u = np.asarray(jr.user_vector(jparams, _j(one), jcfg))[0]
    assert_topk_close(u, cand, gv, gi, wv, wi)


@pytest.mark.parametrize("chunk", [3, 2048])
def test_bert4rec_serve_topk_matches_reference(chunk):
    """Next-item top-100 over the whole vocabulary, in chunks (3: the last
    one padded with [PAD]) and in one (2048 ≥ B)."""
    jcfg, tcfg, jparams, params = _models("bert4rec")
    seq = _batch(tcfg, B, seed=4)["seq"]
    wv, wi = jr.bert4rec_serve_topk(jparams, jnp.asarray(seq), jcfg, k=100, chunk=chunk)
    gv, gi = tr.bert4rec_serve_topk(params, seq, tcfg, k=100, chunk=chunk, device="cpu")
    assert gv.shape == (B, 100) and gi.dtype == torch.int32
    hidden = np.asarray(jr._bert4rec_hidden(jparams, jnp.asarray(seq), jcfg))[:, -1]
    emb = np.asarray(jparams["item_emb"])
    for b in range(B):
        # the bias is 0 at init, so each logit is the plain inner product
        assert_topk_close(hidden[b], emb, gv[b], gi[b], np.asarray(wv)[b], np.asarray(wi)[b])


def test_bert4rec_sharded_topk_matches_reference():
    """``sharded_topk=True`` on a (1, 1) mesh against the reference's on
    its (1, 1) mesh, to the retrieval standard."""
    from repro.parallel import compat as jcompat
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    jcfg, tcfg, jparams, params = _models("bert4rec")
    jcfg = dataclasses.replace(jcfg, sharded_topk=True)
    tcfg = dataclasses.replace(tcfg, sharded_topk=True)
    seq = _batch(tcfg, B, seed=4)["seq"]
    jmesh = jcompat.make_mesh((1, 1), ("data", "model"))
    with jcompat.use_mesh(jmesh):
        wv, wi = jr.bert4rec_serve_topk(jparams, jnp.asarray(seq), jcfg, k=100)
    with use_mesh(StackedMesh((1, 1), device="cpu")):
        gv, gi = tr.bert4rec_serve_topk(params, seq, tcfg, k=100, device="cpu")
    assert gv.shape == (B, 100) and gi.dtype == torch.int32
    hidden = np.asarray(jr._bert4rec_hidden(jparams, jnp.asarray(seq), jcfg))[:, -1]
    emb = np.asarray(jparams["item_emb"])
    for b in range(B):
        assert_topk_close(hidden[b], emb, gv[b], gi[b], np.asarray(wv)[b], np.asarray(wi)[b])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 8)])
def test_bert4rec_sharded_topk_equals_unsharded(shape):
    """Vocabulary shards stacked on the CPU: the k·M survivors merged by
    position give the unsharded top-100's ids and value bits."""
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    _, tcfg, _, params = _models("bert4rec")
    seq = _batch(tcfg, B, seed=6)["seq"]
    want_v, want_i = tr.bert4rec_serve_topk(params, seq, tcfg, k=100, device="cpu")
    with use_mesh(StackedMesh(shape, device="cpu")):
        got_v, got_i = tr.bert4rec_serve_topk(params, seq, dataclasses.replace(
            tcfg, sharded_topk=True), k=100, device="cpu")
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


def test_serving_launches_no_kernel_on_the_cpu():
    """On CPU tensors every wrapper takes its twin: no launch is counted."""
    kern = (embedding_bag, flash_attention, dot_topk_batch, topk)
    before = [fn.launches for fn in kern]
    for name in ARCHS:
        _, tcfg, _, params = _models(name)
        batch = _batch(tcfg, 2)
        tr.retrieval_topk(params, {k: v[:1] for k, v in batch.items()}, tcfg,
                          np.ones((20, tcfg.embed_dim), np.float32), 5, use_kernel=True,
                          device="cpu")
        if name == "bert4rec":
            tr.bert4rec_serve_topk(params, batch["seq"], tcfg, k=5, device="cpu")
        else:
            tr.recsys_forward(params, batch, tcfg, device="cpu")
    assert [fn.launches for fn in kern] == before


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_defs_match_reference(name):
    """At full width, without allocating: every leaf's shape, axes and
    init, the leaf order and the parameter count equal the reference's;
    the config's fields and defaults too (``dtype`` is a torch dtype)."""
    jcfg, tcfg = j_get_arch(name).full_config(), get_arch(name).full_config()
    jdefs, tdefs = jr.recsys_param_defs(jcfg), tr.recsys_param_defs(tcfg)
    jl = jax.tree_util.tree_leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes"))
    tl = tree_leaves(tdefs)
    assert [(d.shape, d.axes, d.init) for d in tl] == [(d.shape, d.axes, d.init) for d in jl]
    assert all(d.dtype == torch.float32 for d in tl)
    assert count_params(tdefs) == tcfg.param_count() == jcfg.param_count()
    tf = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg) if f.name != "dtype"}
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    assert tf == jf and tcfg.dtype == torch.float32
    assert get_arch(name).FAMILY == j_get_arch(name).FAMILY == "recsys"


def test_data_streams_match_reference_bitwise():
    """The streams are numpy only: every array equal to the reference's,
    bit for bit, for each architecture's reduced serving batch and a
    training batch with labels, dense features and sequences."""
    for name in ARCHS:
        cfg = get_arch(name).reduced_config()
        for step in (0, 3):
            a, b = _batch(cfg, 16, seed=2, step=step), _batch(cfg, 16, seed=2, step=step,
                                                              data=jdata)
            assert sorted(a) == sorted(b)
            assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    kw = dict(n_sparse=5, rows_per_field=50, batch=12, n_dense=3, seq_len=4, n_items=30, seed=9)
    a, b = tdata.CTRStream(**kw).batch_at(1), jdata.CTRStream(**kw).batch_at(1)
    assert sorted(a) == sorted(b) == ["dense", "label", "seq", "sparse", "target"]
    assert all(np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)) for k in a)
    kw = dict(n_items=40, seq_len=10, batch=6, n_mask=3, n_neg=7, seed=1)
    a, b = tdata.SequenceStream(**kw).batch_at(2), jdata.SequenceStream(**kw).batch_at(2)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_mismatched_weights_are_refused():
    jcfg = j_get_arch("fm").reduced_config()
    tcfg = get_arch("fm").reduced_config()
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jr.recsys_param_defs(jcfg),
                                                            jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="bias: shape"):
        recsys_params_from_numpy(dict(tree, bias=np.ones(3, np.float32)), tcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        recsys_params_from_numpy(dict(tree, extra=np.ones(3, np.float32)), tcfg, device="cpu")
    params = recsys_params_from_numpy(tree, tcfg, device="cpu")
    with pytest.raises(ValueError, match="live on cpu"):
        tr.recsys_forward(params, _batch(tcfg, 2), tcfg, device="meta")
