"""The port's GNN (graphcast) and its data against the JAX package's, on
the CPU in f32: ``gnn_forward`` with each aggregator (sum, mean, max) on a
graph with padded edges, the batched path against the reference's
``vmap``, ``gnn_loss`` and its gradients, three train steps from one
carried state; ``synth_graph``, ``NeighborSampler`` and ``molecule_batch``
array for array. Then the port's own invariants: permutation equivariance,
every remat policy's gradients equal to no remat bit for bit, and the
fixed-order gathers and segment sums of ``models/gather.py``.

Tolerances across packages: outputs ``rtol=atol=1e-5``, the loss
``rtol=1e-5``, gradients ``rtol=1e-4, atol=1e-6``, the loss after three
steps ``rtol=1e-4`` — the same f32 arithmetic, matmuls blocked otherwise.
The data is numpy in both packages and equal exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import graphs as jgraphs
from repro.models import gnn as jg
from repro.models.common import init_params as j_init_params
from repro.train import optim as jopt
from repro.train import steps as jsteps
from repro_torch.configs import family, get_arch
from repro_torch.data import graphs as tgraphs
from repro_torch.models import gnn as tg
from repro_torch.models.common import count_params, tree_leaves
from repro_torch.models.gather import SegmentPlan, gather_rows, segment_max, segment_sum
from repro_torch.models.weights import train_state_from_numpy, tree_from_numpy
from repro_torch.train import optim as topt
from repro_torch.train import steps as tsteps

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
AGGREGATORS = ("sum", "mean", "max")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(aggregator="sum", d_feat=12, **over):
    jcfg = dataclasses.replace(j_get_arch("graphcast").reduced_config(d_feat),
                               aggregator=aggregator, **over)
    tcfg = dataclasses.replace(get_arch("graphcast").reduced_config(d_feat),
                               aggregator=aggregator, **over)
    jparams = j_init_params(jg.gnn_param_defs(jcfg), jax.random.PRNGKey(2))
    # the zero-initialised biases made nonzero, so every input matters
    jparams = jax.tree_util.tree_map(lambda a: a + 0.01, jparams)
    tparams = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              tg.gnn_param_defs(tcfg), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _graph(N=24, E=70, F=12, d_out=8, n_pad=6, seed=0) -> dict:
    """Random edges, the last ``n_pad`` padded (id N), targets, a node mask."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    src[E - n_pad:] = N
    dst[E - n_pad:] = N
    return {"feat": rng.normal(size=(N, F)).astype(np.float32), "src": src, "dst": dst,
            "target": rng.normal(size=(N, d_out)).astype(np.float32),
            "node_mask": (rng.random(N) < 0.7).astype(np.float32)}


def _grads_close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_forward_matches_reference(aggregator):
    jcfg, tcfg, jparams, tparams = _models(aggregator)
    g = _graph()
    want = jg.gnn_forward(jparams, g, jcfg)
    got = tg.gnn_forward(tparams, g, tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_aggregate_matches_reference(aggregator):
    """``_aggregate`` alone, its values and gradients: padded edges (id N)
    land in the dump row, an empty node sums to 0, max ties share."""
    rng = np.random.default_rng(4)
    N, E = 9, 40
    dst = rng.integers(0, N, E)
    dst[-6:] = N
    dst[dst == 3] = 4                        # node 3 receives nothing
    msgs = rng.normal(size=(E, 5)).astype(np.float32)
    msgs[7] = msgs[5] = msgs[2] + 3.0        # a three-way tie at the max
    dst[7] = dst[5] = dst[2]
    w = rng.normal(size=(N, 5)).astype(np.float32)
    jv, jgrad = jax.value_and_grad(lambda m: (jg._aggregate(m, dst, N, aggregator) * w).sum())(
        msgs)
    m = torch.tensor(msgs, requires_grad=True)
    tv = (tg._aggregate(m, torch.tensor(dst), N, aggregator) * torch.tensor(w)).sum()
    (tgrad,) = torch.autograd.grad(tv, [m])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_batched_forward_matches_reference_vmap(aggregator):
    jcfg, tcfg, jparams, tparams = _models(aggregator, d_feat=6)
    b = jgraphs.molecule_batch(5, 10, 20, 6, 8, seed=3)
    b["src"][:, -3:] = 10                    # padded edges in some graphs
    b["dst"][:, -3:] = 10
    want = jg.gnn_forward_batched(jparams, b, jcfg)
    got = tg.gnn_forward_batched(tparams, b, tcfg)
    assert tuple(got.shape) == want.shape == (5, 10, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # graph by graph, the single-graph path
    for i in range(5):
        one = tg.gnn_forward(tparams, {k: b[k][i] for k in ("feat", "src", "dst")}, tcfg)
        np.testing.assert_allclose(got[i].detach().numpy(), one.detach().numpy(), **TOL)


@pytest.mark.parametrize("aggregator", AGGREGATORS)
@pytest.mark.parametrize("batched", [False, True])
def test_loss_and_grads_match_reference(aggregator, batched):
    jcfg, tcfg, jparams, tparams = _models(aggregator, d_feat=6 if batched else 12)
    batch = (jgraphs.molecule_batch(4, 10, 20, 6, 8, seed=4) if batched else _graph())
    if batched:
        batch["node_mask"][:, 7:] = 0.0
    (jl, jm), jgr = jax.value_and_grad(lambda p: jg.gnn_loss(p, batch, jcfg), has_aux=True)(
        jparams)
    tl, tm, tgr = tsteps.value_and_grad(lambda p, b: tg.gnn_loss(p, b, tcfg), tparams, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["rmse"]), float(jm["rmse"]), rtol=1e-5)
    _grads_close(tgr, jgr)


def test_three_train_steps_match_reference():
    jcfg, tcfg, jparams, _ = _models()
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstate = jsteps.init_train_state(jparams)
    tstate = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                    tg.gnn_param_defs(tcfg), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(lambda p, b: jg.gnn_loss(p, b, jcfg),
                                           jopt.OptConfig(**opt)))
    tstep = tsteps.make_train_step(lambda p, b: tg.gnn_loss(p, b, tcfg), topt.OptConfig(**opt))
    for step in range(3):
        batch = _graph(seed=10 + step)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)


def test_permutation_equivariance():
    """Relabeling nodes permutes the port's outputs correspondingly."""
    _, tcfg, _, tparams = _models()
    N, E = 12, 30
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(N, 12)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    out = tg.gnn_forward(tparams, {"feat": feat, "src": src, "dst": dst}, tcfg)
    perm = rng.permutation(N)
    inv = np.argsort(perm)
    out_p = tg.gnn_forward(tparams, {"feat": feat[perm], "src": inv[src].astype(np.int32),
                                     "dst": inv[dst].astype(np.int32)}, tcfg)
    np.testing.assert_allclose(out.detach().numpy()[perm], out_p.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_remat_grads_equal_no_remat_bitwise(policy):
    _, base, _, tparams = _models()
    g = _graph(seed=5)
    _, _, want = tsteps.value_and_grad(
        lambda p, b: tg.gnn_loss(p, b, dataclasses.replace(base, remat=False)), tparams, g)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    _, _, got = tsteps.value_and_grad(lambda p, b: tg.gnn_loss(p, b, cfg), tparams, g)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_full_config_defs_match_reference():
    jcfg = j_get_arch("graphcast").full_config(d_feat=602)
    tcfg = get_arch("graphcast").full_config(d_feat=602)
    jd = jax.tree_util.tree_leaves(jg.gnn_param_defs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))
    td = tree_leaves(tg.gnn_param_defs(tcfg))
    assert [(d.shape, d.axes, d.init) for d in td] == [(d.shape, d.axes, d.init) for d in jd]
    assert count_params(tg.gnn_param_defs(tcfg)) == jcfg.param_count() == tcfg.param_count()
    assert family("gnn") == ["graphcast"]


# -- data ------------------------------------------------------------------------------


def test_synth_graph_and_sampler_equal_reference():
    jgr = jgraphs.synth_graph(800, avg_degree=6, d_feat=5, seed=1)
    tgr = tgraphs.synth_graph(800, avg_degree=6, d_feat=5, seed=1)
    for key in ("indptr", "neighbors", "feat"):
        np.testing.assert_array_equal(tgr[key], jgr[key])
    js = jgraphs.NeighborSampler(jgr, fanout=(4, 3), seed=7)
    ts = tgraphs.NeighborSampler(tgr, fanout=(4, 3), seed=7)
    for step in range(3):
        seeds = np.arange(step * 10, step * 10 + 16)
        a, b = ts.sample(seeds, step=step), js.sample(seeds, step=step)
        assert set(a) == set(b) and a["n_real_nodes"] == b["n_real_nodes"]
        for key in ("feat", "src", "dst", "node_mask"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert tgraphs.padded_sizes(1024, (15, 10)) == jgraphs.padded_sizes(1024, (15, 10))


def test_molecule_batch_equals_reference():
    a = tgraphs.molecule_batch(6, 9, 14, 5, 3, seed=2)
    b = jgraphs.molecule_batch(6, 9, 14, 5, 3, seed=2)
    for key in b:
        np.testing.assert_array_equal(a[key], b[key])


# -- the fixed-order gathers and sums -----------------------------------------------------


def test_segment_sum_adds_each_segment_in_edge_order():
    rng = np.random.default_rng(0)
    E, n, d = 200, 13, 7
    idx = rng.integers(0, n, E)
    x = torch.tensor((rng.normal(size=(E, d)) * 10.0 ** rng.integers(-3, 4, (E, 1)))
                     .astype(np.float32))
    got = segment_sum(x, torch.tensor(idx), n)
    want = torch.zeros(n, d)
    for e in range(E):                       # one f32 rounding per add, in edge order
        want[idx[e]] = want[idx[e]] + x[e]
    assert torch.equal(got, want)
    mx = segment_max(x, torch.tensor(idx), n + 2)
    assert torch.isinf(mx[n:]).all() and torch.equal(mx[:n], torch.stack(
        [x[torch.tensor(idx == s)].amax(0) for s in range(n)]))


def test_gather_backward_is_the_segment_sum():
    rng = np.random.default_rng(1)
    table = torch.tensor(rng.normal(size=(9, 4)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 9, (5, 6)))
    up = torch.tensor(rng.normal(size=(5, 6, 4)).astype(np.float32))
    (g,) = torch.autograd.grad((gather_rows(table, idx) * up).sum(), [table])
    plan = SegmentPlan(idx, 9)
    assert torch.equal(g, plan.sum(up.reshape(-1, 4)))
    assert torch.equal(plan.lengths, torch.bincount(idx.reshape(-1), minlength=9))
    x = torch.tensor(rng.normal(size=(30, 3)), requires_grad=True)
    seg = torch.tensor(rng.integers(0, 6, 30))
    assert torch.autograd.gradcheck(lambda x: segment_sum(x, seg, 6), (x,))
    assert torch.autograd.gradcheck(lambda t: gather_rows(t, seg), (x[:7].detach()
                                                                   .requires_grad_(),))
