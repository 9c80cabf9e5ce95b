"""The port's training path against the JAX package's, on the CPU in f32:
AdamW, clipping and the schedule on the same gradients; ``lm_loss`` and
its gradients for the reduced dense, MoE (``"gspmd"``) and MLA + MoE
configs; three train steps from one carried state; the recsys losses of
the four architectures; the cells' shape tables and train-state helpers.
Then the port's own invariant: every remat policy gives the gradients of
no remat, bit for bit. The reference's ``init_params`` values (and train
states) are carried across with ``models/weights.py``; data comes from
numpy or the repo's streams.

Tolerances across packages, as the same f32 arithmetic runs in other
orders (XLA's and PyTorch's matmuls and reductions): the optimizer
``rtol=1e-6``; the LM loss ``rtol=1e-5`` and its gradients ``rtol=1e-4,
atol=1e-6``; the loss after three steps ``rtol=1e-4``; the recsys losses
``rtol=1e-5`` and their gradients ``rtol=1e-4, atol=1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import get_arch as j_get_arch
from repro.data import recsys_data as jdata
from repro.models import recsys as jr
from repro.models import transformer as jtr
from repro.models.common import init_params as j_init_params
from repro.train import optim as jopt
from repro.train import steps as jsteps
from repro_torch.configs import cells as tcells
from repro_torch.configs import get_arch
from repro_torch.data import recsys_data as tdata
from repro_torch.models import recsys as tr
from repro_torch.models import transformer as ttr
from repro_torch.models.common import (REMAT_POLICIES, abstract_params, init_params, param_axes,
                                       tree_leaves)
from repro_torch.models.weights import train_state_from_numpy, tree_from_numpy
from repro_torch.train import optim as topt
from repro_torch.train import steps as tsteps

LM_NAMES = ("h2o-danube-1.8b", "olmoe-1b-7b", "deepseek-v2-236b")
RECSYS = ("fm", "dcn-v2", "bst", "bert4rec")
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread keeps these tests from crowding
    the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _grads_close(got, want, **tol):
    jl = jax.tree_util.tree_leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# -- optimizer -----------------------------------------------------------------------


def _opt_trees(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}, "e": ()}
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32),
                                   params)
    return params, grads


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.array(a)), tree)


@pytest.mark.parametrize("clip", [None, 1.0, 1e3])
def test_adamw_steps_match_reference(clip):
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    params, _ = _opt_trees(0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _t(params)
    jo, to = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(4):
        _, grads = _opt_trees(step + 1)
        jg, tg = jax.tree_util.tree_map(jnp.asarray, grads), _t(grads)
        if clip is not None:
            jg, jn = jopt.clip_by_global_norm(jg, clip)
            tg, tn = topt.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
            _grads_close(tg, jg, rtol=1e-6)
        jp, jo = jopt.adamw_update(jg, jo, jp, jcfg)
        tp, to = topt.adamw_update(tg, to, tp, tcfg)
        assert int(to["count"]) == int(jo["count"]) == step + 1
        assert to["count"].dtype == torch.int32
        for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
            _grads_close(got, want, rtol=1e-6, atol=1e-9)


def test_schedule_and_global_norm_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = np.arange(0, 130, 3)
    want = np.asarray(jopt.schedule(jopt.OptConfig(**cfg), jnp.asarray(steps)))
    got = topt.schedule(topt.OptConfig(**cfg), torch.tensor(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    _, grads = _opt_trees(9)
    np.testing.assert_allclose(float(topt.global_norm(_t(grads))),
                               float(jopt.global_norm(grads)), rtol=1e-6)


def test_adamw_bf16_params_keep_f32_moments():
    """bf16 parameters, f32 moments: the update runs in f32 and rounds the
    new parameter to bf16 once, as the reference's."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    params, grads = _opt_trees(3)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a).to(torch.bfloat16), params)
    jnew, jo = jopt.adamw_update(jax.tree_util.tree_map(jnp.asarray, grads), jopt.adamw_init(jp),
                                 jp, jopt.OptConfig(**cfg))
    tnew, to = topt.adamw_update(_t(grads), topt.adamw_init(tp), tp, topt.OptConfig(**cfg))
    for a, b in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=2 ** -7)
    assert all(m.dtype == torch.float32 for m in tree_leaves(to["m"]))


# -- LM ------------------------------------------------------------------------------


def _lm(name, **over):
    jcfg = dataclasses.replace(j_get_arch(name).reduced_config(), **over)
    tcfg = dataclasses.replace(get_arch(name).reduced_config(), **over)
    jparams = j_init_params(jtr.lm_param_defs(jcfg), jax.random.PRNGKey(1))
    tparams = tree_from_numpy(_np(jparams), ttr.lm_param_defs(tcfg), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _lm_batch(vocab: int, seed: int, B: int = 2, S: int = 24) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :4] = -1                       # ignored positions
    return {"tokens": toks[:, :-1].copy(), "labels": labels}


@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_loss_and_grads_match_reference(name):
    jcfg, tcfg, jparams, tparams = _lm(name)
    batch = _lm_batch(tcfg.vocab, 0)
    (jl, jm), jg = jax.value_and_grad(lambda p: jtr.lm_loss(p, batch, jcfg), has_aux=True)(
        jparams)
    tl, tm, tg = tsteps.value_and_grad(lambda p, b: ttr.lm_loss(p, b, tcfg), tparams, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in ("loss", "aux", "ppl"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL)
    assert (float(tm["aux"]) > 0) == (tcfg.moe is not None)
    _grads_close(tg, jg, **GRAD_TOL)
    if tcfg.moe is not None:             # the gates carry the router's gradient
        assert all(float(g.abs().sum()) > 0 for g in (tg["layers"]["ffn"]["router"],))


@pytest.mark.parametrize("name,compress", [(name, False) for name in LM_NAMES]
                         + [("h2o-danube-1.8b", True)])
def test_three_train_steps_match_reference(name, compress):
    """From one carried train state (the reference's after init), three
    steps of ``make_train_step(lm_loss)`` on three batches (once with the
    gradients rounded through bf16, ``compress_grads``)."""
    jcfg, tcfg, jparams, _ = _lm(name)
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jstate = jsteps.init_train_state(jparams)
    tstate = train_state_from_numpy(_np(jstate), ttr.lm_param_defs(tcfg), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(lambda p, b: jtr.lm_loss(p, b, jcfg),
                                           jopt.OptConfig(**opt), compress_grads=compress))
    tstep = tsteps.make_train_step(lambda p, b: ttr.lm_loss(p, b, tcfg), topt.OptConfig(**opt),
                                   compress_grads=compress)
    for step in range(3):
        batch = _lm_batch(tcfg.vocab, 10 + step)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert int(tm["step"]) == int(jm["step"]) == step + 1


@pytest.mark.parametrize("policy", REMAT_POLICIES)
@pytest.mark.parametrize("name", LM_NAMES)
def test_lm_remat_grads_equal_no_remat_bitwise(name, policy):
    _, base, _, tparams = _lm(name)
    batch = _lm_batch(base.vocab, 3)
    _, _, want = tsteps.value_and_grad(
        lambda p, b: ttr.lm_loss(p, b, dataclasses.replace(base, remat=False)), tparams, batch)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    _, _, got = tsteps.value_and_grad(lambda p, b: ttr.lm_loss(p, b, cfg), tparams, batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_lm_loss_trains_the_params_it_is_given():
    """``lm_loss`` differentiates through the tree's leaves (the serving
    entries run under inference_mode and cannot)."""
    _, tcfg, _, tparams = _lm("h2o-danube-1.8b")
    live = {k: v for k, v in tparams.items()}
    live["unembed"] = tparams["unembed"].clone().requires_grad_(True)
    loss, _ = ttr.lm_loss(live, _lm_batch(tcfg.vocab, 5), tcfg)
    (g,) = torch.autograd.grad(loss, [live["unembed"]])
    assert float(g.abs().sum()) > 0


# -- recsys ----------------------------------------------------------------------------


def _recsys_batch(cfg, data, B: int = 8, seed: int = 0, step: int = 0) -> dict:
    if cfg.kind == "bert4rec":
        return data.SequenceStream(n_items=cfg.n_items, seq_len=cfg.seq_len, batch=B,
                                   n_mask=4, n_neg=32, seed=seed).batch_at(step)
    out = data.CTRStream(n_sparse=cfg.n_sparse, rows_per_field=cfg.rows_per_field, batch=B,
                         n_dense=cfg.n_dense, seq_len=cfg.seq_len if cfg.kind == "bst" else 0,
                         n_items=cfg.n_items, seed=seed).batch_at(step)
    keys = {"fm": ("sparse",), "dcn": ("dense", "sparse"), "bst": ("seq", "target")}[cfg.kind]
    return {**{k: out[k] for k in keys}, "label": out["label"]}


def _recsys(name):
    jcfg, tcfg = j_get_arch(name).reduced_config(), get_arch(name).reduced_config()
    jparams = j_init_params(jr.recsys_param_defs(jcfg), jax.random.PRNGKey(len(name)))
    # the zero-initialised biases made nonzero, so their gradients are compared too
    jparams = jax.tree_util.tree_map(lambda a: a + 0.01, jparams)
    tparams = tree_from_numpy(_np(jparams), tr.recsys_param_defs(tcfg), device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("name,loss", [(name, "recsys_loss") for name in RECSYS]
                         + [("bert4rec", "masked_item_loss")])
def test_recsys_losses_and_grads_match_reference(name, loss):
    """``recsys_loss`` (ctr for fm/dcn-v2/bst, the sampled masked-item loss
    for bert4rec) and bert4rec's full-vocabulary masked-item loss."""
    jcfg, tcfg, jparams, tparams = _recsys(name)
    batch = _recsys_batch(tcfg, tdata)
    jbatch = _recsys_batch(jcfg, jdata)
    for key in batch:                        # the streams agree bit for bit
        np.testing.assert_array_equal(batch[key], jbatch[key])
    if loss == "masked_item_loss":
        S = tcfg.seq_len
        labels = np.full((len(batch["seq"]), S), -1, np.int32)
        np.put_along_axis(labels, batch["mask_pos"], batch["labels"], 1)
        batch = jbatch = {"seq": batch["seq"], "labels": labels}
    jfn, tfn = getattr(jr, loss), getattr(tr, loss)
    (jl, jm), jg = jax.value_and_grad(lambda p: jfn(p, jbatch, jcfg), has_aux=True)(jparams)
    tl, tm, tg = tsteps.value_and_grad(lambda p, b: tfn(p, b, tcfg), tparams, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL)
    _grads_close(tg, jg, **GRAD_TOL)


@pytest.mark.parametrize("name", RECSYS)
def test_recsys_train_steps_match_reference(name):
    jcfg, tcfg, jparams, _ = _recsys(name)
    opt = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = jsteps.init_train_state(jparams)
    tstate = train_state_from_numpy(_np(jstate), tr.recsys_param_defs(tcfg), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(lambda p, b: jr.recsys_loss(p, b, jcfg),
                                           jopt.OptConfig(**opt)))
    tstep = tsteps.make_train_step(lambda p, b: tr.recsys_loss(p, b, tcfg),
                                   topt.OptConfig(**opt))
    for step in range(3):
        jstate, jm = jstep(jstate, _recsys_batch(jcfg, jdata, step=step))
        tstate, tm = tstep(tstate, _recsys_batch(tcfg, tdata, step=step))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)


def test_recsys_serving_still_launches_no_grad():
    """The serving entries stay under inference_mode: their outputs carry
    no graph even from parameters that require grad."""
    _, tcfg, _, tparams = _recsys("fm")
    live = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    out = tr.recsys_forward(live, _recsys_batch(tcfg, tdata), tcfg, device="cpu")
    assert out.grad_fn is None and not out.requires_grad


# -- cells ---------------------------------------------------------------------------


def test_shape_tables_and_train_state_helpers_match_reference():
    for table in ("LM_SHAPES", "LM_SHAPES_REDUCED", "GNN_SHAPES", "GNN_SHAPES_REDUCED",
                  "RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED"):
        assert getattr(tcells, table) == getattr(jcells, table), table
    assert (tcells.N_NEG, tcells.N_MASK) == (jcells._N_NEG, jcells._N_MASK)
    name = "olmoe-1b-7b"
    jcfg, tcfg = j_get_arch(name).full_config(), get_arch(name).full_config()
    jdefs, tdefs = jtr.lm_param_defs(jcfg), ttr.lm_param_defs(tcfg)
    jstate = jcells.abstract_train_state(jdefs)
    tstate = tcells.abstract_train_state(tdefs)
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tree_leaves(tstate)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [str(t.dtype).split(".")[-1] for t in tl] == [str(j.dtype) for j in jl]
    assert all(t.device.type == "meta" for t in tl)
    jrules, trules = j_get_arch(name).rules(), get_arch(name).rules()
    jspecs = jcells.train_state_specs(jdefs, jrules)
    tspecs = tcells.train_state_specs(tdefs, trules)
    jflat = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    tflat = [s for s in _spec_leaves(tspecs)]
    assert [tuple(s) for s in tflat] == [tuple(s) for s in jflat]
    assert param_axes(tdefs)["embed"] == ("vocab", "embed")
    assert abstract_params(tdefs)["embed"].shape == (tcfg.vocab, tcfg.d_model)


def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("name", ["starcoder2-3b", "stablelm-3b", "h2o-danube-1.8b",
                                  "olmoe-1b-7b", "deepseek-v2-236b", "graphcast", "fm", "bst",
                                  "dcn-v2", "bert4rec", "anlessini"])
def test_config_rules_match_reference_and_cells_wait(name):
    jr_, tr_ = j_get_arch(name).rules(), get_arch(name).rules()
    assert dict(tr_.mapping) == dict(jr_.mapping) and tuple(tr_.batch) == tuple(jr_.batch)
    assert tuple(tr_.with_pod().batch) == tuple(jr_.with_pod().batch)
    # the cells no longer wait: they build, shape for shape as the reference's
    # (tests/test_torch_cells.py holds every leaf and spec)
    tcells, jcells = get_arch(name).cells(tr_, reduced=True), j_get_arch(name).cells(
        jr_, reduced=True)
    assert list(tcells) == list(jcells)
    assert all(t.kind == j.kind and t.skip == j.skip for t, j in zip(tcells.values(),
                                                                     jcells.values()))


def test_init_params_then_train_state_on_cpu():
    cfg = get_arch("h2o-danube-1.8b").reduced_config()
    params = init_params(ttr.lm_param_defs(cfg), torch.Generator().manual_seed(0), "cpu")
    state = tsteps.init_train_state(params)
    assert int(state["opt"]["count"]) == 0
    assert all(m.dtype == torch.float32 and not m.any() for m in tree_leaves(state["opt"]["m"]))
