"""The port's MoE (``repro_torch.models.moe``, ``moe_ep``) against the JAX
package's on the CPU in f32, on inputs made with numpy and the reference's
own initial parameters.

* ``moe_ffn``: the reference test's two cases (ample capacity, where the
  result equals the dropless oracle; overflow, where tokens drop) and one
  with an explicit ``capacity=``. The slot table equals the reference's
  exactly: the reference's is read off the (E, C, d) rows it gathers (each
  row of x is distinct, so a row names its token). ``y`` and ``aux`` at
  ``rtol=1e-5`` (``atol=1e-6`` for outputs near 0). Expert ids equal,
  except in rows where the reference's k-th and (k+1)-th probabilities lie
  within 1e-6 of each other.
* ``ep_moe_ffn`` on stacked (1, 1), (1, 2) and (4, 2) meshes, and on a
  (4, 2) rank mesh of 8 gloo processes (one subprocess with a time limit,
  as ``test_torch_mesh.py`` runs them), against the dense oracle at the
  reference test's 2e-5 (``tests/test_distributed.py``).
* A gradient through expert-parallel MoE: ``lm_loss`` of olmoe's reduced
  config with ``moe_impl="ep"`` on stacked (1, 1), (1, 2) and (1, 4)
  meshes, its gradients against the global dispatch's and the reference's
  at ``GRAD_TOL`` (``rtol=1e-4, atol=1e-6``, the gradient tolerance of
  ``test_torch_train.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.models import moe as jmoe
from repro.models.common import init_params as j_init_params
from repro_torch.models import moe as tmoe
from repro_torch.models.moe_ep import ep_moe_ffn, ep_tables
from repro_torch.parallel.compat import P, StackedMesh, use_mesh

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
EP_TOL = dict(rtol=2e-5, atol=2e-5)

# (MoEConfig fields, tokens, capacity=) — tests/test_models.py's two cases
# and one with an explicit capacity
CASES = {
    "ample": (dict(n_experts=8, top_k=2, d_model=32, d_ff=16, n_shared=1,
                   capacity_factor=8.0), 64, None),
    "overflow": (dict(n_experts=4, top_k=1, d_model=16, d_ff=8, capacity_factor=0.25), 32,
                 None),
    "capacity": (dict(n_experts=8, top_k=3, d_model=16, d_ff=8, n_shared=2), 40, 5),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name, seed=0):
    fields, T, cap = CASES[name]
    jcfg, tcfg = jmoe.MoEConfig(**fields), tmoe.MoEConfig(**fields)
    jp = j_init_params(jmoe.moe_defs(jcfg, jnp.float32), jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    x = np.random.default_rng(seed + 3).standard_normal((T, fields["d_model"])).astype(
        np.float32)
    return jcfg, tcfg, jp, tp, x, cap


def _reference_slots(jp, x, jcfg, cap, monkeypatch):
    """The reference's (E, C) slot table: its routed ``_expert_ffn`` call's
    (E, C, d) input, each row matched to the token it copies (T: pad)."""
    seen = []
    ffn = jmoe._expert_ffn

    def capture(wg, wi, wo, xe):
        seen.append(np.asarray(xe))
        return ffn(wg, wi, wo, xe)

    monkeypatch.setattr(jmoe, "_expert_ffn", capture)
    y, aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, capacity=cap)
    monkeypatch.setattr(jmoe, "_expert_ffn", ffn)
    xe = seen[0]
    xpad = np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)])
    match = (xe[:, :, None, :] == xpad[None, None]).all(-1)      # (E, C, T+1)
    assert (match.sum(-1) == 1).all()
    return match.argmax(-1), np.asarray(y), float(aux)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(name, monkeypatch):
    jcfg, tcfg, jp, tp, x, cap = _case(name)
    want_slots, want_y, want_aux = _reference_slots(jp, x, jcfg, cap, monkeypatch)
    y, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, capacity=cap)
    _, _, slots = tmoe._tables(tp, torch.from_numpy(x), tcfg, capacity=cap)
    assert slots.shape == want_slots.shape
    assert np.array_equal(slots.numpy(), want_slots)
    np.testing.assert_allclose(y.numpy(), want_y, **TOL)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_expert_ids_match_reference(name):
    jcfg, tcfg, jp, tp, x, _ = _case(name)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1))
    _, want = jax.lax.top_k(jnp.asarray(probs), jcfg.top_k)
    expert, _, _ = tmoe._tables(tp, torch.from_numpy(x), tcfg)
    srt = -np.sort(-probs, axis=-1)
    K = jcfg.top_k
    near = np.zeros(len(x), bool)
    if K < jcfg.n_experts:
        near = srt[:, K - 1] - srt[:, K] < 1e-6
    same = (expert.numpy() == np.asarray(want)).all(-1)
    assert same[~near].all()


def test_ample_capacity_matches_dense_oracle():
    """The reference's own check, in the port: with ample capacity the
    dispatch equals the dropless oracle; both oracles agree."""
    jcfg, tcfg, jp, tp, x, _ = _case("ample")
    xt = torch.from_numpy(x)
    y, aux = tmoe.moe_ffn(tp, xt, tcfg)
    oracle = tmoe.moe_ffn_dense_oracle(tp, xt, tcfg)
    torch.testing.assert_close(y, oracle, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(
        jmoe.moe_ffn_dense_oracle(jp, jnp.asarray(x), jcfg)), **TOL)
    assert float(aux) > 0.5


def test_overflow_drops_tokens():
    """Dropped tokens give zero rows; the rest equal the oracle."""
    jcfg, tcfg, jp, tp, x, _ = _case("overflow")
    xt = torch.from_numpy(x)
    y, _ = tmoe.moe_ffn(tp, xt, tcfg)
    oracle = tmoe.moe_ffn_dense_oracle(tp, xt, tcfg)
    dropped = (y == 0).all(-1)
    assert dropped.any() and not dropped.all()
    torch.testing.assert_close(y[~dropped], oracle[~dropped], rtol=2e-5, atol=2e-5)
    _, keep, slots = tmoe._tables(tp, xt, tcfg)
    C = tmoe.expert_capacity(len(x), tcfg)
    assert slots.shape == (tcfg.n_experts, C) and int(keep.sum()) == int((slots < len(x)).sum())
    assert torch.equal(dropped, ~keep.any(-1))


def test_decode_capacity_drops_as_the_reference():
    """At decode T = B, so C = 1 for olmoe's 64 experts top-8 at B = 4: two
    tokens that pick one expert keep the first. Reproduced, not fixed."""
    fields = dict(n_experts=64, top_k=8, d_model=16, d_ff=8)
    tcfg = tmoe.MoEConfig(**fields)
    assert tmoe.expert_capacity(4, tcfg) == 1
    jcfg = jmoe.MoEConfig(**fields)
    jp = j_init_params(jmoe.moe_defs(jcfg, jnp.float32), jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
    expert, keep, slots = tmoe._tables(tp, torch.from_numpy(x), tcfg)
    first = {}
    for t in range(4):
        for k in range(8):
            e = int(expert[t, k])
            assert bool(keep[t, k]) == (e not in first)
            first.setdefault(e, t)
    assert not keep.all()
    y, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)[0]),
                               **TOL)


# -- expert parallelism ---------------------------------------------------------------

EP_FIELDS = dict(n_experts=8, top_k=2, d_model=16, d_ff=8, n_shared=1, capacity_factor=8.0)


def _ep_case():
    """tests/test_distributed.py's case: x (8, 4, 16), the reference's
    parameters; the inputs from numpy."""
    jcfg, tcfg = jmoe.MoEConfig(**EP_FIELDS), tmoe.MoEConfig(**EP_FIELDS)
    jp = j_init_params(jmoe.moe_defs(jcfg, jnp.float32), jax.random.PRNGKey(0))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    x = np.random.default_rng(1).standard_normal((8, 4, 16)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (4, 2)])
def test_ep_moe_matches_oracle_on_stacked_meshes(shape):
    jcfg, tcfg, jp, tp, x = _ep_case()
    with use_mesh(StackedMesh(shape, device="cpu")):
        y, aux = ep_moe_ffn(tp, torch.from_numpy(x), tcfg)
    want = np.asarray(jmoe.moe_ffn_dense_oracle(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(y.numpy(), want, **EP_TOL)
    _, want_aux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_ep_tables_equal_global_dispatch(shape):
    """At data = 1 each partition's slot table is its experts' rows of the
    global table, and the kept assignments are the same."""
    _, tcfg, _, tp, x = _ep_case()
    xt = torch.from_numpy(x)
    _, keep, slots = tmoe._tables(tp, xt, tcfg)
    with use_mesh(StackedMesh(shape, device="cpu")):
        ep_keep, ep_slots = ep_tables(tp, xt, tcfg)
    assert torch.equal(ep_keep, keep) and torch.equal(ep_slots, slots)


def test_ep_2d_input_and_explicit_mesh():
    _, tcfg, _, tp, x = _ep_case()
    xt = torch.from_numpy(x).reshape(-1, 16)
    y, _ = ep_moe_ffn(tp, xt, tcfg, mesh=StackedMesh((2, 2), device="cpu"))
    torch.testing.assert_close(y, tmoe.moe_ffn_dense_oracle(tp, xt, tcfg), **EP_TOL)


def test_stacked_expert_shard_is_a_view_at_data_1():
    """The card runs EP at data = 1, where the stacked mesh's shard of the
    (E, d, f) expert weights is a view; at data > 1 every expert is copied
    once per data coordinate."""
    wg = torch.randn(8, 16, 8)
    one = StackedMesh((1, 4), device="cpu").shard(wg, P("model", None, None))
    assert one.shape == (4, 2, 16, 8) and one.data_ptr() == wg.data_ptr()
    assert one.reshape(8, 16, 8).data_ptr() == wg.data_ptr()
    two = StackedMesh((2, 4), device="cpu").shard(wg, P("model", None, None))
    assert two.shape == (8, 2, 16, 8) and two.data_ptr() != wg.data_ptr()
    assert torch.equal(two[4:], two[:4])


def test_rank_mesh_ep_equals_stacked(tmp_path):
    """(4, 2) over 8 gloo ranks, one subprocess with a time limit: y equal
    bit for bit to the stacked (4, 2) mesh on every rank (two partials, one
    add), aux within 1e-6 (gloo sums four shards in its own order)."""
    stacked = ranks.ep_moe_outputs(StackedMesh((4, 2), device="cpu"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"), "ep_moe",
                        "8", str(tmp_path)], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    cfg, params, x = ranks.ep_moe_inputs()
    oracle = tmoe.moe_ffn_dense_oracle(params, x, cfg).numpy()
    np.testing.assert_allclose(stacked["y"], oracle, **EP_TOL)
    for rank in range(8):
        out = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert np.array_equal(out["y"].view(np.uint32), stacked["y"].view(np.uint32))
        np.testing.assert_allclose(out["aux"], stacked["aux"], rtol=1e-6)


# the gradient tolerance of test_torch_train.py::test_lm_loss_and_grads_match_reference
# (EP_TOL above bounds the forward only)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def moe_lm_grads():
    """olmoe's reduced config: the reference's ``lm_loss`` and gradient and
    the port's under the global dispatch, on one numpy batch."""
    from repro.configs import get_arch as j_get_arch
    from repro.models import transformer as jtr
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as ttr
    from repro_torch.models.weights import tree_from_numpy
    from repro_torch.train.steps import value_and_grad
    jcfg = j_get_arch("olmoe-1b-7b").reduced_config()
    gcfg = get_arch("olmoe-1b-7b").reduced_config()
    jparams = j_init_params(jtr.lm_param_defs(jcfg), jax.random.PRNGKey(1))
    tparams = tree_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                              ttr.lm_param_defs(gcfg), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, gcfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jtr.lm_loss(p, batch, jcfg),
                                             has_aux=True))(jparams)
    gl, _, gg = value_and_grad(lambda p, b: ttr.lm_loss(p, b, gcfg), tparams, batch)
    return gcfg, tparams, batch, (float(jl), jax.tree_util.tree_leaves(jg)), (float(gl), gg)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4)])
def test_ep_lm_loss_gradient_matches_global_and_reference(shape, moe_lm_grads):
    """``lm_loss`` with ``moe_impl="ep"`` differentiates through
    ``ep_moe_ffn`` on a stacked mesh (at data = 1 every partition routes
    every token, so the kept assignments are the global dispatch's): its
    loss and gradients against the port's global dispatch and the
    reference's ``lm_loss`` gradient, at ``GRAD_TOL``. A gradient that
    skipped the experts would leave their weights at zero."""
    import dataclasses

    from repro_torch.models import transformer as ttr
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.steps import value_and_grad
    gcfg, tparams, batch, (jl, jg), (gl, gg) = moe_lm_grads
    ecfg = dataclasses.replace(gcfg, moe_impl="ep")
    with use_mesh(StackedMesh(shape, device="cpu")):
        el, _, eg = value_and_grad(lambda p, b: ttr.lm_loss(p, b, ecfg), tparams, batch)
    np.testing.assert_allclose(float(el), gl, rtol=1e-5)
    np.testing.assert_allclose(float(el), jl, rtol=1e-5)
    for e, g, j in zip(tree_leaves(eg), tree_leaves(gg), jg):
        np.testing.assert_allclose(e.numpy(), g.numpy(), **GRAD_TOL)
        np.testing.assert_allclose(e.numpy(), np.asarray(j), **GRAD_TOL)
    ffn = eg["layers"]["ffn"]
    assert all(float(ffn[k].abs().sum()) > 0 for k in ("wg", "wi", "wo", "router"))


def test_ep_remat_backward_on_another_thread_sees_the_forward_mesh(moe_lm_grads):
    """Autograd runs a CUDA backward on a thread of its own, where the
    forward's ambient mesh (a context variable) is unset; the remat'd
    layer's recompute must still find it. Here the backward runs on another
    thread on the CPU: the gradients equal the same thread's, bit for bit."""
    import dataclasses
    import threading

    from repro_torch.models import transformer as ttr
    from repro_torch.models.common import tree_leaves, tree_map
    gcfg, tparams, batch, _, _ = moe_lm_grads
    cfg = dataclasses.replace(gcfg, moe_impl="ep", remat=True)

    def grads(backward_elsewhere: bool):
        live = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
        with use_mesh(StackedMesh((1, 2), device="cpu")):
            loss, _ = ttr.lm_loss(live, batch, cfg)
        leaves = tree_leaves(live)
        out = {}

        def run():
            out["g"] = torch.autograd.grad(loss, leaves, allow_unused=True,
                                           materialize_grads=True)

        if backward_elsewhere:
            t = threading.Thread(target=run)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
        else:
            with use_mesh(StackedMesh((1, 2), device="cpu")):
                run()
        return out["g"]

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b)
