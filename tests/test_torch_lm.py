"""The port's LM serving path against the JAX package's transformer, on
the CPU in f32: ``lm_forward`` logits, ``lm_prefill`` logits and cache
(also with a prompt longer than the window, so the ring is rolled) and
three ``lm_decode`` steps, for the reduced configs of the three ported
archs and ``test_models.py``'s dense configs. The reference's own
``init_params`` values are carried across with ``params_from_numpy``;
tokens come from numpy.

Tolerance across packages: ``rtol=atol=1e-4`` on logits and caches. The
same f32 arithmetic runs in other orders (XLA's and PyTorch's matmuls, the
online vs the chunked softmax); the logits differ by a few 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jtr
from repro.models.common import init_params as j_init_params
from repro_torch.configs import family, get_arch
from repro_torch.models import transformer as ttr
from repro_torch.models.common import count_params, init_params, tree_leaves
from repro_torch.models.moe import MoEConfig
from repro_torch.models.weights import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = family("lm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small ops: one intra-op thread each keeps these
    tests from crowding the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# test_models.py's dense configs: (name, fields) built in both packages
DENSE = {
    "dense-gqa": dict(n_kv_heads=2),
    "swa-ring": dict(n_kv_heads=2, window=8),
    "gelu-partial-rope": dict(n_kv_heads=4, ffn_act="gelu", rope_pct=0.25),
}


def _configs(name):
    if name in DENSE:
        kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256,
                  **DENSE[name])
        return (jtr.LMConfig(dtype=jnp.float32, **kw),
                ttr.LMConfig(dtype=torch.float32, **kw))
    return j_get_arch(name).reduced_config(), get_arch(name).reduced_config()


def _models(name):
    jcfg, tcfg = _configs(name)
    params = j_init_params(jtr.lm_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, params_from_numpy(tree, tcfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ARCHS + list(DENSE))
def test_forward_prefill_decode_match_reference(name):
    jcfg, tcfg, jparams, model = _models(name)
    rng = np.random.default_rng(len(name))
    B, EXTRA = 2, 3
    S = 2 * (tcfg.window or 10) + 4          # past the window: the ring rolls
    toks = rng.integers(0, tcfg.vocab, (B, S + EXTRA)).astype(np.int32)

    want, _ = jtr.lm_forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = ttr.lm_forward(model, toks, tcfg, device="cpu")
    _close(got, want)
    assert float(aux) == 0.0

    for s in sorted({S, max(2, (tcfg.window or 10) // 2)}):   # and one inside the window
        jl, jcache = jtr.lm_prefill(jparams, jnp.asarray(toks[:, :s]), jcfg, max_len=s + EXTRA)
        tl, tcache = ttr.lm_prefill(model, toks[:, :s], tcfg, max_len=s + EXTRA, device="cpu")
        _close(tl, jl)
        assert set(tcache) == {"k", "v"}
        for key in ("k", "v"):
            assert tuple(tcache[key].shape) == jcache[key].shape
            _close(tcache[key], jcache[key])
        for t in range(EXTRA):
            tok = toks[:, s + t:s + t + 1]
            jl, jcache = jtr.lm_decode(jparams, jcache, jnp.asarray(tok), jnp.int32(s + t), jcfg)
            tl, tcache = ttr.lm_decode(model, tcache, tok, s + t, tcfg, device="cpu")
            _close(tl, jl)
            for key in ("k", "v"):
                _close(tcache[key], jcache[key])


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_defs_match_reference(name):
    """At full width, without allocating: every leaf's shape, axes and
    init, the leaf order and the parameter count equal the reference's."""
    jdefs = jtr.lm_param_defs(j_get_arch(name).full_config())
    cfg = get_arch(name).full_config()
    tdefs = ttr.lm_param_defs(cfg)
    jl = jax.tree_util.tree_leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes"))
    tl = tree_leaves(tdefs)
    assert [(d.shape, d.axes, d.init) for d in tl] == [(d.shape, d.axes, d.init) for d in jl]
    assert all(d.dtype == torch.bfloat16 for d in tl)
    assert count_params(tdefs) == cfg.param_count() == j_get_arch(name).full_config().param_count()
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, jdefs, is_leaf=lambda x: hasattr(x, "axes"))) \
        == jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, tdefs, is_leaf=lambda x: hasattr(x, "axes")))


def test_init_params_is_seeded():
    cfg = get_arch("h2o-danube-1.8b").reduced_config()
    defs = ttr.lm_param_defs(cfg)
    a, b = (init_params(defs, torch.Generator().manual_seed(3), "cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    model = ttr.LM(a, cfg)
    assert len(model.layers) == cfg.n_layers
    assert sum(p.numel() for p in model.parameters()) == count_params(defs)
    assert torch.equal(model.layers[1]["attn"]["wq"], a["layers"]["attn"]["wq"][1])
    assert torch.all(a["ln_f"] == 1) and torch.all(a["layers"]["ffn"]["wg"][0] != 0)


def test_params_from_numpy_refuses_mismatches():
    jcfg, tcfg = _configs("dense-gqa")
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jtr.lm_param_defs(jcfg),
                                                            jax.random.PRNGKey(0)))
    bad_shape = dict(tree, ln_f=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="ln_f: shape"):
        params_from_numpy(bad_shape, tcfg, device="cpu")
    bad_keys = dict(tree, extra=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(bad_keys, tcfg, device="cpu")
    with pytest.raises(ValueError, match="layers/attn: keys"):
        params_from_numpy(dict(tree, layers=dict(tree["layers"], attn={})), tcfg, device="cpu")


def test_mla_and_moe_are_refused():
    _, cfg = _configs("dense-gqa")
    for over in (dict(mla=ttr.MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16,
                                        v_dim=16)),
                 dict(moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32))):
        bad = dataclasses.replace(cfg, **over)
        for call in (lambda: ttr.lm_param_defs(bad),
                     lambda: ttr.make_cache(bad, 1, 8, device="cpu"),
                     lambda: ttr.LM({}, bad)):
            with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
                call()
