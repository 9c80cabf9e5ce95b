"""The port's LM serving path against the JAX package's transformer, on
the CPU in f32: ``lm_forward`` logits and MoE aux loss, ``lm_prefill``
logits and cache (GQA k/v or the MLA latent; also with a prompt longer than
the window, so the ring is rolled) and three ``lm_decode`` steps, for the
reduced configs of the ported archs (dense, olmoe's MoE, deepseek-v2's MLA
+ MoE) and ``test_models.py``'s configs (dense, ``"moe"``, ``"mla-moe"``).
The reference's own ``init_params`` values are carried across with
``params_from_numpy``; tokens come from numpy. Then the reference's own
invariant in the port: prefill + decode reproduce the full forward.

Tolerance across packages: ``rtol=atol=1e-4`` on logits and caches, and
``rtol=1e-5`` on the aux loss. The same f32 arithmetic runs in other orders
(XLA's and PyTorch's matmuls, the online vs the chunked softmax); the
logits differ by a few 1e-6.
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
from repro.models.moe import MoEConfig as JMoEConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.weights import params_from_numpy
from repro_torch.parallel.compat import StackedMesh, use_mesh

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


# test_models.py's MoE configs: (name, (moe fields, mla fields or None))
MOE = {
    "moe": (dict(n_experts=8, top_k=2, d_model=64, d_ff=32, capacity_factor=4.0), None),
    "mla-moe": (dict(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared=1,
                     capacity_factor=4.0),
                dict(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16)),
}
NAMES = ARCHS + list(DENSE) + list(MOE)


def _configs(name):
    if name in DENSE or name in MOE:
        kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=256)
        jkw, tkw = {}, {}
        if name in DENSE:
            kw.update(DENSE[name])
        else:
            kw["n_kv_heads"] = 4
            moe, mla = MOE[name]
            jkw["moe"], tkw["moe"] = JMoEConfig(**moe), MoEConfig(**moe)
            if mla:
                jkw["mla"], tkw["mla"] = jtr.MLAConfig(**mla), ttr.MLAConfig(**mla)
        return (jtr.LMConfig(dtype=jnp.float32, **kw, **jkw),
                ttr.LMConfig(dtype=torch.float32, **kw, **tkw))
    return j_get_arch(name).reduced_config(), get_arch(name).reduced_config()


def _models(name):
    jcfg, tcfg = _configs(name)
    params = j_init_params(jtr.lm_param_defs(jcfg), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, params_from_numpy(tree, tcfg, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_decode_match_reference(name):
    jcfg, tcfg, jparams, model = _models(name)
    rng = np.random.default_rng(len(name))
    B, EXTRA = 2, 3
    S = 2 * (tcfg.window or 10) + 4          # past the window: the ring rolls
    toks = rng.integers(0, tcfg.vocab, (B, S + EXTRA)).astype(np.int32)

    want, want_aux = jtr.lm_forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = ttr.lm_forward(model, toks, tcfg, device="cpu")
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    keys = {"ckv", "krope"} if tcfg.mla is not None else {"k", "v"}

    for s in sorted({S, max(2, (tcfg.window or 10) // 2)}):   # and one inside the window
        jl, jcache = jtr.lm_prefill(jparams, jnp.asarray(toks[:, :s]), jcfg, max_len=s + EXTRA)
        tl, tcache = ttr.lm_prefill(model, toks[:, :s], tcfg, max_len=s + EXTRA, device="cpu")
        _close(tl, jl)
        assert set(tcache) == set(jcache) == keys
        for key in keys:
            assert tuple(tcache[key].shape) == jcache[key].shape
            _close(tcache[key], jcache[key])
        for t in range(EXTRA):
            tok = toks[:, s + t:s + t + 1]
            jl, jcache = jtr.lm_decode(jparams, jcache, jnp.asarray(tok), jnp.int32(s + t), jcfg)
            tl, tcache = ttr.lm_decode(model, tcache, tok, s + t, tcfg, device="cpu")
            _close(tl, jl)
            for key in keys:
                _close(tcache[key], jcache[key])


@pytest.mark.parametrize("name", ARCHS)
def test_full_width_defs_match_reference(name):
    """At full width, without allocating: every leaf's shape, axes and
    init, the leaf order, the parameter count and the active count equal
    the reference's."""
    jcfg = j_get_arch(name).full_config()
    jdefs = jtr.lm_param_defs(jcfg)
    cfg = get_arch(name).full_config()
    tdefs = ttr.lm_param_defs(cfg)
    jl = jax.tree_util.tree_leaves(jdefs, is_leaf=lambda x: hasattr(x, "axes"))
    tl = tree_leaves(tdefs)
    assert [(d.shape, d.axes, d.init) for d in tl] == [(d.shape, d.axes, d.init) for d in jl]
    # bf16, but the MoE router's f32, in both packages
    assert [str(d.dtype).removeprefix("torch.") for d in tl] == \
        [jnp.dtype(d.dtype).name for d in jl]
    assert {d.dtype for d in tl} == ({torch.bfloat16, torch.float32} if cfg.moe
                                     else {torch.bfloat16})
    assert count_params(tdefs) == cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.moe_impl == jcfg.moe_impl
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


@pytest.mark.parametrize("name", [n for n in NAMES if n not in ("olmoe-1b-7b",
                                                                "deepseek-v2-236b")])
def test_decode_matches_forward(name):
    """``test_models.py::test_lm_decode_matches_forward`` in the port, on its
    configs and the dense archs: prefill + decode steps reproduce the full
    forward's logits (its rtol/atol 2e-2 and 5e-2). Not on the MoE archs'
    reduced configs: their capacity factor 2 gives one slot an expert at
    decode (T = B = 2), so a decode step drops tokens that the forward
    keeps, in both packages."""
    _, tcfg, _, model = _models(name)
    B, S, EXTRA = 2, 12, 3
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S + EXTRA)).astype(np.int32)
    full, _ = ttr.lm_forward(model, toks, tcfg, device="cpu")
    logits, cache = ttr.lm_prefill(model, toks[:, :S], tcfg, max_len=S + EXTRA, device="cpu")
    torch.testing.assert_close(logits, full[:, S - 1], rtol=2e-2, atol=2e-2)
    for t in range(EXTRA):
        logits, cache = ttr.lm_decode(model, cache, toks[:, S + t:S + t + 1], S + t, tcfg,
                                      device="cpu")
        torch.testing.assert_close(logits, full[:, S + t], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("name,shape", [("olmoe-1b-7b", (1, 1)), ("olmoe-1b-7b", (1, 2)),
                                        ("mla-moe", (1, 2)), ("mla-moe", (2, 2))])
def test_expert_parallel_lm_matches_global_dispatch(name, shape):
    """``moe_impl="ep"`` (olmoe's and deepseek-v2's shipped dispatch) on a
    stacked mesh: the reference's logits and aux, and a cache equal to the
    global dispatch's. At data > 1 each shard sizes its capacity from its
    own tokens (as the reference's EP does), so that case takes the
    ample-capacity config."""
    jcfg, tcfg, jparams, model = _models(name)
    ep = dataclasses.replace(tcfg, moe_impl="ep")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    want, want_aux = jtr.lm_forward(jparams, jnp.asarray(toks), jcfg)
    _, base = ttr.lm_prefill(model, toks, tcfg, max_len=14, device="cpu")
    with use_mesh(StackedMesh(shape, device="cpu")):
        got, aux = ttr.lm_forward(model, toks, ep, device="cpu")
        _, cache = ttr.lm_prefill(model, toks, ep, max_len=14, device="cpu")
        for key in base:
            torch.testing.assert_close(cache[key], base[key], rtol=1e-5, atol=1e-6)
        logits, _ = ttr.lm_decode(model, cache, toks[:, :1], 12, ep, device="cpu")
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert bool(torch.isfinite(logits).all())


def test_ep_needs_a_mesh():
    _, tcfg, _, model = _models("olmoe-1b-7b")
    ep = dataclasses.replace(tcfg, moe_impl="ep")
    with pytest.raises(ValueError, match="no ambient mesh"):
        ttr.lm_forward(model, np.zeros((1, 4), np.int32), ep, device="cpu")


@pytest.mark.parametrize("name", ["moe", "mla-moe"])
def test_params_from_numpy_checks_moe_and_mla_subtrees(name):
    jcfg, tcfg = _configs(name)
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(jtr.lm_param_defs(jcfg),
                                                            jax.random.PRNGKey(0)))
    model = params_from_numpy(tree, tcfg, device="cpu")
    assert "router" in model.layers[0]["ffn"] and model.layers[0]["ffn"]["router"].dtype == \
        torch.float32
    assert ("shared_wg" in model.layers[0]["ffn"]) == (name == "mla-moe")
    ffn = {k: v for k, v in tree["layers"]["ffn"].items() if k != "router"}
    with pytest.raises(ValueError, match="layers/ffn: keys"):
        params_from_numpy(dict(tree, layers=dict(tree["layers"], ffn=ffn)), tcfg, device="cpu")
    attn = dict(tree["layers"]["attn"])
    key = "wkv_b" if name == "mla-moe" else "wq"
    attn[key] = attn[key][..., :-1]
    with pytest.raises(ValueError, match=f"layers/attn/{key}: shape"):
        params_from_numpy(dict(tree, layers=dict(tree["layers"], attn=attn)), tcfg, device="cpu")


def test_cache_spec_allocates_nothing():
    for name, keys in (("mla-moe", {"ckv": 16, "krope": 8}), ("moe", {"k": 16, "v": 16})):
        _, tcfg = _configs(name)
        spec = ttr.cache_spec(tcfg, 3, 20)
        jspec = jtr.cache_spec(_configs(name)[0], 3, 20)
        assert set(spec) == set(keys) == set(jspec)
        for key, t in spec.items():
            assert t.device.type == "meta" and tuple(t.shape) == jspec[key].shape
            assert t.shape[-1] == keys[key]


def test_mla_attn_decode_matches_reference():
    """``_mla_attn_decode`` (one token projected, then the absorbed
    attention over a partly filled latent cache) against the reference's."""
    jcfg, tcfg, jparams, model = _models("mla-moe")
    rng = np.random.default_rng(5)
    B, Sc, kv_len = 2, 9, 6
    m = tcfg.mla
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, Sc, m.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((B, Sc, m.rope_dim)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda t: t[0], jparams["layers"]["attn"])
    want, (wc, wr) = jtr._mla_attn_decode(jp, jnp.asarray(x), jcfg, jnp.asarray([kv_len - 1]),
                                          (jnp.asarray(ckv), jnp.asarray(kr)), kv_len)
    got, (gc, gr) = ttr._mla_attn_decode(model.layers[0]["attn"], torch.from_numpy(x), tcfg,
                                         torch.tensor([kv_len - 1]),
                                         (torch.from_numpy(ckv), torch.from_numpy(kr)), kv_len)
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        _close(g, w)
