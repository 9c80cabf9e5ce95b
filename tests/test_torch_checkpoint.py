"""The port's checkpoints, fault tolerance, meshes and training driver
against the JAX package's, on the CPU: ``save_pytree`` writes the
reference's bytes (manifest and every ``.npy``) for f32, int32 and bf16
leaves; a checkpoint written by either package restores in the other; the
manager's cadence, keep-last-K, async snapshot and restore-or-init;
``FailureInjector``, ``run_with_restarts``'s stats and ``StragglerMonitor``
step for step; the sharding rules and placements; and ``launch.train`` at
``--preset reduced --device cpu`` with ``--fail-at``, whose restarts and
lost steps equal the reference driver's. Everything here is exact.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jck
from repro.core.object_store import ObjectStore as JObjectStore
from repro.ft import faults as jft
from repro.parallel import sharding as jsh
from repro_torch.checkpoint import manager as tck
from repro_torch.core.object_store import ObjectStore
from repro_torch.ft import faults as tft
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.compat import P, StackedMesh, use_mesh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_state(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                       "b": np.zeros(8, np.float32),
                       "e": rng.normal(size=(3, 5)).astype(np.float32)},
            "opt": {"m": np.ones((8, 8), np.float32), "count": np.int32(3)},
            "seq": [rng.normal(size=(2,)).astype(np.float32), np.int32(7)]}


def _jax(tree, bf16=()):
    return jax.tree_util.tree_map(jnp.asarray, tree) if not bf16 else _with_bf16(tree, bf16, True)


def _torch(tree, bf16=()):
    return _with_bf16(tree, bf16, False)


def _with_bf16(tree, bf16, as_jax):
    def conv(path, a):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        if as_jax:
            return jnp.asarray(a, jnp.bfloat16 if key in bf16 else None)
        t = torch.tensor(np.asarray(a))
        return t.to(torch.bfloat16) if key in bf16 else t
    return jax.tree_util.tree_map_with_path(conv, tree)


@pytest.mark.parametrize("bf16", [(), ("params/w", "params/e")])
def test_saved_files_are_the_reference_bytes(bf16):
    state = _numpy_state()
    want = jck.save_pytree(_jax(state, bf16) if bf16 else _jax(state))
    got = tck.save_pytree(_torch(state, bf16))
    assert got.list() == want.list()
    for name in want.list():
        assert got.files[name] == want.files[name], name
    manifest = json.loads(got.files["manifest.json"])
    assert [m["key"] for m in manifest] == ["opt/count", "opt/m", "params/b", "params/e",
                                           "params/w", "seq/0", "seq/1"]
    if bf16:
        assert {m["dtype"] for m in manifest if m["key"] in bf16} == {"bfloat16"}


def test_checkpoints_restore_across_packages():
    state = _numpy_state(1)
    # the port's files into the reference (f32, int32)
    back = jck.load_pytree(tck.save_pytree(_torch(state)), state)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    # the reference's files, bf16 leaves too, into the port: the same bits
    bf16 = ("params/w",)
    like = _torch(state, bf16)
    got = tck.load_pytree(jck.save_pytree(_jax(state, bf16)), like)
    for a, b in zip(tck.tree_leaves_with_path(got), tck.tree_leaves_with_path(like)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="stale checkpoint"):
        tck.load_pytree(tck.save_pytree(_torch(state)),
                        {**like, "params": {**like["params"], "w": torch.zeros(4, 4)}})


def test_restore_onto_the_like_tree_or_placements():
    state = _torch(_numpy_state(2))
    d = tck.save_pytree(state)
    meta = jax.tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                  state)
    back = tck.load_pytree(d, meta)
    assert all(t.device.type == "cpu" for _, t in tck.tree_leaves_with_path(back))
    mesh = StackedMesh((1, 1), device="cpu")
    places = jax.tree_util.tree_map(lambda _: tsh.named(mesh, P()), state)
    back = tck.load_pytree(d, meta, shardings=places)
    for (_, a), (_, b) in zip(tck.tree_leaves_with_path(back), tck.tree_leaves_with_path(state)):
        assert torch.equal(a, b)


def test_manager_save_restore_gc_and_async_snapshot():
    mgr = tck.CheckpointManager(ObjectStore(), "t", tck.CheckpointConfig(
        every_steps=10, keep=2, async_save=False))
    for step in range(0, 50, 10):
        assert mgr.maybe_save(step, _torch(_numpy_state(step)))
    assert not mgr.maybe_save(15, _torch(_numpy_state()))
    assert mgr.latest_step() == 40 and len(mgr.catalog.versions("t")) <= 2
    restored, step = mgr.restore(_torch(_numpy_state()))
    assert step == 40
    assert torch.equal(restored["params"]["w"], _torch(_numpy_state(40))["params"]["w"])
    amgr = tck.CheckpointManager(ObjectStore(), "a", tck.CheckpointConfig(async_save=True))
    state = {"w": torch.ones(4)}
    amgr.save(0, state)
    state["w"].mul_(99.0)                  # mutated in place after the hand-off
    amgr.wait()
    back, _ = amgr.restore({"w": torch.empty(4, device="meta")})
    assert torch.equal(back["w"], torch.ones(4)) and amgr.saves == 1
    fresh = tck.CheckpointManager(ObjectStore(), "r", tck.CheckpointConfig(async_save=False))
    s1, step = fresh.restore_or_init(lambda: _torch(_numpy_state(1)))
    assert step == 0 and fresh.latest_step() is None
    fresh.save(7, s1)
    s2, step = fresh.restore_or_init(lambda: _torch(_numpy_state(2)))
    assert step == 7 and torch.equal(s2["params"]["w"], s1["params"]["w"])


@pytest.mark.parametrize("rate,seed,fail_at", [(0.0, 0, (3, 9)), (0.3, 5, ()),
                                               (0.15, 11, (4,))])
def test_failure_injector_and_restart_stats_equal_reference(rate, seed, fail_at):
    def inject(mod, n=60):
        inj, out = mod.FailureInjector(rate=rate, seed=seed, fail_at=fail_at), []
        for step in range(n):
            try:
                inj.check(step)
                out.append(0)
            except mod.InjectedFailure:
                out.append(1)
        return out

    assert inject(tft) == inject(jft)

    def run(mod, ck, store, wrap):
        mgr = ck.CheckpointManager(store, "t", ck.CheckpointConfig(every_steps=4,
                                                                    async_save=False))
        final, stats = mod.run_with_restarts(
            lambda s, step: {"x": s["x"] + step}, {"x": wrap(0.0)}, 25, mgr,
            injector=mod.FailureInjector(rate=rate, seed=seed, fail_at=fail_at),
            max_restarts=50)
        return float(final["x"]), (stats.restarts, stats.steps_lost, stats.steps_run)

    got = run(tft, tck, ObjectStore(), lambda v: torch.tensor(v))
    want = run(jft, jck, JObjectStore(), jnp.float32)
    assert got == want and got[0] == sum(range(25))


def test_run_with_restarts_gives_up():
    mgr = tck.CheckpointManager(ObjectStore(), "t", tck.CheckpointConfig(every_steps=5,
                                                                          async_save=False))
    with pytest.raises(tft.InjectedFailure):
        tft.run_with_restarts(lambda s, step: s, {"x": torch.zeros(())}, 10, mgr,
                              injector=tft.FailureInjector(rate=1.0), max_restarts=3)


def test_straggler_monitor_equals_reference():
    rng = np.random.default_rng(0)
    times = list(rng.exponential(0.1, 80)) + [5.0, 0.1, 0.1, 2.0]
    for kw in ({}, {"factor": 1.5, "window": 3, "warmup": 5}):
        got, want = tft.StragglerMonitor(**kw), jft.StragglerMonitor(**kw)
        assert [got.record(i, t) for i, t in enumerate(times)] == \
               [want.record(i, t) for i, t in enumerate(times)]
        assert got.flagged == want.flagged


def test_sharding_placements_and_meshes():
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import lm_param_defs
    cfg = get_arch("olmoe-1b-7b").reduced_config()
    defs = lm_param_defs(cfg)
    mesh = tmesh.make_host_mesh((1, 1), device="cpu")
    assert tmesh.mesh_devices(mesh) == 1 and mesh.shape == {"data": 1, "model": 1}
    places = tsh.param_shardings(defs, mesh, tsh.lm_rules(fsdp=True))
    assert places["layers"]["ffn"]["wg"].spec == P(None, "model", "data", None)
    assert places["embed"].device == torch.device("cpu")
    rules = tsh.lm_rules(fsdp=True)
    for axes in (("experts", "embed", "mlp"), ("embed", "embed"), ("vocab", "mlp")):
        assert tuple(rules.spec(axes)) == tuple(jsh.lm_rules(fsdp=True).spec(axes))
    assert tuple(rules.batch_spec(None)) == tuple(jsh.lm_rules().batch_spec(None))
    assert tuple(rules.with_pod().batch_spec()) == tuple(jsh.lm_rules().with_pod().batch_spec())
    prod = tmesh.make_production_mesh(multi_pod=True, device="cpu")
    assert prod.axis_names == ("pod", "data", "model") and prod.size == 512
    state = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    moved = tft.reshard_state(state, {"a": torch.device("cpu"), "b": {"c": tsh.named(mesh, P())}})
    assert moved["b"]["c"].device.type == "cpu" and torch.equal(moved["a"], state["a"])
    stacked = StackedMesh((2, 2), device="cpu")
    x = torch.arange(4.0).reshape(4, 1)
    with use_mesh(stacked):
        y = tsh.hierarchical_psum(x, inner="data", outer="model")
    assert torch.equal(y, torch.full((4, 1), 6.0))


def _launch(mod, monkeypatch, tmp_path, tag, extra=()):
    out = tmp_path / f"{tag}.json"
    argv = ["train", "--preset", "reduced", "--steps", "14", "--batch", "2", "--seq", "16",
            "--ckpt-every", "4", "--fail-at", "6", "11", "--log-every", "100",
            "--ckpt-dir", str(tmp_path / tag), "--metrics-out", str(out), *extra]
    if mod.__name__.startswith("repro_torch"):
        assert mod.main(argv[1:]) == 0
    else:
        monkeypatch.setattr(sys, "argv", argv)
        assert mod.main() == 0
    return json.loads(out.read_text())


def test_launcher_restarts_equal_reference(monkeypatch, tmp_path):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    got = _launch(ttrain, monkeypatch, tmp_path, "port", ("--device", "cpu"))
    want = _launch(jtrain, monkeypatch, tmp_path, "ref")
    assert (got["restarts"], got["steps_lost"]) == (want["restarts"], want["steps_lost"]) == (2, 3)
    assert [h["step"] for h in got["history"]] == [h["step"] for h in want["history"]]
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    with pytest.raises(NotImplementedError, match="item 10"):
        ttrain.main(["--mesh", "prod", "--device", "cpu"])
