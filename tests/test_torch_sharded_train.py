"""Sharded training (``train.steps.make_sharded_train_step``) against the
single-device step and the JAX package's, on the CPU.

* 8 gloo ranks on a (4, 2) rank mesh, ``lm_rules(fsdp=True)``, stablelm-3b's
  reduced config, two steps from one numpy-made state at lr 1e-3 with one
  warmup step (``tests/torch_mesh_ranks.py``'s ``sharded_train`` case, one
  subprocess with a time limit), against the port's single-device step and
  the reference's, each step: the loss within 1e-4 and the first parameter
  leaf at ``rtol=atol=5e-4`` — the bounds of
  ``tests/test_distributed.py::test_sharded_train_step_matches_single_device``
  (gloo sums the ranks' gradients in its own order) — and, tighter than what
  the step changes, the grad norm to 1e-4 of itself (the mean over the
  batch axes; the clip reads it, and it is ~10, above ``clip_norm`` 1), every
  leaf's change to 5e-5 (each step moves a leaf by about lr, 1e-3) and every
  leaf's first moment (f32, (1 - b1) times the clipped gradient, at most
  ~1e-2) to 1e-6 + 1e-4 of itself;
* what compat's collectives moved in that step equals the dry run's
  ``collectives`` for those specs, and the plan's;
* on a stacked mesh the step is the host step: the same bits;
* ``launch.train --mesh prod`` gives ``--mesh host``'s losses bit for bit,
  and ``prod-multipod`` refuses a batch of 16, which does not split over
  pod × data = 32.
"""

import json
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
from repro.models import transformer as jtr
from repro.train import optim as jopt
from repro.train import steps as jsteps
from repro_torch.configs.cells import abstract_train_state, lm_cells, train_state_specs
from repro_torch.launch import dryrun
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import lm_loss
from repro_torch.parallel.compat import StackedMesh
from repro_torch.parallel.sharding import gather_tree, place_tree
from repro_torch.train.steps import (make_sharded_train_step, make_train_step,
                                     sharded_step_collectives)

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-4
PARAM_TOL = dict(rtol=5e-4, atol=5e-4)
NORM_RTOL = 1e-4
DELTA_TOL = dict(rtol=0, atol=5e-5)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_device() -> dict:
    """SHARDED_TRAIN_STEPS host steps: losses, grad norms, leaves, moments."""
    cfg, defs, leaves, batch, rules, opt = ranks.sharded_train_inputs()
    state = ranks.train_state(defs, leaves)
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt)
    losses, norms = [], []
    for _ in range(ranks.SHARDED_TRAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": [p.float().numpy() for p in tree_leaves(state["params"])],
            "m": [m.numpy() for m in tree_leaves(state["opt"]["m"])]}


def _reference() -> dict:
    """The same steps through the JAX package's jitted step."""
    cfg, defs, leaves, batch, rules, opt = ranks.sharded_train_inputs()
    from repro.configs import get_arch as j_get_arch
    jcfg = j_get_arch("stablelm-3b").reduced_config()
    jdefs = jtr.lm_param_defs(jcfg)
    _, treedef = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda d: 0, jdefs, is_leaf=lambda x: hasattr(x, "axes")))
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
    step = jax.jit(jsteps.make_train_step(lambda p, b: jtr.lm_loss(p, b, jcfg),
                                          jopt.OptConfig(lr=opt.lr,
                                                         warmup_steps=opt.warmup_steps)))
    state = jsteps.init_train_state(params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(ranks.SHARDED_TRAIN_STEPS):
        state, metrics = step(state, jbatch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": [np.asarray(p, np.float32)
                       for p in jax.tree_util.tree_leaves(state["params"])],
            "m": [np.asarray(m) for m in jax.tree_util.tree_leaves(state["opt"]["m"])]}


def test_eight_rank_step_matches_single_device_and_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    r = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
                        "sharded_train", "8", str(tmp_path)], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    cfg, defs, init, _, rules, opt = ranks.sharded_train_inputs()
    single, ref = _single_device(), _reference()
    assert single["grad_norm"][0] > opt.clip_norm            # the clip acts
    np.testing.assert_allclose(single["params"][0], ref["params"][0], **PARAM_TOL)
    sspecs = train_state_specs(defs, rules)
    bspecs = {"tokens": rules.batch_spec(None), "labels": rules.batch_spec(None)}
    plan = sharded_step_collectives(abstract_train_state(defs), sspecs, bspecs,
                                    StackedMesh((4, 2), device="meta"), n_metrics=3)
    cell = lm_cells("stablelm-3b", cfg, rules, reduced=True)["train_4k"]
    rec = dryrun.run_cell("stablelm-3b/train_4k", cell, StackedMesh((4, 2), device="meta"),
                          "4x2", tmp_path / "dry", verbose=False)
    assert rec["collectives"] == plan and plan["counts"]["all-gather"] > 0
    for rank in range(8):
        out = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert json.loads(str(out["collectives"])) == plan
        for want in (single, ref):
            np.testing.assert_allclose(out["loss"], want["loss"], rtol=0, atol=LOSS_ATOL)
            np.testing.assert_allclose(out["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)
            np.testing.assert_allclose(out["p0"], want["params"][0], **PARAM_TOL)
            for i, w0 in enumerate(init):
                np.testing.assert_allclose(out[f"p{i}"] - w0, want["params"][i] - w0,
                                           **DELTA_TOL, err_msg=f"leaf {i}'s change")
                np.testing.assert_allclose(out[f"m{i}"], want["m"][i], **MOMENT_TOL,
                                           err_msg=f"leaf {i}'s first moment")


def test_stacked_mesh_step_is_the_host_step_bitwise():
    cfg, defs, leaves, batch, rules, opt = ranks.sharded_train_inputs()
    mesh = StackedMesh((4, 2), device="cpu")
    sspecs = train_state_specs(defs, rules)
    bspecs = {"tokens": rules.batch_spec(None), "labels": rules.batch_spec(None)}
    step = make_sharded_train_step(lambda p, b: lm_loss(p, b, cfg), opt, mesh, sspecs, bspecs)
    state = place_tree(ranks.train_state(defs, leaves), sspecs, mesh)
    new, metrics = step(state, place_tree(batch, bspecs, mesh))
    single, m1 = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt)(
        ranks.train_state(defs, leaves), batch)
    for a, b in zip(tree_leaves(gather_tree(new, sspecs, mesh)), tree_leaves(single)):
        assert torch.equal(a, b)
    assert torch.equal(metrics["loss"], m1["loss"])
    with pytest.raises(ValueError, match="does not split"):
        place_tree({"tokens": np.zeros((6, 4), np.int32)}, {"tokens": bspecs["tokens"]}, mesh)


def test_launcher_prod_mesh_gives_host_losses_and_refuses_an_uneven_batch(tmp_path):
    from repro_torch.launch import train
    losses = {}
    for mesh in ("host", "prod"):
        out = tmp_path / f"{mesh}.json"
        argv = ["--preset", "reduced", "--device", "cpu", "--steps", "3", "--batch", "16",
                "--seq", "8", "--mesh", mesh, "--ckpt-dir", str(tmp_path / mesh),
                "--metrics-out", str(out), "--log-every", "100"]
        assert train.main(argv) == 0
        losses[mesh] = [h["loss"] for h in json.loads(out.read_text())["history"]]
    assert losses["prod"] == losses["host"] and len(losses["host"]) == 3
    with pytest.raises(ValueError, match="does not split"):
        train.main(["--preset", "reduced", "--device", "cpu", "--steps", "1", "--batch", "16",
                    "--seq", "8", "--mesh", "prod-multipod", "--ckpt-dir",
                    str(tmp_path / "multipod")])
