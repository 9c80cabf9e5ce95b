"""Training driver: config → mesh → step → fault-tolerant loop, checkpoints
to the ObjectStore — the port of ``repro/launch/train.py``.

The conventional (non-serverless) half of the framework, bridged to the
paper's world by checkpointing into the same ObjectStore the serving fleet
hydrates from (paper §3 batch-rebuild → refresh).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --preset 100m --steps 300 --batch 16 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --preset reduced --device cpu

The reference's flags and output lines, and one more flag: ``--device``
(default: the card, raising without one; ``cpu`` on request). ``--mesh
host`` trains on that one device; ``--mesh prod`` and ``prod-multipod``
(sharded training) wait for ROADMAP Queue 1 item 10 and raise. The initial
parameters come from ``init_params`` with a ``torch.Generator`` seeded 0;
checkpoints go to a ``FilesystemBackend`` ObjectStore under ``--ckpt-dir``
(default: ``repro_torch_ckpt`` in the temporary directory), and a run
resumes from the latest one there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.cells import CELLS_PENDING, train_state_specs
from repro_torch.core.object_store import FilesystemBackend, ObjectStore
from repro_torch.data.lm import LMDataConfig, LMTokenStream
from repro_torch.ft.faults import FailureInjector, StragglerMonitor, run_with_restarts
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import init_params
from repro_torch.parallel.sharding import tree_named
from repro_torch.train.optim import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step


def _preset_100m(arch_mod, vocab: int = 8192):
    """~100M-param variant of an LM arch family (example driver scale),
    preserving the family's GQA ratio / MoE / MLA structure."""
    cfg = arch_mod.reduced_config()
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    return dataclasses.replace(cfg, n_layers=10, d_model=896, n_heads=14,
                               n_kv_heads=max(1, 14 // ratio), d_ff=2048, vocab=vocab)


def build_lm_training(arch: str, preset: str, batch: int, seq: int,
                      steps: int, lr: float):
    mod = get_arch(arch)
    if preset == "100m":
        cfg = _preset_100m(mod)
    elif preset == "reduced":
        cfg = mod.reduced_config()
    elif preset == "full":
        cfg = mod.full_config()
    else:
        raise ValueError(preset)

    from repro_torch.models.transformer import lm_loss, lm_param_defs
    defs = lm_param_defs(cfg)
    opt_cfg = OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                        total_steps=steps)
    step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt_cfg)
    data = LMTokenStream(LMDataConfig(vocab=cfg.vocab, batch=batch, seq=seq))
    return cfg, defs, step_fn, data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--preset", default="100m",
                    choices=["100m", "reduced", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "prod", "prod-multipod"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject failures at these steps (FT drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="the card when omitted (raises without one); 'cpu' on request")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("train driver currently drives LM archs; "
                         "see examples/ for GNN/recsys training")
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: sharded training and "
                                  f"{CELLS_PENDING}")
    device = resolve_device(args.device)

    cfg, defs, step_fn, data = build_lm_training(
        args.arch, args.preset, args.batch, args.seq, args.steps, args.lr)
    mesh = make_host_mesh((1, 1), device=device)
    shardings = tree_named(mesh, train_state_specs(defs, mod.rules()))

    store = ObjectStore(FilesystemBackend(args.ckpt_dir))
    ckpt = CheckpointManager(
        store, name=f"{args.arch}-{args.preset}",
        config=CheckpointConfig(every_steps=args.ckpt_every))

    def init_fn():
        params = init_params(defs, torch.Generator().manual_seed(0), device)
        return init_train_state(params)

    state, start = ckpt.restore_or_init(init_fn, shardings=shardings)
    if start:
        print(f"resumed from checkpoint step {start}")

    monitor = StragglerMonitor()
    injector = FailureInjector(fail_at=tuple(args.fail_at))
    history: list[dict] = []
    t_start = time.time()

    def one_step(state, step):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data.batch(step))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.record(step, dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms/step)")
        history.append({"step": step, "loss": loss, "sec": dt})
        return state

    state, stats = run_with_restarts(
        one_step, state, args.steps, ckpt, injector=injector)
    ckpt.save(args.steps, state)
    ckpt.wait()

    wall = time.time() - t_start
    print(f"done: {args.steps} steps in {wall:.1f}s; "
          f"restarts={stats.restarts} steps_lost={stats.steps_lost} "
          f"stragglers={len(monitor.flagged)}")
    first = np.mean([h["loss"] for h in history[:10]])
    last = np.mean([h["loss"] for h in history[-10:]])
    print(f"loss: first10={first:.4f} last10={last:.4f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"history": history, "restarts": stats.restarts,
                       "steps_lost": stats.steps_lost}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
