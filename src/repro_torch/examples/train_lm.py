"""Train a ~100M-parameter LM for a few hundred steps, with the production
substrate: the sharded train step, checkpointing to the object store,
failure injection mid-run, and automatic restart recovery. The port of
``examples/train_lm.py``: it hands ``repro_torch.launch.train.main`` the
reference's argv, and ``--device`` when given.

This is the conventional-training half of the framework; its checkpoints
land in the same ObjectStore the serving fleet hydrates from (paper §3's
batch-rebuild → refresh bridge).

The metrics file and the launcher's checkpoints both go to the temporary
directory (``tempfile.gettempdir()``), and a run resumes from the latest
checkpoint there, as the reference's does from its fixed ``/tmp`` one: give
each fresh run a ``TMPDIR`` of its own.

    # the drill (~100M model, 30 steps + failure recovery), on the card:
    python -m repro_torch.examples.train_lm
    # a short one on the CPU:
    TMPDIR=$(mktemp -d) PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --device cpu --steps 3 --fail-at 2
    # the full few-hundred-step run:
    python -m repro_torch.examples.train_lm --steps 300 --batch 16 --seq 256
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as train_mod


def parser() -> argparse.ArgumentParser:
    """The reference's flags, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[18])
    ap.add_argument("--device", default=None,
                    help="the card when omitted (raises without one); 'cpu' on request")
    return ap


def launcher_argv(args: argparse.Namespace) -> list[str]:
    """The argv that the example hands ``repro_torch.launch.train.main``."""
    argv = [
        "--arch", args.arch, "--preset", "100m",
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq", str(args.seq), "--ckpt-every", "50",
        "--metrics-out", os.path.join(tempfile.gettempdir(), "train_lm_metrics.json"),
    ]
    if args.fail_at:
        argv += ["--fail-at"] + [str(x) for x in args.fail_at]
    if args.device is not None:
        argv += ["--device", args.device]
    return argv


def main(argv=None) -> int:
    return train_mod.main(launcher_argv(parser().parse_args(argv)))

if __name__ == "__main__":
    raise SystemExit(main())
