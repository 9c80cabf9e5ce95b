"""The port's ``repro_torch.examples.train_lm`` against the reference's
``examples/train_lm.py`` on the CPU, at ``--steps 3 --fail-at 2``: the argv
that each hands its train launcher, and the launcher's ``restarts=`` /
``steps_lost=`` line. The reference runs as a subprocess (``JAX_PLATFORMS=cpu``)
whose launcher is wrapped to print the argv it was handed and then to keep
its files in the subprocess's own ``TMPDIR`` (the script names fixed
``/tmp`` paths); the port runs in this process with ``--device cpu`` and
``tempfile.tempdir`` pointed at a directory of the test's own. Losses are
not compared across packages: each launcher seeds its own initial weights,
and ``tests/test_torch_train.py`` holds the step itself to the reference.

A run's checkpoints (~1.2 GB each of a 100M model and its moments) are
deleted with the test's directory."""

import contextlib
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.examples import train_lm
from repro_torch.launch import train as train_launcher

ROOT = Path(__file__).resolve().parents[1]
DRILL = ["--steps", "3", "--fail-at", "2"]
METRICS = "train_lm_metrics.json"

# Runs examples/train_lm.py with repro.launch.train.main wrapped: it prints
# the argv the script hands it, then runs with the metrics file and the
# checkpoints moved into this process's temporary directory.
REFERENCE = textwrap.dedent("""
    import json, os, runpy, sys, tempfile
    from repro.launch import train
    run = train.main

    def handed():
        print("ARGV " + json.dumps(sys.argv[1:]), flush=True)
        i = sys.argv.index("--metrics-out")
        sys.argv[i + 1] = os.path.join(tempfile.gettempdir(), os.path.basename(sys.argv[i + 1]))
        sys.argv += ["--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_ckpt")]
        return run()

    train.main = handed
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
""")


@pytest.fixture()
def scratch():
    """A temporary directory removed after the test (not kept by pytest's
    retention of its base directories: it holds checkpoints of a 100M model)."""
    path = Path(tempfile.mkdtemp(prefix="train_lm_"))
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True)
def _four_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def run_port(argv: list[str], tmp: Path, monkeypatch) -> tuple[int, str, list]:
    """The port's example in this process on the CPU with ``tmp`` as its
    temporary directory: its exit code, its output and the argv it handed
    the launcher."""
    handed = []
    run = train_launcher.main

    def recording(launcher_argv):
        handed.append(list(launcher_argv))
        return run(launcher_argv)

    monkeypatch.setattr(train_launcher, "main", recording)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_lm.main([*argv, "--device", "cpu"])
    return rc, buf.getvalue(), handed


def restarts_line(out: str) -> tuple[int, int]:
    m = re.search(r"restarts=(\d+) steps_lost=(\d+)", out)
    assert m, out
    return int(m[1]), int(m[2])


def test_train_lm_hands_its_launcher_the_reference_argv(scratch, monkeypatch):
    (scratch / "ref").mkdir()
    (scratch / "port").mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TMPDIR=str(scratch / "ref"))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE,
                            str(ROOT / "examples" / "train_lm.py"), *DRILL],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        rc, out, handed = run_port(DRILL, scratch / "port", monkeypatch)
        ref_out, ref_err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, ref_err
    assert rc == 0
    want = json.loads(re.search(r"^ARGV (.*)$", ref_out, re.M)[1])
    assert len(handed) == 1
    got = handed[0]
    assert got[-2:] == ["--device", "cpu"]          # the one flag the port adds
    got = got[:-2]
    for argv in (want, got):                         # the file's name, each in its temp dir
        i = argv.index("--metrics-out")
        argv[i + 1] = os.path.basename(argv[i + 1])
    assert got == want
    assert handed[0][handed[0].index("--metrics-out") + 1] == str(scratch / "port" / METRICS)
    assert restarts_line(out) == restarts_line(ref_out) == (1, 1)
    # chip_smoke.py's phase 16 derives the steps lost from the same rule
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.train_lm_steps_lost(DRILL) == 1
    metrics = json.loads((scratch / "port" / METRICS).read_text())
    assert metrics["restarts"] == 1 and metrics["steps_lost"] == 1
    assert (scratch / "port" / "repro_torch_ckpt").is_dir()     # the launcher's default


def test_train_lm_second_run_in_one_tmpdir_resumes(scratch, monkeypatch):
    """The reference's quirk, kept: the launcher saves a checkpoint at the
    end of every run into the temporary directory and resumes from the
    latest one there, so a second run in one ``TMPDIR`` starts from the
    first one's weights."""
    argv = ["--steps", "1", "--batch", "1", "--seq", "16", "--fail-at"]
    rc, first, _ = run_port(argv, scratch, monkeypatch)
    assert rc == 0 and "resumed from checkpoint" not in first
    rc, second, _ = run_port(argv, scratch, monkeypatch)
    assert rc == 0 and "resumed from checkpoint step 1" in second
    loss = [float(re.search(r"step\s+0 loss ([\d.]+)", out)[1]) for out in (first, second)]
    assert loss[1] < loss[0]                 # the second run starts from trained weights
