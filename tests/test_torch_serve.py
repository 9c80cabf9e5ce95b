"""The port's serve launcher (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``) on the CPU at a small size: the same JSON
keys; equal values where a value does not depend on measured wall time
(``EXACT_SINGLE``, ``EXACT_PARTITIONED``: counts and sizes, none of the
latency, warm-fraction, fleet-size, hedge or dollar figures, which the
modeled clock takes from each search's measured execution time); and
equal answer ids for every query, recorded by wrapping the app builders.
Then the CLI once, ``python -m repro_torch.launch.serve --device cpu``, in a
subprocess with a time limit."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import serve as jserve
from repro.search import service as jservice
from repro_torch.launch import serve as tserve
from repro_torch.search import service as tservice

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(docs=400, queries=20, vocab=20_000, qps=20.0, k=10, memory_gb=2, partitions=0,
             replicas=1, hedge=0.0, kernel=False)
EXACT_SINGLE = ("queries", "paper_headline_q_per_dollar", "index_bytes", "avg_hits")
EXACT_PARTITIONED = ("partitions", "replicas", "queries")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded(monkeypatch, module, name: str) -> list:
    """Wrap ``module.name`` (an app builder): the ids of every answer of the
    apps it builds go to the returned list."""
    answers = []
    build = getattr(module, name)

    def recording(*args, **kw):
        app = build(*args, **kw)
        query = app.query

        def answer(*qargs, **qkw):
            r = query(*qargs, **qkw)
            answers.append([str(i) for i in r.body["ids"]])
            return r

        app.query = answer
        return app

    monkeypatch.setattr(module, name, recording)
    return answers


def _args(**over):
    return argparse.Namespace(**dict(SMALL, **over))


@pytest.mark.parametrize("kernel", [False, True])
def test_run_single_matches_reference(monkeypatch, kernel):
    want_ids = _recorded(monkeypatch, jserve, "build_search_app")
    got_ids = _recorded(monkeypatch, tserve, "build_search_app")
    want = jserve.run_single(_args(kernel=kernel))
    got = tserve.run_single(_args(kernel=kernel, device="cpu"))
    assert list(got) == list(want)
    assert {k: got[k] for k in EXACT_SINGLE} == {k: want[k] for k in EXACT_SINGLE}
    assert len(got_ids) == SMALL["queries"] and got_ids == want_ids


@pytest.mark.parametrize("replicas", [1, 2])
def test_run_partitioned_matches_reference(monkeypatch, replicas):
    want_ids = _recorded(monkeypatch, jservice, "build_partitioned_search_app")
    got_ids = _recorded(monkeypatch, tservice, "build_partitioned_search_app")
    want = jserve.run_partitioned(_args(partitions=4, replicas=replicas))
    got = tserve.run_partitioned(_args(partitions=4, replicas=replicas, device="cpu"))
    assert list(got) == list(want)
    assert {k: got[k] for k in EXACT_PARTITIONED} == {k: want[k] for k in EXACT_PARTITIONED}
    assert len(got_ids) == SMALL["queries"] and got_ids == want_ids


def test_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--docs", "300", "--queries", "10", "--kernel"],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert list(got) == ["queries", "wall_s", "latency_p50_ms", "latency_p90_ms",
                         "latency_p99_ms", "warm_fraction", "fleet_size", "queries_per_dollar",
                         "paper_headline_q_per_dollar", "index_bytes", "avg_hits"]
    assert got["queries"] == 10 and got["avg_hits"] > 0
