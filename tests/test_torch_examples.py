"""The port's search examples (``repro_torch.examples.{quickstart,
partitioned_search,serve_msmarco}``) against the reference's scripts
(``examples/*.py``) on the CPU: each reference script runs as a subprocess
(``JAX_PLATFORMS=cpu``, its own ``TMPDIR``; ``partitioned_search`` under 4
forced host devices, so its mesh half is the same (2, 2) mesh of 4
partitions that the port's stacked mesh runs), while the port's example runs
in this process with ``--device cpu``. Every printed line is compared after
``MASKS`` has replaced each field that comes from a measured wall time.

Compared as printed: the corpus line, ids, scores (2 decimals; the scores
themselves are held at rtol 1e-6 by the searchers' parity tests), the
``==``/``!=`` marks, cold counts in quickstart and the fleet half,
invocation counts (but the Poisson replay's, which include its hedges) and
backup-leg counts, the hedged functions, the mesh header's
shape and partition count, the mesh half's top-3 scores, the reindex line's
status and version, the fungibility and headline-cost numbers."""

import contextlib
import importlib
import io
import os
import pkgutil
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# (name, pattern, replacement, why the field is masked)
MASKS = (
    ("latency", r"(lat=|latency |\[cold|\[warm|p50|p99)\s*[\d.]+ ?ms", r"\1 <ms>",
     "modeled latency: the virtual clock adds each search's measured execution time"),
    ("dollars", r"(cost: |cost=|hedge tax: |of )\$[\d.]+", r"\1$<dollars>",
     "GB-seconds billed: the measured execution time of each invocation"),
    ("queries per dollar", r"(queries/\$: |→ )[\d,]+(?= \(paper| q/\$)", r"\1<q/$>",
     "the dollars above, inverted"),
    ("warm share", r"(warm=|\(warm\): )\d+%", r"\1<%>",
     "the fleet half's warm share and the replay's share under 300 ms: from latencies"),
    ("replay cold counts", r"(warm|cold) queries: \d+", r"\1 queries: <n>",
     "the Poisson replay's cold starts: whether an instance is free when a query "
     "arrives depends on the measured times before it"),
    ("replay fleet and hedges", r"fleet peak size: \d+ instances; hedged: \d+",
     "fleet peak size: <n> instances; hedged: <n>",
     "the replay's concurrency and its hedged queries: from measured times"),
    ("replay invocations", r"for \d+ queries →", "for <n> queries →",
     "the replay's ledger counts its hedged legs too (RuntimeConfig(hedge_after_s=0.5)), "
     "which fire from measured times"),
    ("refreshed instances", r"\d+ warm instances refreshed", "<n> warm instances refreshed",
     "the instances warm after the replay, which its concurrency set"),
    ("killed instance's next query", r"next query (cold-started new instance|served warm)",
     "next query <cold or warm>",
     "whether another warm instance is left after the kill: the replay's fleet"),
    ("replay wall", r"real wall time: [\d.]+s", "real wall time: <s>",
     "the host's clock"),
    ("mesh header", r"shard_map over (?:a stacked )?(\(\d+, \d+\)) (?:device )?mesh(?: on \S+)? "
     r"\((\d+) partitions\)", r"shard_map over \1 mesh (\2 partitions)",
     "the reference names its devices, the port the one device its stacked mesh is on; "
     "the shape and the partition count stay compared"),
)
EXAMPLES = {"quickstart": [], "partitioned_search": [],
            "serve_msmarco": ["--docs", "3000", "--queries", "60"]}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def masked(text: str) -> list[str]:
    lines = text.splitlines()
    for _, pattern, repl, _ in MASKS:
        lines = [re.sub(pattern, repl, line) for line in lines]
    return lines


def start_reference(name: str, argv: list[str], tmp: Path) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu", TMPDIR=str(tmp))
    if name == "partitioned_search":
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def run_port(name: str, argv: list[str], tmp: Path, monkeypatch) -> str:
    """The port's example in this process, on the CPU, with ``tmp`` as its
    temporary directory; its standard output."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    module = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main([*argv, "--device", "cpu"])
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_prints_what_the_reference_prints(name, tmp_path, monkeypatch):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref = start_reference(name, EXAMPLES[name], tmp_path / "ref")
    try:
        got = run_port(name, EXAMPLES[name], tmp_path / "port", monkeypatch)
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    want_lines, got_lines = masked(out), masked(got)
    assert got_lines == want_lines
    assert "!=" not in got and len(got_lines) >= 8
    hit = {mask for mask, pattern, _, _ in MASKS if re.search(pattern, got)}
    assert "latency" in hit            # the masks matched what they are for
    if name == "serve_msmarco":
        assert {"replay cold counts", "replay fleet and hedges", "replay invocations",
                "refreshed instances",
                "killed instance's next query", "replay wall"} <= hit
        assert "first query on v2: ok (version v2)" in got
        assert "fungibility: 10 QPS×10,000 s = $1.00 ≡ 100 QPS×1,000 s = $1.00" in got
    if name == "partitioned_search":
        assert "mesh header" in hit and "(4 partitions)" in got
        assert "batch Q=5: 4 invocations" in got and "5/5 top3 == oracle" in got
        assert "(5 backup legs)" in got


def test_chip_smoke_runs_every_example():
    """``chip_smoke.py``'s phase 16 names every module of
    ``repro_torch.examples``: a new example cannot miss the card."""
    import repro_torch.examples as examples
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    modules = {m.name for m in pkgutil.iter_modules(examples.__path__)}
    assert modules == {"quickstart", "partitioned_search", "serve_msmarco", "train_lm"}
    assert set(smoke.EXAMPLES) == modules
