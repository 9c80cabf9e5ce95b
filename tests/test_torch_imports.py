"""The port stands alone: every module of ``repro_torch`` (and
``chip_smoke.py``) imports with JAX and the JAX package unavailable, and the
entry points refuse to run without a card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_every_module_imports_without_jax_or_repro():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any import of jax now fails
        sys.modules["repro"] = None        # and so does any import of repro
        import repro_torch
        names = ["repro_torch"]
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            names.append(m.name)
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                     and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25          # every module was walked


def test_sources_name_neither_jax_nor_repro():
    """No import line of the port or of chip_smoke.py names jax or repro."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (f, s)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.data.corpus import synth_corpus
    from repro_torch.index.builder import IndexWriter
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.search.bm25 import SearchState
    from repro_torch.search.searcher import Searcher, make_search_handler
    from repro_torch.search.service import build_search_app
    docs = synth_corpus(20, vocab=50, seed=1)
    w = IndexWriter()
    w.add_many(docs)
    packed = w.pack()
    for call in (lambda: resolve_device(None),
                 lambda: SearchState.from_packed(packed),
                 lambda: Searcher(packed),
                 lambda: make_search_handler(None, None),
                 lambda: build_search_app(docs)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Searcher(packed, device="cpu").search_one(docs[0][1].split()[0])
