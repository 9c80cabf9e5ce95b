"""The port stands alone: every module of ``repro_torch`` (and
``chip_smoke.py``) imports with JAX and the JAX package unavailable, and the
entry points refuse to run without a card unless asked for the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's tests and fixtures: its many
    small ops then do not crowd the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        recsys = ["repro_torch.kernels.embedding_bag", "repro_torch.models.embedding",
                  "repro_torch.models.recsys", "repro_torch.data.recsys_data",
                  "repro_torch.configs.fm", "repro_torch.configs.dcn_v2",
                  "repro_torch.configs.bst", "repro_torch.configs.bert4rec"]
        assert set(recsys) <= set(names), sorted(set(recsys) - set(names))
        structured = ["repro_torch.search.query", "repro_torch.search.structured",
                      "repro_torch.core.autoscale"]
        assert set(structured) <= set(names), sorted(set(structured) - set(names))
        mesh = ["repro_torch.parallel", "repro_torch.parallel.compat",
                "repro_torch.search.distributed", "repro_torch.configs.anlessini"]
        assert set(mesh) <= set(names), sorted(set(mesh) - set(names))
        serve_moe = ["repro_torch.baselines.kvstore_search", "repro_torch.launch.serve",
                     "repro_torch.models.moe", "repro_torch.models.moe_ep",
                     "repro_torch.configs.olmoe_1b_7b", "repro_torch.configs.deepseek_v2_236b"]
        assert set(serve_moe) <= set(names), sorted(set(serve_moe) - set(names))
        train = ["repro_torch.train", "repro_torch.train.optim", "repro_torch.train.steps",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.manager", "repro_torch.ft",
                 "repro_torch.ft.faults", "repro_torch.launch.mesh", "repro_torch.launch.train",
                 "repro_torch.parallel.sharding", "repro_torch.configs.cells",
                 "repro_torch.configs.graphcast", "repro_torch.models.gnn",
                 "repro_torch.models.gather", "repro_torch.data.graphs"]
        assert set(train) <= set(names), sorted(set(train) - set(names))
        dry = ["repro_torch.launch.dryrun", "repro_torch.kernels.ops"]
        assert set(dry) <= set(names), sorted(set(dry) - set(names))
        examples = ["repro_torch.examples", "repro_torch.examples.quickstart",
                    "repro_torch.examples.partitioned_search",
                    "repro_torch.examples.serve_msmarco", "repro_torch.examples.train_lm"]
        assert set(examples) <= set(names), sorted(set(examples) - set(names))
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
    assert int(out.stdout.strip()) >= 68          # every module was walked


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
    from repro_torch.data.corpus import hash_embedder
    from repro_torch.search.oracle import DenseOracleSearcher, StructuredOracleSearcher
    from repro_torch.search.searcher import DenseSearcher, Searcher, make_search_handler
    from repro_torch.search.service import build_partitioned_search_app, build_search_app
    from repro_torch.search.structured import StructuredState
    from repro_torch.parallel.compat import RankMesh, StackedMesh, make_mesh
    from repro_torch.search.distributed import build_partitioned_state, stack_partitions
    docs = synth_corpus(20, vocab=50, seed=1)
    w = IndexWriter()
    w.add_many(docs)
    packed = w.pack()
    fielded = [(e, {"title": t[:10], "body": t}) for e, t in docs]
    vecs = np.zeros((20, 4), np.float32)
    for call in (lambda: resolve_device(None),
                 lambda: SearchState.from_packed(packed),
                 lambda: Searcher(packed),
                 lambda: DenseSearcher(vecs, [d for d, _ in docs], np.ones(20, bool)),
                 lambda: DenseOracleSearcher(docs, hash_embedder(4)),
                 lambda: make_search_handler(None, None),
                 lambda: build_search_app(docs),
                 lambda: build_partitioned_search_app(docs, 2),
                 lambda: StructuredState.from_packed(packed),
                 lambda: StructuredOracleSearcher(fielded),
                 lambda: build_partitioned_state(docs, 2),
                 lambda: stack_partitions([packed], 20),
                 lambda: StackedMesh((1, 2)),
                 lambda: RankMesh((1, 2)),
                 lambda: make_mesh((1, 2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Searcher(packed, device="cpu").search_one(docs[0][1].split()[0])
    state, cfg, _ = build_partitioned_state(docs, 2, device="cpu")
    assert state["block_docs"].device.type == "cpu" and cfg.n_parts == 2
    oracle = StructuredOracleSearcher(fielded, device="cpu")
    assert oracle.state.device.type == "cpu" and oracle.search(docs[0][1].split()[0])


def test_lm_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import (LM, lm_decode, lm_forward, lm_param_defs,
                                                lm_prefill, make_cache)
    from repro_torch.models.weights import params_from_numpy
    cfg = get_arch("h2o-danube-1.8b").reduced_config()
    defs = lm_param_defs(cfg)
    tree = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    model = LM(tree, cfg)
    toks = np.arange(6, dtype=np.int32).reshape(1, 6)
    cache = make_cache(cfg, 1, 8, device="cpu")
    numpy_tree = {"embed": tree["embed"].numpy()}
    for call in (lambda: init_params(defs, torch.Generator(), None),
                 lambda: params_from_numpy(numpy_tree, cfg),
                 lambda: make_cache(cfg, 1, 8),
                 lambda: lm_forward(model, toks, cfg),
                 lambda: lm_prefill(model, toks, cfg, max_len=8),
                 lambda: lm_decode(model, cache, toks[:, :1], 0, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    logits, cache = lm_prefill(model, toks, cfg, max_len=8, device="cpu")
    logits, cache = lm_decode(model, cache, logits.argmax(-1, keepdim=True), 6, cfg,
                              device="cpu")
    assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all())


def test_recsys_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys
    from repro_torch.models.common import init_params
    from repro_torch.models.weights import recsys_params_from_numpy
    cfg = get_arch("fm").reduced_config()
    defs = recsys.recsys_param_defs(cfg)
    params = init_params(defs, torch.Generator().manual_seed(0), "cpu")
    batch = {"sparse": np.arange(2 * cfg.n_sparse, dtype=np.int32).reshape(2, -1) % 7}
    cand = np.ones((30, cfg.embed_dim), np.float32)
    for call in (lambda: init_params(defs, torch.Generator(), None),
                 lambda: recsys_params_from_numpy({k: v.numpy() for k, v in params.items()},
                                                  cfg),
                 lambda: recsys.recsys_forward(params, batch, cfg),
                 lambda: recsys.user_vector(params, batch, cfg),
                 lambda: recsys.retrieval_topk(params, batch, cfg, cand, 5)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    b4r = get_arch("bert4rec").reduced_config()
    b4r_params = init_params(recsys.recsys_param_defs(b4r), torch.Generator(), "cpu")
    seq = np.zeros((2, b4r.seq_len), np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys.bert4rec_serve_topk(b4r_params, seq, b4r, k=5)
    assert recsys.recsys_forward(params, batch, cfg, device="cpu").shape == (2,)
    assert recsys.bert4rec_serve_topk(b4r_params, seq, b4r, k=5, device="cpu")[1].shape == (2, 5)


def test_serve_launcher_needs_a_card_unless_asked_for_cpu():
    """``launch.serve``: no ``--device`` (``device=None``) means the card and
    raises without one, before anything is built; ``--device cpu`` runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    import argparse

    from repro_torch.launch import serve
    args = dict(docs=60, queries=3, vocab=200, qps=20.0, k=5, memory_gb=2, partitions=0,
                replicas=1, hedge=0.0, kernel=True)
    for run, over in ((serve.run_single, {}), (serve.run_partitioned, dict(partitions=2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(argparse.Namespace(**dict(args, **over), device=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--docs", "60", "--queries", "3", "--vocab", "200"])
    out = serve.run_single(argparse.Namespace(**args, device="cpu"))
    assert out["queries"] == 3 and out["avg_hits"] > 0


def test_moe_lm_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import LM, lm_forward, lm_param_defs, make_cache
    for name in ("olmoe-1b-7b", "deepseek-v2-236b"):
        cfg = get_arch(name).reduced_config()
        model = LM(init_params(lm_param_defs(cfg), torch.Generator().manual_seed(0), "cpu"), cfg)
        toks = np.arange(6, dtype=np.int32).reshape(1, 6)
        for call in (lambda: lm_forward(model, toks, cfg), lambda: make_cache(cfg, 1, 8)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        logits, aux = lm_forward(model, toks, cfg, device="cpu")
        assert logits.shape == (1, 6, cfg.vocab) and float(aux) > 0


def test_training_entry_points_need_a_card_unless_asked_for_cpu():
    """``launch.train`` without ``--device`` and the meshes without a
    device mean the card, and raise without one, before anything is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    from repro_torch.launch import mesh, train
    from repro_torch.models.weights import train_state_from_numpy
    from repro_torch.models.gnn import gnn_param_defs
    from repro_torch.configs import get_arch
    defs = gnn_param_defs(get_arch("graphcast").reduced_config())
    for call in (lambda: train.main(["--preset", "reduced", "--steps", "1"]),
                 lambda: mesh.make_host_mesh(),
                 lambda: mesh.make_production_mesh(),
                 lambda: train_state_from_numpy({"params": {}, "opt": {}}, defs)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("name", ["quickstart", "partitioned_search", "serve_msmarco",
                                  "train_lm"])
def test_examples_need_a_card_unless_asked_for_cpu(name, tmp_path, monkeypatch):
    """``python -m repro_torch.examples.<name>`` without ``--device`` means
    the card, and raises without one before any work: nothing printed,
    nothing written to the temporary directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    import contextlib
    import importlib
    import io
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    module = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
    assert buf.getvalue() == "" and not any(tmp_path.iterdir())
