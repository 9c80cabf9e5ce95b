#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port: drive the single-node BM25 query
path on one NVIDIA GPU and hold every hand-written kernel against its plain
PyTorch twin.

    python3 chip_smoke.py                 # 1M-doc partition (the default)
    python3 chip_smoke.py --docs 250000   # a smaller partition

Phases (each raises on failure; the script then exits non-zero):
  1. the card: name, power limit, CUDA version;
  2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. a synthetic 1M-passage partition (MS MARCO-like passage length, the
     anlessini config's 2^19 vocab), published and served by
     ``build_search_app`` with the pruned + kernels config on the card;
  4. K3, K2 and K1 against their twins on that index's real gathered
     blocks for Q=1 and Q=64, bitwise, and K1 against the dense plain path;
     per-kernel times with CUDA events beside the twin's, a library call's
     and the least time the card could take; warm latency of the pruned +
     kernels, dense + kernels and dense plain searchers, paired query by
     query;
  5. end to end through the gateway: one cold query, 20 warm queries and a
     64-query micro-batch on the pruned + kernels route (K1, K2), the dense
     + kernels route (K3, K2) and the dense plain route (no kernel), every
     answer equal (ids, score bits) to the dense plain route's. The launch
     counters are set to 0 before each route and read after it: each route
     must launch its kernels and no other.

Prints the kernels JSON line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

K = 10
N_QUERIES = 64
MAX_BLOCKS = 64
MAX_TERMS = 16
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``reps``
    calls after three warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(a, b) -> bool:
    a = a.detach().cpu().contiguous().numpy()
    b = b.detach().cpu().contiguous().numpy()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.uint32), b.view(np.uint32))
    return np.array_equal(a, b)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().cpu()) if a.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def kernel_phase(searcher, queries, torch, bm25, ref, kern):
    """Phase 4: every kernel against its twin on real gathered blocks."""
    state = searcher.state
    n_docs = state.n_docs
    tids, qtf = bm25.encode_queries(searcher.vocab, queries, max_terms=MAX_TERMS,
                                    idf=searcher.packed.idf)
    dense_plain = bm25.make_search_fn(n_docs, max_terms=MAX_TERMS, max_blocks=MAX_BLOCKS,
                                      k=K)
    rows = {}
    for Q in (1, len(queries)):
        t = torch.as_tensor(tids[:Q]).to(state.device)
        w = torch.as_tensor(qtf[:Q]).to(state.device)
        docs, tf, bmax, valid = bm25.gather_query_blocks(state, t, MAX_BLOCKS)
        tid = torch.clamp(t, min=0).long()
        idf_q = state.idf[tid] * w
        dl = state.doc_len[torch.clamp(docs, max=n_docs).long()]
        params = state.params
        postings = docs.numel()

        # K3
        k3 = lambda: kern["K3"](tf, dl, idf_q, *params)              # noqa: E731
        k3_twin = lambda: ref.bm25_block_scores_ref(tf, dl, idf_q, *params)  # noqa: E731
        got, want = k3(), k3_twin()
        torch.cuda.synchronize()
        require(bits_equal(got, want), f"K3 != twin at Q={Q}")
        rows.setdefault("K3", {})[Q] = dict(
            err=max_abs_err(got, want), ms=cuda_ms(k3), plain_ms=cuda_ms(k3_twin),
            library_ms=None,
            bound=bound_ms(postings * 9 + idf_q.numel() * 4, postings * 7))

        # K2, over the dense accumulator of these queries
        acc = bm25.score_dense(state, t, w, max_blocks=MAX_BLOCKS)
        k2 = lambda: kern["K2"](acc, K)                            # noqa: E731
        k2_twin = lambda: ref.topk_ref(acc, K)                     # noqa: E731
        (gv, gi), (wv, wi) = k2(), k2_twin()
        torch.cuda.synchronize()
        require(bits_equal(gv, wv) and bits_equal(gi, wi), f"K2 != twin at Q={Q}")
        rows.setdefault("K2", {})[Q] = dict(
            err=max_abs_err(gv, wv), ms=cuda_ms(k2), plain_ms=cuda_ms(k2_twin),
            library_ms=cuda_ms(lambda: torch.topk(acc, K, dim=-1)),
            bound=bound_ms(acc.numel() * 4 + Q * K * 8, acc.numel()))

        # K1
        tf_p = torch.where(valid, tf, 0)
        ub = torch.where(valid[..., 0], w[..., None] * bmax, 0.0)
        args = (tf_p, dl, docs, idf_q, ub, valid[..., 0], *params)
        k1 = lambda: kern["K1"](*args, k=K, n_docs=n_docs)          # noqa: E731
        k1_twin = lambda: ref.bm25_pruned_topk_ref(*args, k=K, n_docs=n_docs)  # noqa: E731
        (gv, gi, gt), (wv, wi, wt) = k1(), k1_twin()
        dv, di = dense_plain(state, t, w)
        torch.cuda.synchronize()
        require(bits_equal(gv, wv) and bits_equal(gi, wi) and bits_equal(gt, wt),
                f"K1 != twin at Q={Q}")
        require(bits_equal(gv, dv) and bits_equal(gi, di), f"K1 != dense plain at Q={Q}")
        touched = int(gt.sum())
        kept = touched * docs.shape[-1]
        rows.setdefault("K1", {})[Q] = dict(
            err=max_abs_err(gv, wv), ms=cuda_ms(k1), plain_ms=cuda_ms(k1_twin),
            library_ms=None, touched=touched, valid=int(valid.sum()),
            bound=bound_ms(kept * 9 + Q * MAX_TERMS * (4 + MAX_BLOCKS * 5) + Q * (K * 8 + 4),
                           kept * 8))
        for name in ("K3", "K2", "K1"):
            r = rows[name][Q]
            print(f"[4] {name} Q={Q}: bitwise == twin; kernel {r['ms']:.4f} ms, twin "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                  f"{r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
        print(f"[4] K1 Q={Q}: touched {rows['K1'][Q]['touched']} of "
              f"{rows['K1'][Q]['valid']} valid blocks; top-k == dense plain path", flush=True)
    return rows


def latency_phase(searcher, queries, torch, configs, reps: int = 5):
    """Measured time of the searcher's device call (encode → scores on the
    host, ``.cpu()`` included) per config, paired: each query runs on every
    config in turn, the order rotated from call to call, ``reps`` passes over
    the queries (``reps·len(queries)`` warm single-query samples per config),
    then ``2·reps`` micro-batches of all queries per config, interleaved the
    same way. Then a profiler window over five warm queries per config."""
    from repro_torch.search.searcher import Searcher
    names = list(configs)
    searchers = {name: Searcher(searcher.packed, cfg) for name, cfg in configs.items()}
    for s in searchers.values():
        s.search_batch(queries[:1])
        s.search_batch(queries)                          # warm both shapes
    singles = {name: [] for name in names}
    batches = {name: [] for name in names}

    def timed(name, qs, into):
        t0 = time.perf_counter()
        searchers[name].search_batch(qs)
        into[name].append((time.perf_counter() - t0) * 1e3)

    for r in range(reps):
        for i, q in enumerate(queries):
            for j in range(len(names)):
                timed(names[(i + r + j) % len(names)], [q], singles)
    for r in range(2 * reps):
        for j in range(len(names)):
            timed(names[(r + j) % len(names)], queries, batches)
    out = {}
    for name in names:
        t, bt = np.array(singles[name]), np.array(batches[name])
        out[name] = dict(p50=float(np.percentile(t, 50)), p99=float(np.percentile(t, 99)),
                         batch_p50=float(np.percentile(bt, 50)))
        print(f"[4] {name}: warm search_batch over {t.size} paired samples p50 "
              f"{out[name]['p50']:.3f} ms p99 {out[name]['p99']:.3f} ms; {len(queries)}-query "
              f"batch over {bt.size} samples p50 {out[name]['batch_p50']:.3f} ms (min "
              f"{bt.min():.3f}, max {bt.max():.3f})", flush=True)
    base = names[-1]
    for name in names[:-1]:
        ratio = np.array(singles[name]) / np.array(singles[base])
        bratio = np.array(batches[name]) / np.array(batches[base])
        print(f"[4] {name} / {base}, same query and pass: single-query ratio p50 "
              f"{np.percentile(ratio, 50):.3f} (p10 {np.percentile(ratio, 10):.3f}, p90 "
              f"{np.percentile(ratio, 90):.3f}); batch ratio p50 "
              f"{np.percentile(bratio, 50):.3f}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name in names:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for q in queries[1:6]:
                searchers[name].search_batch([q])
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(e.self_device_time_total for e in events)
        print(f"[4] profile {name}, 5 warm queries: wall {wall * 1e3:.3f} ms, device busy "
              f"{dev_us / 1e3:.3f} ms ({dev_us / 1e4 / wall:.1f}% busy)", flush=True)
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
            if e.self_device_time_total > 0:
                print(f"[4]   {e.key[:60]:60s} {e.self_device_time_total:10.1f} us "
                      f"x{e.count}", flush=True)
    return out


# The kernels each gateway route must launch; every other kernel must stay at 0.
PATHS = {"/search": ("K1", "K2"), "/search-dense-kernels": ("K3", "K2"), "/search-plain": ()}
# The route whose run gives each kernel's ``launches`` in the kernels line.
COUNTED_ON = {"K1": "/search", "K2": "/search", "K3": "/search-dense-kernels"}


def gateway_phase(app, queries, torch, kern):
    """Phase 5: cold, warm and batched queries through the gateway on each
    route. The launch counters are set to 0 just before each route's run and
    read just after it; the kernel routes' answers must equal the plain
    route's."""
    body = lambda q: {"k": K, "fetch_docs": True, **(                  # noqa: E731
        {"q": q} if isinstance(q, str) else {"queries": list(q)})}
    answers, launches = {}, {}
    for route, expected in PATHS.items():
        for fn in kern.values():
            fn.launches = 0
        got = [app.gateway.request("GET", route, body(queries[0]))]
        for q in queries[1:21]:
            got.append(app.gateway.request("GET", route, body(q)))
        got.append(app.gateway.request("GET", route, body(queries)))
        launches[route] = {name: fn.launches for name, fn in kern.items()}
        answers[route] = got
        for name, n in launches[route].items():
            require((n > 0) == (name in expected),
                    f"{route}: kernel {name} launched {n} times, expected "
                    f"{'some' if name in expected else 'none'}")
        print(f"[5] {route}: launches {launches[route]}", flush=True)
    plain = answers["/search-plain"]
    for route in ("/search", "/search-dense-kernels"):
        for i, (r, p) in enumerate(zip(answers[route], plain)):
            require(r.status == 200 and p.status == 200,
                    f"{route} request {i}: status {r.status}/{p.status} {r.body}")
            rs = r.body["results"] if "results" in r.body else [r.body]
            ps = p.body["results"] if "results" in p.body else [p.body]
            for a, b in zip(rs, ps):
                require(a["ids"] == b["ids"] and a["ext_ids"] == b["ext_ids"],
                        f"{route} request {i}: ids differ from the plain path")
                require(np.array_equal(np.float32(a["scores"]).view(np.uint32),
                                       np.float32(b["scores"]).view(np.uint32)),
                        f"{route} request {i}: score bits differ from the plain path")
                require(all(np.isfinite(a["scores"])) and a["scores"] == sorted(
                    a["scores"], reverse=True), f"{route}: scores not finite/descending")
        require(len(rs) == len(queries), f"{route}: micro-batch answered {len(rs)}")
    recs = {fn: [r for r in app.runtime.records if r.fn == fn]
            for fn in ("search", "search-dense-kernels", "search-plain")}
    for fn, rs in recs.items():
        warm = np.array([r.exec_s for r in rs[1:21]]) * 1e3
        cold = rs[0]
        require(cold.cold and not any(r.cold for r in rs[1:]), f"{fn}: cold/warm pattern")
        print(f"[5] {fn}: cold hydrate_s {cold.hydrate_s:.4f} (modeled), cold exec "
              f"{cold.exec_s * 1e3:.1f} ms; warm exec_s p50 {np.percentile(warm, 50):.3f} ms "
              f"p99 {np.percentile(warm, 99):.3f} ms; 64-query batch exec "
              f"{rs[-1].exec_s * 1e3:.3f} ms", flush=True)
    print(f"[5] all answers equal the dense plain path; launches per route "
          f"{json.dumps(launches)}", flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.core.runtime import RuntimeConfig
        from repro_torch.data.corpus import synth_corpus, synth_queries
        from repro_torch.kernels import backend, ref
        from repro_torch.kernels.bm25_block import bm25_block_scores
        from repro_torch.kernels.bm25_pruned import bm25_pruned_topk
        from repro_torch.kernels.topk import topk
        from repro_torch.search import bm25
        from repro_torch.search.searcher import (SearchConfig, hydrate_searcher,
                                                 make_search_handler)
        from repro_torch.search.service import build_search_app
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}", file=sys.stderr)
        return 2
    require(not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
                    for m in sys.modules), "JAX or the JAX package was imported")
    kern = {"K3": bm25_block_scores, "K2": topk, "K1": bm25_pruned_topk}

    # 1. the card
    smi = nvidia_smi()
    print(f"[1] {torch.cuda.get_device_name(0)} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {torch.cuda.device_count()} device(s)", flush=True)

    # 2. build
    t0 = time.perf_counter()
    out = backend.build()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s into {out}", flush=True)
    for name in backend.SOURCES:
        for line in (out / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2] {name}: {line.strip()}", flush=True)

    # 3. data at real scale
    t0 = time.perf_counter()
    docs = synth_corpus(args.docs, vocab=1 << 19, mean_len=60, seed=0)
    t1 = time.perf_counter()
    pruned_cfg = SearchConfig(accumulator="pruned", use_kernel=True, use_topk_kernel=True)
    app = build_search_app(docs, search_config=pruned_cfg,
                           runtime_config=RuntimeConfig(seed=0))
    for fn, cfg in (("search-dense-kernels", SearchConfig(use_kernel=True, use_topk_kernel=True)),
                    ("search-plain", SearchConfig())):
        app.runtime.register(fn, make_search_handler(app.catalog, app.doc_store, app.asset, cfg))
        app.gateway.route("GET", f"/{fn}", fn)
    t2 = time.perf_counter()
    searcher, sim_s = hydrate_searcher(app.catalog, app.asset, pruned_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    queries = synth_queries(docs, N_QUERIES, seed=1)
    p = searcher.packed
    print(f"[3] {args.docs} docs: corpus {t1 - t0:.1f} s, index+publish {t2 - t1:.1f} s, "
          f"hydrate {t3 - t2:.1f} s (modeled {sim_s:.3f} s); n_blocks {p.block_docs.shape[0]}, "
          f"vocab {len(p.vocab)}, packed {p.nbytes} B, SearchState on device "
          f"{searcher.state.nbytes} B", flush=True)

    # 4. kernels against twins
    rows = kernel_phase(searcher, queries, torch, bm25, ref, kern)
    latency_phase(searcher, queries, torch, {
        "pruned+kernels": pruned_cfg,
        "dense+kernels": SearchConfig(use_kernel=True, use_topk_kernel=True),
        "dense plain": SearchConfig()})
    del searcher
    torch.cuda.empty_cache()

    # 5. the main path through the gateway
    torch.cuda.reset_peak_memory_stats()
    launches = gateway_phase(app, queries, torch, kern)
    print(f"[5] max_memory_allocated {torch.cuda.max_memory_allocated()} B", flush=True)

    Q = len(queries)
    meta = {
        "K3": ("bm25_block_scores", "src/repro_torch/kernels/csrc/bm25_block.cu",
               "src/repro/kernels/bm25_block.py:61"),
        "K2": ("topk", "src/repro_torch/kernels/csrc/topk.cu", "src/repro/kernels/topk.py:70"),
        "K1": ("bm25_pruned_topk", "src/repro_torch/kernels/csrc/bm25_pruned.cu",
               "src/repro/kernels/bm25_pruned.py:172"),
    }
    line = {"kernels": [
        {"name": meta[n][0], "route": "cuda", "source": meta[n][1], "replaces": meta[n][2],
         "launches": launches[COUNTED_ON[n]][n], "launches_on": COUNTED_ON[n],
         "launches_by_route": {route: c[n] for route, c in launches.items()},
         "max_abs_err": rows[n][Q]["err"], "ms": rows[n][Q]["ms"],
         "plain_ms": rows[n][Q]["plain_ms"], "bound_ms": rows[n][Q]["bound"][0],
         "bound_by": rows[n][Q]["bound"][1], "library_ms": rows[n][Q]["library_ms"],
         "shape": f"Q={Q}, T={MAX_TERMS}, M={MAX_BLOCKS}, B=128, n_docs={args.docs}"}
        for n in ("K3", "K2", "K1")]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
