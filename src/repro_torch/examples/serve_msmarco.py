"""End-to-end serving driver (the paper's kind of system): an MS-MARCO-like
passage corpus served through the serverless stack under a batched query
load, with the paper's measurements reported at the end — latency split
cold/warm, <300 ms check, queries-per-dollar, fungibility, and the §3
operations: batch reindex with zero-downtime switch-over, instance failure,
and straggler hedging. The port of ``examples/serve_msmarco.py``.

    python -m repro_torch.examples.serve_msmarco [--docs 50000]   # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_msmarco --device cpu \\
        --docs 3000 --queries 60
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.cost import fungibility_check, paper_headline_cost
from repro_torch.core.refresh import refresh_fleet
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.data.corpus import synth_corpus, synth_queries
from repro_torch.index.builder import IndexWriter, write_segment
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.searcher import SearchConfig
from repro_torch.search.service import build_search_app


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=30_000)
    ap.add_argument("--queries", type=int, default=400)
    ap.add_argument("--qps", type=float, default=25.0)
    ap.add_argument("--device", default=None,
                    help="the card when omitted (raises without one); 'cpu' on request")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"building corpus + index ({args.docs} docs)...")
    docs = synth_corpus(args.docs, vocab=max(4000, args.docs // 2), seed=0)
    queries = synth_queries(docs, args.queries, seed=1)
    app = build_search_app(
        docs,
        runtime_config=RuntimeConfig(memory_bytes=2 << 30, hedge_after_s=0.5),
        search_config=SearchConfig(k=10),
        device=device,
    )

    print(f"replaying {len(queries)} queries at {args.qps} QPS "
          "(Poisson arrivals)...")
    rng = np.random.default_rng(7)
    t = 0.0
    wall0 = time.perf_counter()
    for q in queries:
        t += float(rng.exponential(1.0 / args.qps))
        r = app.query(q, k=10, t_arrival=t)
        if not r.ok:
            raise RuntimeError(f"a replayed query failed: {r.status} {r.body}")
    wall = time.perf_counter() - wall0

    recs = app.runtime.records
    warm = sorted(r.latency_s for r in recs if not r.cold)
    cold = sorted(r.latency_s for r in recs if r.cold)
    led = app.runtime.ledger

    print("\n=== paper §2 scorecard (simulated end-to-end latencies) ===")
    print(f"warm queries: {len(warm)}  p50 {np.median(warm)*1e3:7.1f} ms  "
          f"p99 {np.quantile(warm, .99)*1e3:7.1f} ms   (paper budget < 300 ms)")
    if cold:
        print(f"cold queries: {len(cold)}  p50 {np.median(cold)*1e3:7.1f} ms  "
              "(container boot + index hydration)")
    print(f"under 300 ms (warm): {100 * np.mean(np.asarray(warm) < .3):.0f}%")
    print(f"fleet peak size: {app.runtime.fleet_size} instances; "
          f"hedged: {sum(r.hedged for r in recs)}")
    print(f"cost: ${led.total_dollars:.6f} for {led.invocations} queries → "
          f"{led.queries_per_dollar():,.0f} q/$  "
          f"(paper headline {paper_headline_cost():,.0f})")
    a, b = fungibility_check(10, 10_000, 100, 1_000)
    print(f"fungibility: 10 QPS×10,000 s = ${a:.2f} ≡ 100 QPS×1,000 s = ${b:.2f}")

    print("\n=== paper §3 operations drill ===")
    # batch reindex: add docs, publish v2 alongside v1, atomic switch + refresh
    extra = synth_corpus(1000, vocab=max(4000, args.docs // 2), seed=99)
    w = IndexWriter()
    w.add_many(docs + [(f"new-{i}", t_) for i, (_, t_) in enumerate(extra)])
    app.catalog.publish(app.asset, "v2", write_segment(w.pack()))
    n = refresh_fleet(app.runtime, app.asset)
    r = app.query(queries[0], t_arrival=app.runtime.clock + 1)
    print(f"reindex → v2 published, {n} warm instances refreshed, "
          f"first query on v2: {'ok' if r.ok else 'FAIL'} "
          f"(version {r.body['version']})")

    # failure injection: kill an instance; next query cold-starts a new one
    app.runtime.kill_instance()
    r = app.query(queries[1], t_arrival=app.runtime.clock + 0.01)
    print(f"instance killed → next query "
          f"{'cold-started new instance' if r.record.cold else 'served warm'}, "
          f"latency {r.latency_s * 1e3:.1f} ms")
    print(f"\n(real wall time: {wall:.1f}s for the replay)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
