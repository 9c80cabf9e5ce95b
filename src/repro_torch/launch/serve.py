"""Serving launcher — the paper's architecture end to end (Figure 1); the
port of ``repro/launch/serve.py``.

Builds the full serverless stack on a synthetic MS-MARCO-like corpus:
ObjectStore (S3) ← index segments, KVStore (DynamoDB) ← raw docs,
FaaSRuntime (Lambda fleet) + Gateway (API Gateway) → search clients.
Replays a query load, reports the paper's numbers: end-to-end latency
percentiles (target < 300 ms warm), cold/warm split, queries-per-dollar
(target ~100k/$ at 2GB×300ms), and load fungibility.

    PYTHONPATH=src python -m repro_torch.launch.serve --docs 20000 --queries 500
    PYTHONPATH=src python -m repro_torch.launch.serve --partitions 4   # §3 scale-out
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu     # without a card

The reference's flags, defaults and JSON keys, and one more flag:
``--device`` (default: the card, raising without one; ``cpu`` on request),
which goes to the app builders. ``--kernel`` is ``SearchConfig(use_kernel=
True)``: K3 on the dense accumulator on the card, its twin on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.cost import paper_headline_cost
from repro_torch.core.runtime import RuntimeConfig
from repro_torch.data.corpus import synth_corpus, synth_queries
from repro_torch.search.searcher import SearchConfig
from repro_torch.search.service import build_search_app


def run_single(args) -> dict:
    docs = synth_corpus(args.docs, vocab=args.vocab, seed=0)
    queries = synth_queries(docs, args.queries, seed=1)
    app = build_search_app(
        docs,
        runtime_config=RuntimeConfig(memory_bytes=args.memory_gb << 30,
                                     hedge_after_s=args.hedge or None),
        search_config=SearchConfig(k=args.k, use_kernel=args.kernel),
        device=args.device,
    )
    # Poisson arrivals at --qps
    rng = np.random.default_rng(2)
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, len(queries)))
    t0 = time.perf_counter()
    n_hits = 0
    for q, t in zip(queries, arrivals):
        r = app.query(q, k=args.k, t_arrival=float(t))
        assert r.ok, r
        n_hits += len(r.body["ids"])
    wall = time.perf_counter() - t0

    lat = app.runtime.latency_percentiles("search")
    ledger = app.runtime.ledger
    out = {
        "queries": len(queries),
        "wall_s": round(wall, 2),
        "latency_p50_ms": round(lat[0.5] * 1e3, 1),
        "latency_p90_ms": round(lat[0.9] * 1e3, 1),
        "latency_p99_ms": round(lat[0.99] * 1e3, 1),
        "warm_fraction": round(app.runtime.warm_fraction("search"), 3),
        "fleet_size": app.runtime.fleet_size,
        "queries_per_dollar": round(ledger.queries_per_dollar()),
        "paper_headline_q_per_dollar": round(paper_headline_cost()),
        "index_bytes": sum(m.size for m in app.store.list("assets/")),
        "avg_hits": n_hits / len(queries),
    }
    return out


def run_partitioned(args) -> dict:
    from repro_torch.core.partition import FleetSpec, HedgePolicy, ReplicationSpec
    from repro_torch.search.service import build_partitioned_search_app

    docs = synth_corpus(args.docs, vocab=args.vocab, seed=0)
    queries = synth_queries(docs, args.queries, seed=1)
    hedge = None
    if args.replicas > 1:
        hedge = HedgePolicy(after_s=args.hedge or None)
    app = build_partitioned_search_app(docs, FleetSpec(
        n_parts=args.partitions,
        replication=ReplicationSpec(replicas=args.replicas, hedge=hedge),
        runtime_config=RuntimeConfig(memory_bytes=args.memory_gb << 30),
        search_config=SearchConfig(k=args.k)), device=args.device)
    if args.replicas > 1:
        app.warm()           # replica pools see no traffic until a hedge fires

    for q in queries:
        r = app.query(q, k=args.k, fetch_docs=False)
        assert r.ok, r
    lat = app.gateway.latency_percentiles("GET", "/search")
    ledger = app.runtime.ledger
    # gw_* keys: measured at the gateway (incl. proxy overhead, excl. doc
    # fetch) — NOT comparable to the pre-refactor latency_p*_ms, which was
    # raw scatter latency including per-partition doc fetch
    return {
        "partitions": args.partitions,
        "replicas": args.replicas,
        "queries": len(queries),
        "gw_latency_p50_ms": round(lat[0.5] * 1e3, 1),
        "gw_latency_p99_ms": round(lat[0.99] * 1e3, 1),
        "hedged_legs": sum(r.hedged for r in app.runtime.records),
        # per LOGICAL query — ledger.queries_per_dollar() counts invocations,
        # which a partitioned (and hedged) fan-out multiplies per query
        "queries_per_dollar": round(len(queries) / ledger.total_dollars)
        if ledger.total_dollars else float("inf"),
        "dollars_per_1k_queries": round(ledger.dollars_per_1k(len(queries)), 6),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--vocab", type=int, default=20_000)
    ap.add_argument("--qps", type=float, default=20.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--memory-gb", type=int, default=2)
    ap.add_argument("--partitions", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica functions per partition (hedged scatter)")
    ap.add_argument("--hedge", type=float, default=0.0)
    ap.add_argument("--kernel", action="store_true",
                    help="use the hand-written BM25 kernel (K3; its twin on the CPU)")
    ap.add_argument("--device", default=None,
                    help="where the searchers live: the card when not given, 'cpu' on request")
    args = ap.parse_args(argv)

    out = run_partitioned(args) if args.partitions else run_single(args)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
