"""Quickstart: build an index, publish it to the (simulated) object store,
and serve interactive queries through the serverless stack — Figure 1 of the
paper in ~40 lines of user code. The port of ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart                # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.data.corpus import synth_corpus, synth_queries
from repro_torch.kernels.backend import resolve_device
from repro_torch.search.service import build_search_app


def corpus_and_queries() -> tuple[list, list]:
    """The example's documents and its 5 queries."""
    docs = synth_corpus(5_000, vocab=8_000, seed=0)
    return docs, synth_queries(docs, 5, seed=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card when omitted (raises without one); 'cpu' on request")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. A document collection (synthetic stand-in for MS MARCO passages).
    docs, queries = corpus_and_queries()
    print(f"corpus: {len(docs)} docs, e.g. {docs[0][1][:60]}...")

    # 2. One call wires the whole serverless application:
    #    IndexWriter → packed segments → ObjectStore (S3)
    #    raw docs → KVStore (DynamoDB)
    #    stateless BM25 evaluator → FaaSRuntime (Lambda) ← Gateway (API GW)
    app = build_search_app(docs, device=device)

    # 3. Search. The first query lands on a COLD instance (hydrates the index
    #    from the store); repeats are WARM (in-memory, paper §2).
    for i, q in enumerate(queries):
        r = app.query(q, k=3, t_arrival=app.runtime.clock + 1.0)
        hits = ", ".join(f"{d}:{s:.2f}" for d, s in
                         zip(r.body["ids"], r.body["scores"]))
        kind = "cold" if r.record.cold else "warm"
        print(f"q{i} [{kind} {r.latency_s * 1e3:7.1f} ms] "
              f"'{q[:30]}...' → {hits}")

    # 4. The economics (paper §2): per-invocation GB·s billing.
    led = app.runtime.ledger
    print(f"\ninvocations: {led.invocations}, "
          f"compute cost: ${led.compute_dollars:.6f}, "
          f"queries/$: {led.queries_per_dollar():,.0f} "
          "(paper headline: 100,000)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
