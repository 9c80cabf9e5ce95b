"""Document-partitioned search two ways (paper §3's scale-out path); the
port of ``examples/partitioned_search.py``:

1. FLEET-LEVEL: ``build_partitioned_search_app`` — one Lambda function +
   one published segment per partition (packed with GLOBAL idf/avgdl by
   the one true packer, ``IndexWriter``), ``/search`` routed through the
   Gateway → ScatterGather → merge. All partitions fan out at the same
   arrival instant, so latency is max-over-partitions; a list of queries
   micro-batches as ONE invocation per partition (Q>1 through the same
   batched scoring fn).
2. MESH-LEVEL: the same partitioning as a single shard_map program over a
   (2, 2) ("data", "model") mesh of 4 partitions, stacked on the one device
   (``compat.make_mesh``: a ``StackedMesh`` holds every mesh position on
   the device, as the reference's 4 forced host devices do) — each
   position owns a partition and runs the same scoring core
   (``bm25.score_dense``), global top-k via all-gather-merge (on the card
   K2 takes the partitions' local top-k and the merge of the gathered row).

Both must agree with the exact BM25 oracle — and with each other, because
scoring and packing each have exactly one implementation.

    python -m repro_torch.examples.partitioned_search          # on the card
    PYTHONPATH=src python -m repro_torch.examples.partitioned_search --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.core.partition import FleetSpec, HedgePolicy, ReplicationSpec
from repro_torch.data.corpus import synth_corpus, synth_queries
from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel import compat
from repro_torch.search.bm25 import encode_queries
from repro_torch.search.distributed import build_partitioned_state, make_dist_search_fn
from repro_torch.search.oracle import OracleSearcher
from repro_torch.search.service import build_partitioned_search_app

N_PARTS = 4
MESH_SHAPE = (2, 2)            # the reference's docstring case: 4 host devices
MESH_CFG = {"k": 10, "max_blocks": 64}


def corpus_and_queries() -> tuple[list, list]:
    """The example's documents and its 5 queries."""
    docs = synth_corpus(2_000, vocab=3_000, seed=0)
    return docs, synth_queries(docs, 5, seed=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card when omitted (raises without one); 'cpu' on request")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    docs, queries = corpus_and_queries()
    oracle = OracleSearcher(docs)

    # -- 1. fleet-level scatter-gather --------------------------------------------
    print(f"== fleet-level: {N_PARTS} Lambda functions, scatter-gather ==")
    app = build_partitioned_search_app(docs, FleetSpec(n_parts=N_PARTS), device=device)

    for q in queries:
        r = app.query(q, k=10)
        got = r.body["ids"]                      # already globalized by the app
        want = [d for d, _ in oracle.search(q, k=10)]
        ok = got[:3] == want[:3]
        cold = sum(p["cold"] for p in r.body["partitions"])
        print(f"  '{q[:28]:30s}' lat={r.latency_s * 1e3:7.1f} ms top3 "
              f"{'==' if ok else '!='} oracle  ({cold}/{N_PARTS} cold)")

    # micro-batch: all 5 queries in ONE invocation per partition
    r = app.query(queries, k=10, t_arrival=app.runtime.clock + 1)
    n_ok = sum(res["ids"][:3] == [d for d, _ in oracle.search(q, k=3)]
               for q, res in zip(queries, r.body["results"]))
    print(f"  batch Q={len(queries)}: {len(r.body['partitions'])} invocations, "
          f"lat={r.latency_s * 1e3:.1f} ms, {n_ok}/{len(queries)} top3 == oracle")
    print(f"  fleet={app.runtime.fleet_size}, warm={app.runtime.warm_fraction():.0%}, "
          f"cost=${app.runtime.ledger.total_dollars:.6f}")

    # -- 1b. replicated partitions + hedged scatter legs --------------------------
    # Each segment is served by TWO independent instance pools; when a primary
    # projects a cold start (we kill its instance), the scatter leg fires a
    # backup on the replica at the same arrival instant and the warm pool wins —
    # the tail flattens, the ledger shows the hedging tax, results stay
    # bit-identical (same PackedIndex behind every replica).
    print(f"\n== replicated: {N_PARTS} partitions x 2 replicas, hedged legs ==")
    happ = build_partitioned_search_app(docs, FleetSpec(
        n_parts=N_PARTS, replication=ReplicationSpec(replicas=2, hedge=HedgePolicy())),
        device=device)
    happ.warm()
    for q in queries:                                 # warm traffic → policy history
        happ.query(q, k=10, t_arrival=happ.runtime.clock + 0.05, fetch_docs=False)
    for q in queries:
        happ.runtime.kill_instance(fn=happ.fn_names[0])   # partition 0 goes cold
        r = happ.query(q, k=10, t_arrival=happ.runtime.clock + 0.05,
                       fetch_docs=False)
        hedged = [p["fn"] for p in r.body["partitions"] if p["hedged"]]
        ok = r.body["ids"][:3] == [d for d, _ in oracle.search(q, k=10)][:3]
        print(f"  '{q[:28]:30s}' lat={r.latency_s * 1e3:7.1f} ms top3 "
              f"{'==' if ok else '!='} oracle  hedged={hedged or '-'}")
    led = happ.runtime.ledger
    print(f"  hedge tax: ${led.hedge_dollars:.8f} of ${led.total_dollars:.6f} "
          f"({led.hedge_invocations} backup legs)")

    # -- 2. mesh-level shard_map, stacked on the device ----------------------------
    n_mesh_parts = MESH_SHAPE[0] * MESH_SHAPE[1]      # one partition per position
    print(f"\n== mesh-level: shard_map over a stacked {MESH_SHAPE} mesh on {device} "
          f"({n_mesh_parts} partitions) ==")
    state, cfg, vocab = build_partitioned_state(docs, n_mesh_parts, MESH_CFG,
                                                device=device)
    mesh = compat.make_mesh(MESH_SHAPE, ("data", "model"), device=device)
    fn = make_dist_search_fn(cfg, ("data", "model"), mesh=mesh)
    tids, qtf = encode_queries(vocab, queries, max_terms=cfg.max_terms,
                               idf=state["idf"].cpu().numpy())
    with compat.use_mesh(mesh):
        scores, ids = fn(state, tids, qtf)
    scores, ids = scores.tolist(), ids.tolist()

    for qi, q in enumerate(queries):
        want = [d for d, _ in oracle.search(q, k=10)]
        got = [int(i) for v, i in zip(scores[qi], ids[qi]) if v > 0]
        ok = got[:3] == want[:3]
        print(f"  '{q[:28]:30s}' top3 {'==' if ok else '!='} oracle "
              f"({[round(float(v), 2) for v in scores[qi][:3]]})")

    print("\nboth realizations run the SAME scoring core (bm25.score_dense) over "
          "the SAME packing (IndexWriter): per-partition BM25 + k-survivor merge "
          "— paper §3, now actually 'a matter of software engineering'.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
