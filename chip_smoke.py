#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port: drive the single-node BM25 query
path, the partitioned fleet, the structured tier, the mesh path, the serve
launcher, the LM serving paths (dense, MoE, MLA), recsys serving, the
training path, the cells (the dry run, the cells that fit, sharded
training's launcher) and the four examples on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch twin.

    python3 chip_smoke.py                 # 50,000-doc partition (the default)
    python3 chip_smoke.py --docs 1000000  # the 1M-doc partition, for comparison
    python3 chip_smoke.py --lm-only       # phases 1, 2 and 7 (no ok line)
    python3 chip_smoke.py --simt-only     # phases 1, 2, then K5's f32 kernel (no ok line)
    python3 chip_smoke.py --recsys-only   # phases 1, 2 and 8 (no ok line)
    python3 chip_smoke.py --topk-only     # phases 1, 2, then K2 and K4 alone (no ok line)
    python3 chip_smoke.py --k1-k6-only    # phases 1, 2, then K1 and K6 alone (no ok line)
    python3 chip_smoke.py --k3-only       # phases 1, 2, then K3 alone (no ok line)
    python3 chip_smoke.py --structured-only  # phases 1, 2 and 9 (no ok line)
    python3 chip_smoke.py --mesh-only     # phases 1, 2 and 10 (no ok line)
    python3 chip_smoke.py --serve-only    # phases 1, 2 and 11 (no ok line)
    python3 chip_smoke.py --moe-only      # phases 1, 2, 12 and 13 (no ok line)
    python3 chip_smoke.py --train-only    # phases 1, 2 and 14 (no ok line)
    python3 chip_smoke.py --cells-only    # phases 1, 2 and 15 (no ok line)
    python3 chip_smoke.py --examples-only # phases 1, 2 and 16 (no ok line)

Phases (each raises on failure; the script then exits non-zero):
  1. the card: name, power limit, CUDA version;
  2. build the kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  3. a synthetic 50,000-passage partition (``--docs``, cut from 1M, then
     to 500,000, 250,000 and 50,000, to keep the whole run inside its time
     limit on slower hosts; MS MARCO-like passage length,
     the anlessini config's 2^19 vocab), published and served by
     ``build_search_app`` with the pruned + kernels config on the card;
  4. K3, K2 and K1 against their twins on that index's real gathered
     blocks for Q=1 and Q=64, bitwise, and K1 against the dense plain path;
     per-kernel times with CUDA events beside the twin's, a library call's
     (timed in turns with the kernel: kernel, library, library, kernel) and
     the least time the card could take. K3 twice: its reference-shaped
     entry point (``bm25_block_scores``, dl given) and the main path's fused
     one (``bm25_block_impacts``, the doc_len gather and the mask inside),
     each in turns with its twin, the fused one also in turns with the
     eager chain it replaced (clamp, int64 ids, the doc_len gather, a
     ``bm25_block_scores`` launch, the mask). Then K1 past its old range
     limit (64 terms over 200M docs, Q 1, seeded blocks), bitwise against
     its twin; warm latency of the pruned + kernels, dense + kernels and
     dense plain searchers, paired query by query;
  5. end to end through the gateway: one cold query, 20 warm queries and a
     64-query micro-batch on the pruned + kernels route (K1, which merges
     its ranges' survivors itself), the dense
     + kernels route (K3, K2) and the dense plain route (no kernel), every
     answer equal (ids, score bits) to the dense plain route's. The launch
     counters are set to 0 before each route and read after it: each route
     must launch its kernels and no other, K3 (the fused entry point) once
     a call;
  6. the partitioned fleet on the card: the same corpus split over
     ``FleetSpec(n_parts=4)`` with a dense tier of dim 768 (the width of the
     BERT-base dense retrievers indexed for MS MARCO passage), lazy
     hydration, pruned + kernels. K4 against its twin, bitwise, on a real
     partition's rows at Q=1 and Q=64, timed beside the twin, a library
     matmul + ``torch.topk`` and the bound. Then per mode (sparse, dense,
     hybrid), after every instance is killed so the first query is cold:
     one cold query, 20 warm queries and a 64-query micro-batch through
     ``submit``/``flush``, the launch counters set to 0 before the mode and
     checked after it (sparse K1, dense K4+K2, hybrid K1+K2+K4), on the
     queries of phases 4-5. Dense answers equal the full-corpus
     ``DenseOracleSearcher`` (twin on the card) in ids and score bits;
     windowed answers equal serial ones bitwise; hybrid equals ``rrf_fuse``
     of the fleet's own sparse and dense rankings. Last, sparse answers
     equal the single-node pruned route of phase 5 to the partition-count
     standard of the reference's parity tests (ext ids, and scores to 6
     decimals), on 64 queries whose terms have at most ``max_blocks``·128
     postings — the standard's own precondition: no impact-ordered
     truncation in any partition or in the single node. Then a commit at
     full scale: ``add_documents`` of 1 % of the live passages anew
     (``synth_corpus(n, seed=2)``, ext ids of their own; 500 at the
     default) and ``delete_documents`` of as many live ids
     (``default_rng(3)``), one
     ``commit()``, whose writers must publish deltas (no merge at 1 %
     churn); its host wall, modeled latency, the rollover's pings and cold
     hydrations per pool, the wall to the first answer of generation 2 and
     ``memory_allocated`` before, after and after ``gc`` are printed. Then
     the three modes' traffic again on generation 2 (the first query on
     the rollover's prewarmed pools, 20 warm, the window, the counters
     checked) against a generation-2 dense oracle, and no deleted ext id
     may be served;
  7. LM serving on K5: h2o-danube-1.8b at full width (24 layers, d 2560,
     bf16, random weights from a seeded ``torch.Generator``). ``lm_prefill``
     of 4 ``LMTokenStream`` prompts of 6,144 tokens (past the 4,096 window:
     the window mask and the ring's roll both act) and 32 greedy
     ``lm_decode`` steps against the ring, counters set to 0 before the
     prefill and before the steps: 24 K5 launches per prefill and per step,
     no other kernel. Then K5 against its twin, bitwise, on layer 0's real
     q/k/v (prefill; decode with kv_len = slots and < slots; Dv != D), with
     ``return_lse`` the same output bits and each row's lse the twin's
     (bitwise f32, ``LSE_TOL`` bf16), timed with and without the lse
     beside the twin, ``scaled_dot_product_attention`` and the bound; last,
     decode == forward at full width in f32 (2 prompts of 4,608 tokens, 8
     steps; the reference test's rtol/atol 2e-2 and 5e-2), every f32 K5
     launch on the tiled path, then (d): K5's f32 kernel bitwise == its
     twin (outputs and lse) on this prefill's layer-0 q/k/v (2 × 32 heads
     over 8 kv heads × 4,608 × 80, causal, window 4,096) and timed as
     above;
  8. recsys serving at full width (fm, dcn-v2, bst, bert4rec at
     ``full_config()``, f32, random weights from a seeded
     ``torch.Generator``, each architecture's tables released before the
     next): ``serve_p99`` (512 rows of the repo's synthetic click-log or
     sequence streams, seed 0, step 0) for all four, ``serve_bulk`` (262,144
     rows) for fm, dcn-v2 and bst (bert4rec's runs as phase 15's cell), and ``retrieval_cand`` (one user against
     1,000,000 random f32 candidates, k = 100) on the K4 route and the plain
     route for all four. The launch counters are set to 0 before each route
     and checked after it: one K6 launch per fm forward and per fm or dcn-v2
     tower, n_blocks K5 launches per bst or bert4rec encoder, K2 for every
     top-k, K4 only on the K4 route, never K1 or K3; every K5 launch the
     f32 kernel, bst's on its short path, bert4rec's on its tiled one. K6
     equals its twin bitwise on every architecture's real tables and batch
     ids and on a bf16 copy of a table; K5's f32 kernel its twin (outputs
     and lse, bitwise) on layer 0's q/k/v of the sequences the encoders
     attend (bst's [history; target]) at (a) bst's bulk (262,144 × 8 heads
     × 21 × 4), (b) its p99 (512 rows) and (c) a bert4rec chunk (2,048 × 2
     × 200 × 32), each timed beside the twin, SDPA (in turns) and the
     bound; fm and
     dcn-v2 logits of 64 rows match a float64 evaluation on the host; the two
     retrieval routes agree; bert4rec's serving top-100 equals a matmul +
     ``ref.topk_ref``. K6 is timed beside its twin,
     ``torch.nn.functional.embedding_bag`` and the bound at fm's linear term
     (D 1), fm's tower (D 10) and dcn-v2's (D 16), 262,144 bags each; K2
     at bert4rec's vocabulary top-100 (512 × 2²⁰ + 2 logits) against its
     twin, bitwise, and timed in turns with ``torch.topk``;
  9. the structured tier and the write path against oracles (the
     reference's B16 and B11): ``synth_fielded_corpus(25_000, vocab=12_500)``
     (``STRUCT_DOCS``, cut from B16's 100,000 for time), a fleet of 4
     partitions × 2 replicas over the first 22,500
     (``IndexSpec(structured=True, facet_fields=("cat",))``, B16's window,
     pruned + kernels, k 100, lazy). Per generation and kind — 64
     ``synth_structured_queries`` with a ``cat`` facet request, 64
     bag-of-words ``synth_queries`` — every instance killed, one cold query,
     20 warm and the 64 through ``submit``/``flush``, windowed == serial;
     the counters show K2 alone on the structured route and K1 alone on the
     bag-of-words one. Structured answers equal ``StructuredOracleSearcher``
     over the live corpus (ext ids, score bits, order; facets), one phrase
     query's result set ``exact_match_set`` and its facets
     ``exact_facet_counts``, its snippets cover every matched term;
     bag-of-words ext ids equal ``OracleSearcher`` on the queries no
     partition truncates; partition 0's evaluator on the card equals the
     same function on the CPU bit for bit. Between the generations the
     last 2,500 docs are added and 1,250 seeded ids deleted, committed
     inside an open window: queries admitted before the commit answer from
     generation 1, those after from generation 2, each equal to its
     generation's oracle, and no deleted id is served. Prints the warm
     p50/p99 of both kinds per generation and their p99 ratio, and the
     evaluator's device time a query by leaf kind, K2's beside it, from a
     profiler window of 5 warm structured queries.
 10. the paper's §3 mesh path (``search/distributed.py``) at the anlessini
     geometry, ``configs/anlessini.py::full_config(256)``: 256 partitions of
     34,560 docs and 15,360 blocks of 128, vocab 2^19, 16 terms, 32 blocks a
     term, k 100, stacked on the card as a (16, 16) ("data", "model") mesh.
     The state is made from a seed straight into ``stack_partitions``'
     layout (``anlessini_state``: impact-ordered blocks, global idf and
     avgdl). For ``serve_q1`` and ``serve_q64``, both accumulators and both
     gathers, the launch counters around each call (K2 alone: the local
     top-k over (256·Q, 34,560) and the merge over (Q, 25,600)): pruned ==
     dense bitwise, fused == hierarchical but for ties, four partitions run
     one at a time == the stacked body, the merge == K2 == its twin over the
     gathered survivors; wall p50/p99 over 20 warm batches, peak memory, a
     profiler window, K2 at the mesh's shapes beside ``torch.topk``, its
     twin and its bound. Then bert4rec at ``full_config()`` under
     ``sharded_topk`` on a stacked (1, 4) mesh, 512 rows: ids and value bits
     of ``sharded_topk=False``; fm's 2^20 × 10 table through
     ``sharded_lookup_shardmap`` on a stacked (2, 4) mesh == ``index_select``.
 11. the serve launcher, ``repro_torch.launch.serve``, at its defaults (20,000
     docs, 500 queries, 20 QPS): ``run_single`` with ``--kernel`` (K3 alone,
     one launch a query, every response ok; the first 20 answers' ids equal
     the same launcher's on the CPU) and ``run_partitioned`` with
     ``--partitions 4 --replicas 2``, both JSONs printed; then the
     reference's B2: ``KVPostingsIndex`` (Crane & Lin '17, plain Python,
     modeled DynamoDB time) over B2's 20,000 docs and 200 queries against
     the card's warm p50 (``kvstore_baseline_p50_ms``,
     ``anlessini_warm_p50_ms``, ``speedup_x``);
 12. olmoe-1b-7b at ``full_config()`` (16 layers, d 2048, 64 experts top-8,
     ``moe_impl="ep"``, bf16, seeded random weights made on the card) under
     a stacked (1, 1) mesh: ``lm_prefill`` of 4 prompts of 4,096 tokens, 32
     greedy ``lm_decode`` steps, the counters checked (per prefill 16 K5
     "tc" and 16 K2, per step 16 K5 "split" and 16 K2, nothing else);
     profiler windows over decode steps and one prefill; K5 against its
     twin on layer 0's q/k/v (prefill and decode) and timed beside SDPA and
     the bound; K2 bitwise on layer 0's router probabilities (16,384 × 64,
     k 8) and timed beside ``torch.topk``; layer 0's routed FFN by EP on a
     stacked (1, 4) mesh against the global dispatch (kept assignments and
     slot tables equal, outputs within ``EP_TOL``; the global combine run
     twice, equal bit for bit);
 13. deepseek-v2-236b at full width on 4 of its 60 layers (memory): the
     same on 2 prompts of 2,048 tokens and 16 decode steps against the
     latent cache (per prefill 4 K5 "tc" and 4 K2, per step 4 K2 and no
     K5: the absorbed decode is plain), K5 at qk 192 / v 128 / 128 heads,
     K2 on (4,096 × 160, k 6), the latent cache's bytes beside a k/v cache
     of the same heads. Each model is released before the next phase;
 14. training on the card, every state and batch made from seeds, the launch
     counters set to 0 before the phase and all 0 after it (training runs the
     plain paths: no hand kernel has a backward). (a) graphcast at
     ``full_config(d_feat=602)`` (16 layers, d 512, 227 outputs, ~31M
     parameters; the config's mean aggregator here, as 16 unnormalised
     sums over the sample's hubs overflow f32) at ``minibatch_lg``:
     ``synth_graph(232_965, avg_degree=25,
     d_feat=602)`` (reddit's nodes and features, its degree cut from ~492 to
     25 for host time), ``NeighborSampler`` samples of 1,024 seeds at fanout
     15-10 (169,984 × 168,960 padded), seeded targets; 8 steps through
     ``run_with_restarts`` with a checkpoint every 4 steps to a filesystem
     ObjectStore and a failure injected at step 6: one restart, one lost
     step, the re-run step's loss equal to its first bit for bit, the
     restored step-4 state equal to the saved one bit for bit, and two steps
     from the same init again giving the same bits; then 2 steps each of
     full_graph_sm (2,708 nodes, 10,556 edges, 1,433 features) and molecule
     (128 graphs); (b) h2o-danube-1.8b at ``full_config()`` in bf16, remat
     nothing_saveable, 2 × 4,096 tokens (train_4k's sequence; its batch cut
     from 256), 4 steps of ``make_train_step(lm_loss)`` on one repeated
     batch: the loss falls, the first step's loss repeats bit for bit;
     (c) ``python -m repro_torch.launch.train --arch stablelm-3b --preset
     100m --steps 20 --batch 16 --seq 256 --ckpt-every 5 --fail-at 17``
     through its ``main``: ``restarts=1``, the last 10 steps' mean loss
     below the first 10's; (d) fm and dcn-v2 at ``full_config()`` on 65,536
     rows (train_batch), 3 steps each, and bert4rec's sampled loss at 4,096
     sequences. Step walls, peak memory and losses are printed, and a
     ``{"training": ...}`` JSON line. The models are released;
 15. the cells (``repro_torch.configs.build_cells``): (a) the dry run,
     ``repro_torch.launch.dryrun`` over every full cell on both production
     meshes ((16, 16) and (2, 16, 16) stacked on ``meta``) in worker
     processes beside (b), into a temporary directory, a line a record
     (FLOPs a device, peak, arguments, trace seconds); every cell ok or a
     skip the reference also skips; (b) every full single-pod cell whose
     global arguments plus its trace's peak fit 60 GB, materialized on the
     card from numpy seeds (``--seed`` and up; a parameter leaf is its
     seeded block tiled on the card in f32 and cast there, the values
     ``models/weights.py`` gives; a cell that the dry run's record says
     does not fit is not traced again) and run: outputs finite and shaped as the
     meta trace at the same arguments, a train cell's loss finite and its
     first parameter leaf moved, each cell's launches of K1–K6 counted
     (K2, K4, K5, K6 must run, K1 and K3 not); the LM serving cells of the
     archs whose weights fit at batch 1 (cut); (c) ``launch.train --arch
     stablelm-3b --preset 100m --steps 6 --batch 16 --seq 256`` on ``--mesh
     prod`` and ``--mesh host``: the same loss bits (the production mesh is
     stacked on the card, so its step is the host step: this checks that
     batch and state split over 16 x 16); then ``--mesh host`` in 2
     processes of a gloo group on the card (started with (b), beside it),
     a (2, 1) rank mesh and so the
     sharded step (gradient and metrics averaged by gloo, the clip over the
     whole reduced gradient, AdamW on each rank's blocks): each step's loss
     within 1e-4 of the host step's and its grad norm within 1e-4 of
     itself; (d) right after each of the 12 recsys ``serve_p99``,
     ``serve_bulk`` and ``retrieval_cand`` cells in (b), on the same
     inputs, its sharded function (``cell.build(mesh)``: tables row-sharded
     over ``model``, the batch over ``data``, a retrieval's candidates over
     ``data`` ranked on K4 and merged by K2) on a stacked (16, 16) mesh,
     ``serve_bulk`` on (4, 2) (cut: a stacked mesh runs the ``model``
     replicas' towers in turn): wall, peak, K2/K4/K5/K6 launches exactly as
     the body implies, and the outputs against the unsharded run's (ids
     equal; values bitwise, or, where the sharded K6 sums a bag in another
     order, within that order's bound); each arch's ``serve_p99`` and fm's
     ``retrieval_cand`` also on a (1, 2) rank mesh of 2 gloo processes on
     the card, started with (b) and running beside it, bit for bit as the
     stacked (1, 2) mesh on every rank; (e) right after each of the 7
     dense-LM serving cells in (b) (starcoder2-3b, stablelm-3b,
     h2o-danube-1.8b ``prefill_32k`` and ``decode_32k``, h2o's
     ``long_500k``; batch 1), on the same inputs, its sharded function
     (tensor-parallel prefill, sequence-sharded decode merged by K5's
     log-sum-exp) on a stacked (1, 16) mesh, ``long_500k`` on (2, 8): each
     decode at (b)'s position and at a second one (mid-ring: full, partial
     and empty shards; ``long_500k`` past its ring's wrap) against an
     unsharded step there; wall, peak, K5's launches by variant as the
     body implies, logits and the cache within
     ``models/transformer.py::sharded_bound`` of the unsharded run, the
     next token's argmax equal but where the unsharded top two lie within
     it, K5 with its lse against the twin at the decode's shapes; h2o's
     ``decode_32k`` also over the (1, 2) rank mesh, within the bound of
     the stacked (1, 2) run.
 16. the examples on the card, as a user runs them: ``python -m
     repro_torch.examples.<name>`` for each of ``EXAMPLES`` (quickstart,
     partitioned_search and train_lm at the reference's defaults,
     serve_msmarco at ``--docs 50000``, its docstring's size, 400 queries at
     25 QPS), in this process through ``runpy`` (the kernels built in phase
     2 and their counters serve it), each in a fresh temporary directory
     that ``tempfile`` hands out while it runs (train_lm's launcher
     checkpoints there and would resume from an earlier run's). The launch
     counters are set to 0 before each example and checked after it: K2 in
     partitioned_search's mesh half, a local top-k a chunk of
     ``partitions_per_call`` partitions and one merge; no other kernel in any
     example. K2 is then held bitwise against its twin at those two shapes,
     on the mesh half's state rebuilt on the card: the twin's top-k of the
     local rows must be the body's survivors, and its merge of the gathered
     row the search's whole top 10, ids and score bits. Checks: quickstart's first answer cold and the other four warm,
     each top 3 the host ``OracleSearcher``'s (up to order within 1e-6);
     partitioned_search with no ``!=``, its batch in 4 invocations, 5 backup
     legs, 5 mesh answers == the oracle; serve_msmarco's replay all ok, the
     first query on v2 ok, the fungibility line; train_lm one restart, the
     steps lost that the launcher's checkpoint rule implies (17) and the
     last 10 steps' mean loss below the first 10's. Prints each example's output, wall, launches and peak
     memory, serve_msmarco's scorecard and train_lm's logged steps, and an
     ``{"examples": ...}`` JSON line.

``--topk-only`` runs phases 1-2 and then K2 and K4 alone at the main path's
shapes on data made from a seed (bert4rec-like logits with a popularity
skew, a mostly-zero 1M-doc accumulator of row stride n + 1, 250,000 × 768
rows at Q 1 and 64), each held bitwise to its twin and timed in turns with
its library call, K4's own launch apart from K2's merge.

``--k1-k6-only`` runs phases 1-2 and then K1 and K6 alone at the main path's
shapes on data made from a seed: K1 at Q 1 and 64 on ``synth_pruned_blocks``
(T 16, M 64, B 128, 1M docs, k 10) and past its old range limit, K6 at fm's
tower (262,144 × 39, D 10), fm's linear term (D 1) and dcn-v2's tower
(262,144 × 26, D 16) on the streams' zipf ids; each held bitwise to its
twin and timed in turns with it (K6 also beside ``F.embedding_bag``), K1's
device time split by kernel.

``--simt-only`` runs phases 1-2 and then K5's f32 kernel alone at (a)-(d)
(``simt_shapes``, the table phases 7 and 8 use) on seeded inputs, as those
phases check and time it.

``--k3-only`` runs phases 1-2 and then K3's two entry points and the eager
chain at Q 1 and 64 on the same seeded blocks with a seeded 1M-doc
``doc_len`` table, as phase 4 runs them.

``--structured-only`` runs phases 1-2 and then phase 9.

``--mesh-only`` runs phases 1-2 and then phase 10.

``--serve-only`` runs phases 1-2 and then phase 11; ``--moe-only`` phases
1-2 and then phases 12 and 13; ``--train-only`` phases 1-2 and then phase 14;
``--cells-only`` phases 1-2 and then phase 15; ``--examples-only`` phases 1-2
and then phase 16.

Prints the kernels JSON line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
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
FLEET_PARTS = 4
VEC_DIM = 768                  # BERT-base dense retrievers (e.g. TCT-ColBERTv2)
FLEET_MODES = {"sparse": ("K1",), "dense": ("K4", "K2"), "hybrid": ("K1", "K2", "K4")}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` warm-up calls."""
    import torch
    for _ in range(warmup):
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


def cuda_call_ms(fn):
    """``fn()`` once, and its device time in ms from CUDA events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def paired_ms(fn, lib_fn, reps: int = 20) -> tuple[float, float]:
    """``cuda_ms`` of a kernel and of the library call that computes the
    same function, taken in turns (kernel, library, library, kernel), each
    the mean of its two readings."""
    a1, b1 = cuda_ms(fn, reps), cuda_ms(lib_fn, reps)
    b2, a2 = cuda_ms(lib_fn, reps), cuda_ms(fn, reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


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

        # K3, both entry points
        rows.setdefault("K3", {})[Q] = k3_cases(kern["K3"], ref, torch, tf, docs, valid,
                                                state.doc_len, idf_q, params, n_docs)

        # K2, over the dense accumulator of these queries
        acc = bm25.score_dense(state, t, w, max_blocks=MAX_BLOCKS)
        rows.setdefault("K2", {})[Q] = k2_case(kern["K2"], ref, torch, acc, K, f"K2 Q={Q}")

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
        rows.setdefault("K1", {})[Q] = dict(
            err=max_abs_err(gv, wv), ms=cuda_ms(k1), plain_ms=cuda_ms(k1_twin),
            graph_ms=graph_ms(k1), library_ms=None, touched=touched, valid=int(valid.sum()),
            bound=k1_bound(Q, touched, docs.shape[-1]))
        print_k3("4", Q, rows["K3"][Q])
        for name in ("K2", "K1"):
            r = rows[name][Q]
            graph = f", in a CUDA graph {r['graph_ms']:.4f} ms" if "graph_ms" in r else ""
            print(f"[4] {name} Q={Q}: bitwise == twin; kernel {r['ms']:.4f} ms{graph}, twin "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
                  f"{r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
        print(f"[4] K1 Q={Q}: touched {rows['K1'][Q]['touched']} of "
              f"{rows['K1'][Q]['valid']} valid blocks; top-k == dense plain path", flush=True)
    return rows


def k3_cases(k3, ref, torch, tf, docs, valid, doc_len, idf_q, params, n_docs,
             reps=20) -> dict:
    """K3's fused entry point ``k3`` (the main path's) and its
    reference-shaped one on one batch of gathered blocks, each bitwise
    against its twin and timed in turns with it; the fused one also in
    turns with the eager chain it replaced — the steps the parent tree's
    ``bm25_impacts`` ran around a ``bm25_block_scores`` launch — whose bits
    it equals. Each is also timed inside a CUDA graph (``graph_ms``: the
    device's time without the host's launch cost, which back-to-back calls
    of a ~10 µs kernel measure instead). Returns the fused call's row, the
    other's under "scores"."""
    from repro_torch.kernels.bm25_block import bm25_block_scores
    dl = doc_len[torch.clamp(docs, max=n_docs).long()]
    fused = lambda: k3(tf, docs, valid, doc_len, idf_q, *params, n_docs)   # noqa: E731
    calls = {
        "scores": (lambda: bm25_block_scores(tf, dl, idf_q, *params),
                   lambda: ref.bm25_block_scores_ref(tf, dl, idf_q, *params)),
        "impacts": (fused, lambda: ref.bm25_block_impacts_ref(tf, docs, valid, doc_len, idf_q,
                                                              *params, n_docs)),
    }

    def chain():
        d = doc_len[torch.clamp(docs, max=n_docs).long()]
        imp = bm25_block_scores(tf, d, idf_q, *params)
        return torch.where(valid & ~(docs >= n_docs) & (tf > 0), imp, 0.0)

    out = {}
    for name, (fn, twin) in calls.items():
        got, want = fn(), twin()
        torch.cuda.synchronize()
        require(bits_equal(got, want), f"K3 {name} != twin at Q={tf.shape[0]}")
        ms, plain_ms = paired_ms(fn, twin, reps)
        out[name] = dict(err=max_abs_err(got, want), ms=ms, plain_ms=plain_ms, library_ms=None,
                         graph_ms=graph_ms(fn, reps))
    require(bits_equal(fused(), chain()), "K3 impacts != the eager chain")
    out["impacts"]["turns_with_chain"] = paired_ms(fused, chain, reps)
    out["impacts"]["eager_chain_graph_ms"] = graph_ms(chain, reps)
    postings, B = tf.numel(), tf.shape[-1]
    out["scores"]["bound"] = bound_ms(postings * 9 + idf_q.numel() * 4, postings * 7)
    # the fused call reads tf and docs of valid rows, a valid byte a row, the
    # idf and each distinct live doc's doc_len, and writes every posting
    live = valid & (docs < n_docs) & (tf > 0)
    n_live, distinct = int(live.sum()), int(torch.unique(docs[live]).numel())
    out["impacts"]["bound"] = bound_ms(int(valid.sum()) * B * 5 + postings * 4 + valid.numel()
                                       + idf_q.numel() * 4 + distinct * 4, n_live * 7)
    Q, T, M, _ = tf.shape
    out["impacts"]["shape"] = out["scores"]["shape"] = (
        f"Q={Q}, T={T}, M={M}, B={B}, n_docs={n_docs}; {int(valid.sum())} valid rows of "
        f"{valid.numel()}, {n_live} live postings, {distinct} distinct docs")
    out["impacts"]["scores"] = out.pop("scores")
    return out["impacts"]


def print_k3(tag, Q, r) -> None:
    s = r["scores"]
    print(f"[{tag}] K3 Q={Q} ({r['shape']}): both entry points bitwise == twin; "
          f"bm25_block_impacts {r['ms']:.4f} ms, in a CUDA graph {r['graph_ms']:.4f} ms "
          f"(twin {r['plain_ms']:.4f}, bound {r['bound'][0]:.6f} ms, {r['bound'][1]}); in "
          f"turns with the eager chain {r['turns_with_chain'][0]:.4f} / "
          f"{r['turns_with_chain'][1]:.4f} ms (chain in a CUDA graph "
          f"{r['eager_chain_graph_ms']:.4f}); bm25_block_scores {s['ms']:.4f} ms, in a CUDA "
          f"graph {s['graph_ms']:.4f} ms (twin {s['plain_ms']:.4f}, bound {s['bound'][0]:.6f} "
          f"ms, {s['bound'][1]})", flush=True)


def k2_case(k2, ref, torch, s, k, what, reps=20) -> dict:
    """K2 on score rows ``s`` against its twin, bitwise (values and ids),
    then timed beside the twin and, in turns, ``torch.topk``."""
    (gv, gi), (wv, wi) = k2(s, k), ref.topk_ref(s, k)
    torch.cuda.synchronize()
    require(bits_equal(gv, wv) and bits_equal(gi, wi), f"{what}: K2 != twin")
    ms, library_ms = paired_ms(lambda: k2(s, k), lambda: torch.topk(s, k, dim=-1), reps)
    Q, N = s.shape
    return dict(err=max_abs_err(gv, wv), ms=ms, library_ms=library_ms,
                plain_ms=cuda_ms(lambda: ref.topk_ref(s, k), reps=5),
                bound=bound_ms(s.numel() * 4 + Q * k * 8, s.numel()),
                shape=f"Q={Q}, N={N}, k={k}")


def k4_case(k4, ref, torch, q, rows, k, what) -> dict:
    """K4 (+ K2's merge) against its twin, bitwise, then timed beside the
    twin and, in turns, ``torch.matmul`` + ``torch.topk``."""
    (gv, gi), (wv, wi) = k4(q, rows, k), ref.dot_topk_batch_ref(q, rows, k)
    torch.cuda.synchronize()
    require(bits_equal(gv, wv) and bits_equal(gi, wi), f"{what}: K4 != twin")
    ms, library_ms = paired_ms(lambda: k4(q, rows, k),
                               lambda: torch.topk(torch.matmul(q, rows.T), k, dim=-1))
    (Q, D), N = q.shape, rows.shape[0]
    return dict(err=max_abs_err(gv, wv), ms=ms, library_ms=library_ms,
                plain_ms=cuda_ms(lambda: ref.dot_topk_batch_ref(q, rows, k), reps=5),
                bound=bound_ms(N * D * 4 + Q * D * 4 + Q * k * 8, 2 * Q * N * D),
                shape=f"Q={Q}, N={N}, D={D}, k={k}")


def print_case(tag, name, r) -> None:
    print(f"[{tag}] {name} at {r['shape']}: bitwise == twin; kernel {r['ms']:.4f} ms, "
          f"library {r['library_ms']:.4f} ms, twin {r['plain_ms']:.3f} ms, bound "
          f"{r['bound'][0]:.4f} ms ({r['bound'][1]})", flush=True)


def case_entry(r) -> dict:
    """One shape of a kernel's entry in the kernels line."""
    return {"ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "max_abs_err": r["err"],
            "shape": r["shape"], **({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {})}


# --topk-only: K2 and K4 at the main path's shapes on data made from a seed
TOPK_ONLY = dict(vocab=(512, (1 << 20) + 2, 100), search=(64, 1_000_000, K),
                 dense=(250_000, VEC_DIM, K))


def topk_phase(kern, ref, torch, device="cuda", seed=0) -> dict:
    """K2 at bert4rec's vocabulary top-k (512 rows of 2²⁰ + 2 logits of a
    64-wide model, a popularity skew toward low ids) and at the search
    shape (64 rows of a 1M-doc accumulator, stride n + 1, all 0.0 but 1 to
    4,096 hits a row), K4 at Q 1 and Q 64 over 250,000 × 768 rows; each
    bitwise against its twin and timed beside it and its library call."""
    g = torch.Generator(device).manual_seed(seed)
    out = {}
    Q, N, k = TOPK_ONLY["vocab"]
    h = torch.randn(Q, 64, device=device, generator=g)
    emb = torch.randn(N, 64, device=device, generator=g) * 0.125
    pop = torch.log1p(torch.arange(N, device=device, dtype=torch.float32))
    logits = torch.matmul(h, emb.T) - 0.5 * pop
    del h, emb, pop
    out["K2 vocabulary"] = k2_case(kern["K2"], ref, torch, logits, k, "vocabulary", reps=5)
    print_case("t", "K2", out["K2 vocabulary"])
    del logits
    Q, n, k = TOPK_ONLY["search"]
    acc = torch.zeros(Q, n + 1, device=device)
    for q in range(Q):
        hits = 1 << (q % 13)
        idx = torch.randint(0, n, (hits,), device=device, generator=g)
        acc[q, idx] = torch.rand(hits, device=device, generator=g) * 20
    out["K2 search"] = k2_case(kern["K2"], ref, torch, acc[:, :n], k, "search")
    print_case("t", "K2 (rows of stride n + 1)", out["K2 search"])
    del acc
    N, D, k = TOPK_ONLY["dense"]
    rows = torch.randn(N, D, device=device, generator=g)
    qs = torch.randn(64, D, device=device, generator=g)
    from repro_torch.kernels import topk as k2
    merge = k2.merge
    for Q in (1, 64):
        q = qs[:Q].contiguous()
        out[f"K4 Q={Q}"] = r = k4_case(kern["K4"], ref, torch, q, rows, k, f"K4 Q={Q}")
        print_case("t", "K4 (+ K2's merge)", r)
        # the split: K4's own launch (the merge skipped), then the merge alone
        kept = {}
        k2.merge = lambda v, i, *a, **kw: kept.update(v=v, i=i) or (v, i)   # noqa: E731
        try:
            alone = cuda_ms(lambda: kern["K4"](q, rows, k))
        finally:
            k2.merge = merge
        if kept:                         # on the card (the CPU's twin merges nothing)
            print(f"[t] K4 at Q={Q}: its own launch {alone:.4f} ms, K2's merge of "
                  f"{kept['v'].shape[1]} survivors a query "
                  f"{cuda_ms(lambda: merge(kept['v'], kept['i'], k, N)):.4f} ms", flush=True)
    return out


# --k1-k6-only: K1 and K6 at the main path's shapes on data made from a seed
K1_ONLY = dict(T=MAX_TERMS, M=MAX_BLOCKS, n_docs=1_000_000, k=K, queries=(1, N_QUERIES))
BM25_PARAMS = (0.9, 0.4, 12.0)     # k1, b, avgdl of synth_pruned_blocks


def k1_blocks(torch, Q, device, seed=0):
    """Q queries of ``synth_pruned_blocks`` (seeds seed..seed+Q-1), stacked."""
    from repro_torch.data.corpus import synth_pruned_blocks
    c = K1_ONLY
    parts = [synth_pruned_blocks(seed + q, n_terms=c["T"], max_blocks=c["M"],
                                 n_docs=c["n_docs"]) for q in range(Q)]
    return tuple(torch.from_numpy(np.stack(p)).to(device) for p in zip(*parts))


# K1 past its old range limit: (T + 2) × ranges above ~58,000 was refused
K1_WIDE = dict(T=64, M=8, n_docs=200_000_000, k=K)


def k1_wide_check(kern, ref, torch, device="cuda", seed=64) -> dict:
    """K1 at Q 1 on ``synth_pruned_blocks`` of 64 terms over 200M docs —
    3,622 ranges, more (term, range) counts than a block's shared memory
    holds — bitwise against its twin (a 0.8 GB dense accumulator), then
    timed in turns with it."""
    from repro_torch.data.corpus import synth_pruned_blocks
    from repro_torch.kernels.bm25_pruned import range_docs
    c = K1_WIDE
    arrays = synth_pruned_blocks(seed, n_terms=c["T"], max_blocks=c["M"], n_docs=c["n_docs"])
    args = (*(torch.from_numpy(a[None]).to(device) for a in arrays), *BM25_PARAMS)
    del arrays
    k1 = lambda: kern["K1"](*args, k=c["k"], n_docs=c["n_docs"])                # noqa: E731
    twin = lambda: ref.bm25_pruned_topk_ref(*args, k=c["k"], n_docs=c["n_docs"])  # noqa: E731
    (gv, gi, gt), (wv, wi, wt) = k1(), twin()
    torch.cuda.synchronize()
    require(bits_equal(gv, wv) and bits_equal(gi, wi) and bits_equal(gt, wt),
            "K1 past the old range limit != twin")
    ranges = -(-c["n_docs"] // range_docs(c["T"], c["k"]))
    ms, plain_ms = paired_ms(k1, twin, reps=3)
    touched = int(gt.sum())
    r = dict(err=max_abs_err(gv, wv), ms=ms, plain_ms=plain_ms, library_ms=None,
             graph_ms=graph_ms(k1, reps=5),
             bound=k1_bound(1, touched, args[0].shape[-1], T=c["T"], M=c["M"], k=c["k"]),
             shape=f"Q=1, T={c['T']}, M={c['M']}, B=128, n_docs={c['n_docs']}, k={c['k']}; "
                   f"{ranges} ranges, (T + 2) x ranges = {(c['T'] + 2) * ranges}; touched "
                   f"{touched} of {int(args[5].sum())} valid blocks")
    print(f"[4] K1 past the old range limit ({r['shape']}): bitwise == twin; kernel "
          f"{ms:.4f} ms, in a CUDA graph {r['graph_ms']:.4f} ms, twin {plain_ms:.3f} ms, bound "
          f"{r['bound'][0]:.6f} ms ({r['bound'][1]})", flush=True)
    del args
    torch.cuda.empty_cache()
    return r


def k1_bound(Q, touched, B, T=MAX_TERMS, M=MAX_BLOCKS, k=K) -> tuple[float, str]:
    """K1's least time: the kept postings (tf, dl, doc: 9 B each), the
    per-block inputs and the output, each moved once."""
    kept = touched * B
    return bound_ms(kept * 9 + Q * T * (4 + M * 5) + Q * (k * 8 + 4), kept * 8)


def device_split(fn, calls: int = 5) -> dict:
    """Device time a call of each kernel ``fn()`` launches, in µs, from a
    ``torch.profiler`` trace over ``calls`` calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("(")[0][:48]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def k1_k6_phase(kern, ref, torch, device="cuda") -> dict:
    """K1 at Q 1 and 64 on seeded 1M-doc blocks, K6 at fm's and dcn-v2's
    bulk shapes; each bitwise against its twin and timed in turns with it."""
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import _flat_ids
    out = {}
    n, k = K1_ONLY["n_docs"], K1_ONLY["k"]
    for Q in K1_ONLY["queries"]:
        args = (*k1_blocks(torch, Q, device), *BM25_PARAMS)
        k1 = lambda: kern["K1"](*args, k=k, n_docs=n)                       # noqa: E731
        twin = lambda: ref.bm25_pruned_topk_ref(*args, k=k, n_docs=n)        # noqa: E731
        (gv, gi, gt), (wv, wi, wt) = k1(), twin()
        torch.cuda.synchronize()
        require(bits_equal(gv, wv) and bits_equal(gi, wi) and bits_equal(gt, wt),
                f"K1 != twin at Q={Q}")
        ms, plain_ms = paired_ms(k1, twin, reps=10)
        touched = int(gt.sum())
        r = out[f"K1 Q={Q}"] = dict(
            err=max_abs_err(gv, wv), ms=ms, plain_ms=plain_ms, library_ms=None,
            graph_ms=graph_ms(k1),
            bound=k1_bound(Q, touched, args[0].shape[-1]),
            shape=f"Q={Q}, T={K1_ONLY['T']}, M={K1_ONLY['M']}, B=128, n_docs={n}, k={k}; "
                  f"touched {touched} of {int(args[5].sum())} valid blocks")
        r["split_us"] = device_split(k1)
        print(f"[k] K1 at {r['shape']}: bitwise == twin; kernel {ms:.4f} ms, in a CUDA graph "
              f"{r['graph_ms']:.4f} ms, twin "
              f"{plain_ms:.3f} ms, bound {r['bound'][0]:.6f} ms ({r['bound'][1]}); device µs a "
              f"call by kernel {json.dumps(r['split_us'])}", flush=True)
        del args
    out["K1 past the old range limit"] = k1_wide_check(kern, ref, torch, device)
    for label, arch, table_name in K6_SHAPES:
        cfg = get_arch(arch).full_config()
        D = 1 if table_name == "linear" else cfg.embed_dim
        table = torch.randn(cfg.n_sparse * cfg.rows_per_field, D, device=device,
                            generator=torch.Generator(device).manual_seed(0))
        ids = _flat_ids(cfg, torch.as_tensor(recsys_batch(
            cfg, RECSYS_SHAPES["serve_bulk"])["sparse"]).to(device))
        r = out[f"K6 {label}"] = k6_timing(kern["K6"], ref, table, ids, torch)
        w = torch.ones(ids.shape, dtype=torch.float32, device=device)
        r["twin_turns"] = paired_ms(lambda: kern["K6"](table, ids, w),
                                    lambda: ref.embedding_bag_ref(table, ids, w), reps=3)
        print(f"[k] K6 {label} ({r['shape']}, {r['rows']} distinct rows): bitwise == twin; "
              f"kernel {r['ms']:.4f} ms, F.embedding_bag {r['library_ms']:.4f} ms, twin "
              f"{r['plain_ms']:.3f} ms; in turns with the twin {r['twin_turns'][0]:.4f} / "
              f"{r['twin_turns'][1]:.3f} ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]})",
              flush=True)
        del table, ids
        torch.cuda.empty_cache()
    return out


def k3_phase(kern, ref, torch, device="cuda", seed=0) -> dict:
    """K3's two entry points at Q 1 and 64 on ``synth_pruned_blocks`` (T 16,
    M 64, B 128, 1M docs) with a seeded doc_len table, as phase 4 runs
    them on the index's blocks."""
    out = {}
    n = K1_ONLY["n_docs"]
    g = torch.Generator(device).manual_seed(seed)
    doc_len = torch.randint(5, 48, (n + 1,), generator=g, device=device).float()
    for Q in K1_ONLY["queries"]:
        tf, _, docs, idf_q, _, valid = k1_blocks(torch, Q, device)
        r = out[f"K3 Q={Q}"] = k3_cases(kern["K3"], ref, torch, tf, docs, valid[..., None],
                                        doc_len, idf_q, BM25_PARAMS, n)
        print_k3("3", Q, r)
    return out


def latency_phase(searcher, queries, torch, configs, kern, reps: int = 5):
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
    for name in names:
        profile_window("4", name, lambda q: searchers[name].search_batch([q]),
                       queries[:6], kern)
    return out


# The kernels each gateway route must launch; every other kernel must stay at 0.
PATHS = {"/search": ("K1",), "/search-dense-kernels": ("K3", "K2"), "/search-plain": ()}
# The route whose run gives each kernel's ``launches`` in the kernels line.
COUNTED_ON = {"K1": "/search", "K2": "/search-dense-kernels", "K3": "/search-dense-kernels"}


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
        if "K3" in expected:
            require(launches[route]["K3"] == len(got),
                    f"{route}: K3 launched {launches[route]['K3']} times in {len(got)} calls")
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


def fleet_queries(docs, df: dict, max_postings: int, n: int) -> list[str]:
    """``n`` queries of ``synth_queries`` (seed 6) whose every term has at
    most ``max_postings`` postings in the whole corpus: no partition and no
    single node truncates them, the precondition of the partition-count
    invariance the sparse check holds the fleet to."""
    from repro_torch.data.corpus import synth_queries
    from repro_torch.index.tokenizer import tokenize
    out = []
    for q in synth_queries(docs, 2000 * n, seed=6):
        terms = tokenize(q)
        if terms and all(df.get(t, 0) <= max_postings for t in terms):
            out.append(q)
            if len(out) == n:
                return out
    raise AssertionError(f"only {len(out)} of {n} untruncated queries in the corpus")


def k4_phase(app, cfg, queries, torch, ref, k4, device):
    """Phase 6a: K4 (+ K2's merge) against its twin on one real partition's
    dense rows, at Q=1 and Q=64, bitwise; times beside the twin, a library
    matmul + ``torch.topk`` and the bound."""
    from repro_torch.core.refresh import generation_version
    from repro_torch.search.searcher import lazy_hydrate_dense_searcher
    entry, _ = lazy_hydrate_dense_searcher(app.catalog, app.assets[0], cfg,
                                           generation_version(app.indexer.gen), device)
    entry.ensure_live()
    rows = entry.searcher.rows
    N, D = rows.shape
    qv = torch.as_tensor(np.stack([app.embedder(q) for q in queries])).to(rows.device)
    from repro_torch.kernels.dot_topk import survivors
    out = {}
    for Q in (1, len(queries)):
        out[Q] = k4_case(k4, ref, torch, qv[:Q].contiguous(), rows, K, f"K4 Q={Q}")
        out[Q]["survivors"] = Q * survivors(N, K)
        print_case("6", "K4 (+ K2's merge)", out[Q])
    del entry, rows
    torch.cuda.empty_cache()
    return out


# Each hand-written kernel's name in a device trace. Its wrapper adds one to
# its counter for each launch of it.
# K5's three kernels (f32 CUDA cores, bf16 tensor cores, bf16 split-KV) each
# count once a call; split-KV's merge launch is not counted. K1 counts its
# range kernel; its theta kernel launches once a call beside it.
TRACE_NAMES = {"K1": ("pruned_range_kernel",), "K2": ("topk_select_kernel",),
               "K3": ("bm25_block_kernel",), "K4": ("dot_topk_tiles_kernel",),
               "K5": ("flash_short_kernel", "flash_tiled_kernel", "flash_tc_fwd_kernel",
                      "flash_split_fwd_kernel"),
               "K6": ("embedding_bag_kernel",)}
PROFILE_ATTEMPTS = 3
# Host-only time on either side of the recorded queries: the trace keeps a
# device event only if its timestamp, moved to the host's clock, falls
# inside the recorded step, so a kernel that ends just before the step does
# would be lost.
PROFILE_MARGIN_S = 0.05


def profile_window(tag, name, run, queries, kern, top: int = 4) -> None:
    """Device busy share over ``run(q)`` for each of ``queries[1:]``, from a
    ``torch.profiler`` trace whose first step, ``run(queries[0])``, only
    warms the profiler up and is not recorded. The launch counters are set
    to 0 before the recorded step, and the trace must hold exactly as many
    launches of each hand-written kernel as the counters say: a trace that
    lost events is taken again, and after ``PROFILE_ATTEMPTS`` incomplete
    traces no busy share is reported. Busy time sums the device's own events
    (kernels, copies), not the host ops that launched them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run(queries[0])
            torch.cuda.synchronize()
            prof.step()
            reset(kern)
            time.sleep(PROFILE_MARGIN_S)
            t0 = time.perf_counter()
            for q in queries[1:]:
                run(q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_MARGIN_S)
            prof.step()
        counted = {n: fn.launches for n, fn in kern.items()}
        # the device's own events; a step's span on the device timeline
        # (``ProfilerStep*``, a user annotation) would count the step twice
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("ProfilerStep")]
        traced = {n: sum(e.count for e in events if any(t in e.key for t in TRACE_NAMES[n]))
                  for n in kern}
        if traced == counted:
            break
        print(f"[{tag}] profile {name}, attempt {attempt}: the trace holds {traced} launches, "
              f"the counters {counted}; taken again", flush=True)
    else:
        print(f"[{tag}] profile {name}: no complete trace in {PROFILE_ATTEMPTS} attempts, "
              f"busy share not reported", flush=True)
        return
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"[{tag}] profile {name}, {len(queries) - 1} warm queries (trace complete: "
          f"{traced} launches == counters, attempt {attempt}): wall {wall * 1e3:.3f} ms, "
          f"device busy {dev_us / 1e3:.3f} ms ({dev_us / 1e4 / wall:.1f}% busy)", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.key[:60]:60s} {e.self_device_time_total:10.1f} us x{e.count}",
              flush=True)


def _bits(scores) -> list:
    return np.float32(scores).view(np.uint32).tolist()


def kill_all(app) -> None:
    """Kill every instance of every function: the next query is cold."""
    for fn in [fn for group in app.fn_groups for fn in group]:
        while app.runtime.kill_instance(fn=fn):
            pass


def fleet_traffic(app, queries, oracle, kern, tag="6", profile=True, served=None, kill=True):
    """Phase 6b: per mode, kill every instance (``kill``; else the pools
    stay as they are, e.g. prewarmed by a rollover), then one first query
    (cold when killed), 20 warm queries and a 64-query micro-batch through
    ``submit``/``flush``, with the launch counters set to 0 before the mode
    and read after it. Every ext id served goes into ``served`` when given;
    ``profile`` takes a profiler window of each mode."""
    from repro_torch.core.partition import rrf_fuse
    answers, launches = {}, {}
    first = "cold" if kill else "first"
    for mode, expected in FLEET_MODES.items():
        if kill:
            kill_all(app)
        n0 = len(app.runtime.records)
        for fn in kern.values():
            fn.launches = 0
        serial, walls = [], []
        for q in queries[:21]:
            t0 = time.perf_counter()
            r = app.query(q, k=K, mode=mode, t_arrival=app.runtime.clock + 0.05)
            walls.append((time.perf_counter() - t0) * 1e3)
            require(r.status == 200, f"{mode}: status {r.status} {r.body}")
            serial.append(r.body)
        recs = app.runtime.records[n0:]
        batches0 = app.gateway.window_stats("GET", "/search")["batches"]
        t_sub = app.runtime.clock + 1.0
        t0 = time.perf_counter()
        handles = [app.submit(q, k=K, mode=mode, t_arrival=t_sub + i * 1e-4)
                   for i, q in enumerate(queries)]
        app.flush()
        batch_wall = (time.perf_counter() - t0) * 1e3
        launches[mode] = {name: fn.launches for name, fn in kern.items()}
        windowed = [h.response for h in handles]
        require(all(w.status == 200 for w in windowed), f"{mode}: windowed status")
        stats = app.gateway.window_stats("GET", "/search")
        require(stats["batches"] == batches0 + 1, f"{mode}: the 64 queries did not share one window")
        for name, n in launches[mode].items():
            require((n > 0) == (name in expected),
                    f"fleet {mode}: kernel {name} launched {n} times, expected "
                    f"{'some' if name in expected else 'none'}")
        cold, warm = recs[:FLEET_PARTS], recs[FLEET_PARTS:]
        require((not kill or all(r.cold for r in cold)) and not any(r.cold for r in warm),
                f"{mode}: cold/warm pattern")
        warm_exec = [max(r.exec_s for r in warm[i:i + FLEET_PARTS]) * 1e3
                     for i in range(0, len(warm), FLEET_PARTS)]
        if served is not None:
            for body in serial + [w.body for w in windowed]:
                served.update(body["ext_ids"])
        # the second query is warm but pays the rebuild of each lazy sparse
        # searcher after the cold query's backfill; queries 3-21 are steady
        print(f"[{tag}] {mode}: launches {launches[mode]}; {first} hydrate_s (modeled, max of "
              f"{FLEET_PARTS} legs) {max(r.hydrate_s for r in cold):.4f}, {first} exec_s "
              f"{max(r.exec_s for r in cold) * 1e3:.1f} ms, {first} wall {walls[0]:.1f} ms; "
              f"second query wall {walls[1]:.1f} ms, exec_s (slowest leg) "
              f"{warm_exec[0]:.1f} ms; warm wall (queries 2-21) p50 "
              f"{np.percentile(walls[1:], 50):.3f} ms p99 {np.percentile(walls[1:], 99):.3f} ms, "
              f"steady (queries 3-21) p50 {np.percentile(walls[2:], 50):.3f} ms p99 "
              f"{np.percentile(walls[2:], 99):.3f} ms; steady exec_s (slowest leg) p50 "
              f"{np.percentile(warm_exec[1:], 50):.3f} ms p99 "
              f"{np.percentile(warm_exec[1:], 99):.3f} ms; 64-query window wall "
              f"{batch_wall:.1f} ms, exec_s (slowest leg) "
              f"{max(r.exec_s for r in app.runtime.records[-FLEET_PARTS:]) * 1e3:.3f} ms",
              flush=True)
        for i, (a, w) in enumerate(zip(serial, windowed)):
            require(a["ext_ids"] == w.body["ext_ids"] and _bits(a["scores"]) == _bits(w.body["scores"]),
                    f"{mode} query {i}: windowed != serial")
        answers[mode] = [w.body for w in windowed]
        if profile:
            profile_window(tag, f"fleet {mode}", lambda q: app.query(
                q, k=K, mode=mode, t_arrival=app.runtime.clock + 0.05), queries[20:26], kern)
    for qi, q in enumerate(queries):
        d = answers["dense"][qi]
        want = oracle.search(q, k=K)
        require(d["ext_ids"] == [oracle.doc_ids[i] for i, _ in want]
                and _bits(d["scores"]) == _bits([v for _, v in want]),
                f"dense query {qi}: != full-corpus oracle")
        fused = rrf_fuse([answers["sparse"][qi]["ids"], d["ids"]], K)
        h = answers["hybrid"][qi]
        require(h["ids"] == [i for i, _ in fused] and h["scores"] == [v for _, v in fused],
                f"hybrid query {qi}: != rrf_fuse of the fleet's sparse and dense rankings")
        s = answers["sparse"][qi]
        require(all(np.isfinite(s["scores"])) and s["scores"] == sorted(s["scores"], reverse=True)
                and len(d["ids"]) == K, f"query {qi}: scores not finite/descending or short")
    print(f"[{tag}] all {len(queries)} queries: dense == full-corpus oracle (ids, score bits); "
          f"hybrid == rrf_fuse(sparse, dense); windowed == serial (bits) on the first 21",
          flush=True)
    return launches


def sparse_vs_single(app, single, queries):
    """Phase 6c: the fleet's sparse answers against the single-node pruned
    route over the same corpus, to the reference's partition-count standard
    (``tests/test_parity.py``): equal ext ids, scores equal to 6 decimals."""
    for qi, q in enumerate(queries):
        s = app.query(q, k=K, t_arrival=app.runtime.clock + 0.05, fetch_docs=False).body
        one = single.query(q, k=K, fetch_docs=False).body
        require(s["ext_ids"] == one["ext_ids"] and s["ext_ids"]
                and [round(x, 6) for x in s["scores"]] == [round(x, 6) for x in one["scores"]],
                f"sparse query {qi} {q!r}: fleet != single-node pruned route")
    print(f"[6] {len(queries)} untruncated queries: fleet sparse == single-node pruned route "
          f"(ext ids, scores to 6 decimals)", flush=True)


COMMIT_CHURN = 100            # phase 6's commit adds and deletes 1 in 100 live docs: 1 % churn


def memo_embedder(dim: int):
    """``hash_embedder(dim)`` remembering each text's vector: the fleet's
    indexer embeds every doc once, and the oracles built over the same
    texts read them back instead of embedding the corpus again."""
    from repro_torch.data.corpus import hash_embedder
    embed, seen = hash_embedder(dim), {}

    def memo(text: str):
        v = seen.get(text)
        if v is None:
            v = seen[text] = embed(text)
        return v

    memo.dim = dim
    return memo


def dense_oracle_after(oracle, live, embedder, torch):
    """The full-corpus dense oracle of a later generation: the earlier
    oracle's row of every surviving doc (a doc's vector is a function of its
    text alone), the embedder's for the docs added since, in ``live``'s
    order."""
    from repro_torch.search.oracle import DenseOracleSearcher
    at = {e: i for i, e in enumerate(oracle.doc_ids)}
    ids = [e for e, _ in live]
    old = torch.tensor([at.get(e, -1) for e in ids], device=oracle.device)
    rows = oracle.vectors[old.clamp(min=0)]
    fresh = [i for i, e in enumerate(ids) if e not in at]
    if fresh:
        rows[torch.tensor(fresh, device=oracle.device)] = torch.as_tensor(
            np.stack([embedder(live[i][1]) for i in fresh])).to(oracle.device)
    new = DenseOracleSearcher([], embedder, device=oracle.device)
    new.doc_ids, new.vectors = ids, rows
    return new


def fleet_commit(app, queries, oracle, torch, kern):
    """Phase 6d: a commit at full scale. ``add_documents`` of n new
    documents and ``delete_documents`` of n live ones (n the live docs
    over COMMIT_CHURN), one
    ``commit()`` (the merge policy's defaults publish deltas at this churn),
    then the modes' traffic again on the new generation. Returns the
    traffic's launches."""
    from repro_torch.data.corpus import synth_corpus
    live = [e for e, _ in app.indexer.live_corpus()]
    n = len(live) // COMMIT_CHURN
    added = [(f"nrt{i:06d}", text) for i, (_, text) in enumerate(
        synth_corpus(n, vocab=1 << 19, mean_len=60, seed=2))]
    require(not set(e for e, _ in added) & set(live), "added ext ids collide")
    rng = np.random.default_rng(3)
    deleted = [live[i] for i in rng.choice(len(live), n, replace=False)]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    require(app.add_documents(added).ok and app.delete_documents(deleted).ok, "staging")
    n_rec = len(app.runtime.records)
    t1 = time.perf_counter()
    c = app.commit()
    t2 = time.perf_counter()
    require(c.status == 200 and c.body.get("committed") and c.body["gen"] == 2,
            f"commit: {c.status} {c.body}")
    require(not c.body["merged"], f"the commit merged partitions {c.body['merged']}: at "
            f"1 % churn the merge policy's defaults must publish deltas")
    recs = app.runtime.records[n_rec:]
    writers = [r for r in recs if r.write]
    pings = [r for r in recs if r.keepalive]
    first = app.query(queries[0], k=K, t_arrival=app.runtime.clock + 0.05)
    t3 = time.perf_counter()
    require(first.status == 200 and first.body["generation"] == 2, "first answer of gen 2")
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    mem2 = torch.cuda.memory_allocated()
    by_pool: dict = {}
    for r in pings:
        by_pool.setdefault(r.fn, []).append(r)
    print(f"[6] commit of {n} adds and {n} deletes: staging "
          f"{(t1 - t0) * 1e3:.1f} ms, commit() host wall {t2 - t1:.2f} s, modeled latency "
          f"{c.latency_s:.4f} s; writers {len(writers)}, ops "
          f"{ {w.fn: 'merge' if int(w.fn.rsplit('p', 1)[1]) in c.body['merged'] else 'delta' for w in writers} }, "
          f"writer exec_s {[round(w.exec_s, 3) for w in writers]}", flush=True)
    print(f"[6] rollover: {c.body['pings']} pings; cold hydrations per pool "
          f"{ {fn: sum(r.hydrate_s > 0 for r in rs) for fn, rs in by_pool.items()} }, "
          f"modeled hydrate_s per pool { {fn: round(sum(r.hydrate_s for r in rs), 4) for fn, rs in by_pool.items()} }; "
          f"wall from commit() to the first answer of generation 2 {t3 - t1:.2f} s", flush=True)
    print(f"[6] torch.cuda.memory_allocated: before the commit {mem0} B, after it {mem1} B, "
          f"after gc {mem2} B", flush=True)
    t0 = time.perf_counter()
    live_docs = app.indexer.live_corpus()
    oracle = dense_oracle_after(oracle, live_docs, app.embedder, torch)
    print(f"[6] generation 2's dense oracle ({oracle.vectors.shape[0]} rows) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    served: set = set(first.body["ext_ids"])
    # the rollover prewarmed every pool on generation 2: each mode's first
    # query is generation 2's first touch of that tier, not a killed pool's
    launches = fleet_traffic(app, queries, oracle, kern, tag="6 gen 2", profile=False,
                             served=served, kill=False)
    gone = served & set(deleted)
    require(not gone, f"deleted ext ids served after the commit: {sorted(gone)[:5]}")
    print(f"[6] generation 2: {len(served)} distinct ext ids served, none of the "
          f"{n} deleted", flush=True)
    return launches


def fleet_phase(docs, queries, single, torch, ref, kern, device="cuda"):
    """Phase 6: the partitioned fleet with its dense tier on the card."""
    from repro_torch.core.gateway import WindowPolicy
    from repro_torch.core.partition import FleetSpec, GatewaySpec, IndexSpec, VectorSpec
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.search.oracle import DenseOracleSearcher
    from repro_torch.search.searcher import SearchConfig
    from repro_torch.search.service import build_partitioned_search_app
    cfg = SearchConfig(accumulator="pruned", use_kernel=True, use_topk_kernel=True)
    t0 = time.perf_counter()
    # one window takes the whole 64-query micro-batch (max_batch flushes it)
    app = build_partitioned_search_app(docs, FleetSpec(
        n_parts=FLEET_PARTS, index=IndexSpec(vector=VectorSpec(
            dim=VEC_DIM, embedder=memo_embedder(VEC_DIM))),
        gateway=GatewaySpec(window=WindowPolicy(max_window_s=1.0, target_batch=N_QUERIES,
                                                sparse_qps=0.0, p99_budget_s=None,
                                                max_batch=N_QUERIES)),
        search_config=cfg, runtime_config=RuntimeConfig(seed=0)), device=device)
    t1 = time.perf_counter()
    sizes = [len(st.seg_docs) for st in app.indexer.parts]
    untruncated = fleet_queries(docs, app.indexer.stats["df"], cfg.max_blocks * 128, N_QUERIES)
    print(f"[6] fleet of {FLEET_PARTS} partitions {sizes}, dense tier dim {VEC_DIM} "
          f"({sizes[0] * VEC_DIM * 4} B of f32 rows in partition 0): built and published in "
          f"{t1 - t0:.1f} s; {len(untruncated)} queries whose terms have <= "
          f"{cfg.max_blocks * 128} postings picked in {time.perf_counter() - t1:.1f} s",
          flush=True)
    k4 = k4_phase(app, dataclasses.replace(cfg, lazy_hydration=True), queries, torch, ref,
                  kern["K4"], device)
    t0 = time.perf_counter()
    oracle = DenseOracleSearcher(app.indexer.live_corpus(), app.embedder, device=device)
    print(f"[6] full-corpus dense oracle ({oracle.vectors.shape[0]} rows, twin on the card) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    launches = fleet_traffic(app, queries, oracle, kern)
    print(f"[6] max_memory_allocated during the fleet traffic "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    sparse_vs_single(app, single, untruncated)
    t0 = time.perf_counter()
    after = fleet_commit(app, queries, oracle, torch, kern)
    launches.update({f"{mode} after commit": c for mode, c in after.items()})
    print(f"[6] the commit and generation 2's traffic took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return k4, launches, sizes


# -- phase 7: LM serving on K5 ---------------------------------------------------------

LM_ARCH = "h2o-danube-1.8b"
LM_SERVE = dict(batch=4, prompt=6144, steps=32)     # prompts longer than the 4096 window
LM_CHECK = dict(batch=2, prompt=4608, steps=8)      # decode == forward, f32
BF16_FLOPS = 989e12            # H100 SXM, bf16 on the tensor cores (dense)


def k5_bound(q, k, v, *, causal=False, window=None, kv_len=None,
             sm_scale=None) -> tuple[float, str]:
    """The least time for one K5 call: operations on the visible (query,
    key) pairs over the bf16 tensor-core peak (f32: the CUDA-core peak),
    or q, k, v read and the output written once over the HBM rate."""
    from repro_torch.kernels.flash_attention import visible_pairs
    B, Hq, Sq, D = q.shape
    Skv, Dv = k.shape[2], v.shape[-1]
    pairs = visible_pairs(Sq, Skv, causal=causal, window=window, kv_len=kv_len) * B * Hq
    size = q.element_size()
    n_bytes = size * (q.numel() + k.numel() + v.numel() + B * Hq * Sq * Dv)
    peak = BF16_FLOPS if size == 2 else F32_FLOPS
    t_ops = 2 * (D + Dv) * pairs / peak * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(view), b.view(view)))


def reset(kern) -> None:
    for fn in kern.values():
        fn.launches = 0
        for by in ("launches_by", "launches_by_path"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


def k5_variants(kern, route: str, expected: dict) -> dict:
    """K5's per-variant counters after a route's run: ``expected`` exactly,
    every other variant never."""
    got = dict(kern["K5"].launches_by)
    want = {name: expected.get(name, 0) for name in got}
    require(got == want, f"{route}: K5 variants {got}, expected {want}")
    return got


def simt_paths(kern, route: str, expected: dict) -> dict:
    """K5's f32 ("simt") counters after a route's run, by path (short,
    tiled): ``expected`` exactly, the other path never, and no bf16
    variant."""
    got = dict(kern["K5"].launches_by_path)
    want = {name: expected.get(name, 0) for name in got}
    require(got == want, f"{route}: K5 f32 paths {got}, expected {want}")
    k5_variants(kern, route, {"simt": sum(want.values())})
    return got


def counted(kern, route: str, expected: dict) -> dict:
    """The counters after a route's run: the ``expected`` kernels exactly
    that often, every other kernel never."""
    got = {name: fn.launches for name, fn in kern.items()}
    want = {name: expected.get(name, 0) for name in kern}
    require(got == want, f"{route}: launches {got}, expected {want}")
    return got


def lm_expect(cfg) -> dict:
    """The launches of one prefill and of one decode step, by kernel and by
    K5 variant: K5 once a layer ("tc" prefill, "split" decode; an MLA
    decode attends in plain torch and launches none), K2 once a layer for
    an MoE's router."""
    L = cfg.n_layers
    pre, step = {"K5": L}, {} if cfg.mla is not None else {"K5": L}
    if cfg.moe is not None:
        pre["K2"] = step["K2"] = L
    return {"prefill": pre, "step": step, "prefill_by": {"tc": L},
            "step_by": {"split": L} if "K5" in step else {}}


def lm_serve(model, cfg, prompts, steps, kern, torch, device, tag="7"):
    """Phase 7b (and 12, 13), the main path: ``lm_prefill`` on the prompts,
    then greedy ``lm_decode`` steps; the launch counters set to 0 before the
    prefill and before the decode steps, read after each and after every
    step (:func:`lm_expect`). Then a profiler window over 5 more decode
    steps."""
    from repro_torch.models.transformer import lm_decode, lm_prefill
    B, S = prompts.shape
    expect = lm_expect(cfg)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset(kern)
    t0 = time.perf_counter()
    logits, cache = lm_prefill(model, prompts, cfg, max_len=S + steps, device=device)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = {"lm:prefill": counted(kern, "lm:prefill", expect["prefill"])}
    variants = {"lm:prefill": k5_variants(kern, "lm:prefill", expect["prefill_by"])}
    require(bool(torch.isfinite(logits.float()).all()), "prefill logits not finite")
    tok = logits.argmax(-1, keepdim=True)
    step_ms, out = [], [tok]
    reset(kern)
    for t in range(steps):
        before = {name: fn.launches for name, fn in kern.items()}
        t0 = time.perf_counter()
        logits, cache = lm_decode(model, cache, tok, S + t, cfg, device=device)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        got = {name: fn.launches - before[name] for name, fn in kern.items()}
        want = {name: expect["step"].get(name, 0) for name in kern}
        require(got == want, f"decode step {t}: launches {got}, expected {want}")
        out.append(tok)
    launches["lm:decode"] = counted(kern, "lm:decode",
                                    {n: c * steps for n, c in expect["step"].items()})
    variants["lm:decode"] = k5_variants(kern, "lm:decode",
                                        {n: c * steps for n, c in expect["step_by"].items()})
    gen = torch.cat(out, dim=1)
    require(bool(torch.isfinite(logits.float()).all()) and gen.shape == (B, steps + 1)
            and bool(((gen >= 0) & (gen < cfg.vocab)).all()), "decode output malformed")
    profile_window(tag, "lm decode", lambda i: lm_decode(model, cache, tok, S + steps + i, cfg,
                                                          device=device), range(6), kern)
    t = np.array(step_ms)
    slots = cache["ckv"].shape[2] if cfg.mla is not None else cache["k"].shape[3]
    r = dict(prefill_ms=prefill_ms, p50=float(np.percentile(t, 50)),
             p99=float(np.percentile(t, 99)), tok_s=B * steps / (t.sum() / 1e3),
             peak=torch.cuda.max_memory_allocated() - base, slots=slots, variants=variants)
    print(f"[{tag}] served {B} prompts x {S} tokens: prefill wall {prefill_ms:.1f} ms "
          f"({B * S / prefill_ms * 1e3:.0f} prompt tokens/s); {steps} greedy decode steps "
          f"against a ring of {r['slots']} slots: step wall p50 {r['p50']:.3f} ms p99 "
          f"{r['p99']:.3f} ms, {r['tok_s']:.1f} tokens/s (batch {B}); launches "
          f"{launches['lm:prefill']} in the prefill (K5 {variants['lm:prefill']}), "
          f"{expect['step']} in each decode step (K5 {variants['lm:decode']} over the {steps} "
          f"steps); max_memory_allocated {r['peak']} B above the {base} B held before the "
          f"prefill (the weights and what earlier phases hold)", flush=True)
    return r, launches, cache


def sdpa_mask(torch, Sq, Skv, device, *, causal=False, window=None, kv_len=None,
              sm_scale=None):
    """(Sq, Skv) bool, True where a query sees a key: K5's masks for
    ``scaled_dot_product_attention`` (the scale masks nothing)."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=device)[None, :]
    mask = (kpos < (Skv if kv_len is None else kv_len)).expand(Sq, Skv)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms with the host's launch cost out of
    the way: ``reps`` calls captured into one CUDA graph, CUDA events around
    its replay (after a warm-up call and a warm-up replay)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


ORACLE_SCORES = 1 << 22         # f32 scores per (batch, head) the dense oracle may hold


def k5_row_tol(torch, want, sdpa):
    """The bf16 kernels' bound against the twin for each row of the output:
    ``max(2·max_row|SDPA − twin|, one bf16 ulp of max_row|twin|)``. The ulp
    lies in (2⁻⁸, 2⁻⁷] of the row's largest value: the output's own bf16
    rounding can differ by that much where two f32 results straddle a
    rounding step. Per row, so that the long rows of a prefill, whose values
    are small, are not held to the bound of its first rows, which see a few
    keys and carry the largest values."""
    w = want.float()
    top = w.abs().amax(-1)
    ulp = torch.where(top > 0, torch.exp2(torch.frexp(top).exponent.float() - 8), 0.0)
    return torch.maximum(2 * (sdpa.float() - w).abs().amax(-1), ulp)


def k5_rows_within(name, torch, got, want, row_tol, against="twin") -> float:
    """Require every row of ``got`` within its ``row_tol`` of ``want``;
    returns the worst row's excess over its bound (<= 0)."""
    excess = float(((got.float() - want.float()).abs().amax(-1) - row_tol).max())
    require(excess <= 0, f"K5 ({name}): a row is off the {against} by {excess} more than its "
                         f"per-row bound")
    return excess


def k5_check(name, k5, ref, torch, a, b, c, kw, tag="7") -> dict:
    """One K5 case against the twin: bitwise for f32; for bf16 within
    ``max(2·max|SDPA − twin|, 2⁻⁸·max|twin|)`` over the whole output and
    within :func:`k5_row_tol` on every row, SDPA being
    ``scaled_dot_product_attention`` on the same inputs and mask (a row
    that sees no key as 0). Then within 2e-2 of the dense oracle on the last
    query rows whose scores fit ``ORACLE_SCORES``, and, for a causal
    prefill too long for that, on as many first rows (which see only the
    first keys). With ``return_lse`` the output's bits are the call's
    without it, and each row's lse is the twin's: bitwise for f32, within
    ``LSE_TOL``·max(1, |twin|) for bf16, −inf where the twin's is."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import LSE_TOL, variant
    got = k5(a, b, c, **kw)
    got_lse_out, got_lse = k5(a, b, c, return_lse=True, **kw)
    (want, want_lse), plain_ms = cuda_call_ms(
        lambda: ref.flash_attention_ref(a, b, c, return_lse=True, **kw))
    err = max_abs_err(got.float(), want.float())
    r = dict(err=err, plain_ms=plain_ms)
    require(same_bits(got_lse_out, got), f"K5 ({name}): return_lse changed the output's bits")
    dead = torch.isinf(want_lse)
    require(torch.equal(torch.isinf(got_lse), dead), f"K5 ({name}): lse -inf rows differ")
    r["lse_err"] = max_abs_err(got_lse[~dead], want_lse[~dead])
    if a.dtype == torch.float32:
        require(same_bits(got_lse, want_lse), f"K5 lse != twin ({name})")
        lse_held = "bitwise"
    else:
        lse_tol = LSE_TOL * torch.clamp(want_lse[~dead].abs(), min=1.0)
        r["lse_over_tol"] = float(((got_lse[~dead] - want_lse[~dead]).abs() / lse_tol).max()) \
            if lse_tol.numel() else 0.0
        require(r["lse_over_tol"] <= 1.0, f"K5 ({name}): lse off the twin by "
                                          f"{r['lse_over_tol']:.3g} of LSE_TOL")
        lse_held = f"{r['lse_over_tol']:.3g} of LSE_TOL"
    del got_lse_out, got_lse, want_lse
    if a.dtype == torch.float32:
        require(same_bits(got, want), f"K5 != twin ({name})")
        held = "bitwise == twin"
    else:
        mask = sdpa_mask(torch, a.shape[2], b.shape[2], a.device, **kw)
        sdpa = torch.nan_to_num(F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, enable_gqa=True, scale=kw.get("sm_scale")), nan=0.0)
        r["sdpa_err"] = max_abs_err(sdpa.float(), want.float())
        r["tol"] = max(2 * r["sdpa_err"], 2.0 ** -8 * float(want.float().abs().max()))
        require(err <= r["tol"], f"K5 ({name}) off the twin by {err}, more than {r['tol']}")
        r["row_tol"] = k5_row_tol(torch, want, sdpa)
        r["row_excess"] = k5_rows_within(name, torch, got, want, r["row_tol"])
        held = (f"within {r['tol']:.3e} of the twin (SDPA's distance {r['sdpa_err']:.3e}) and "
                f"every row within its own bound (worst row {r['row_excess']:.3e} past it; "
                f"bounds {float(r['row_tol'].min()):.3e} to {float(r['row_tol'].max()):.3e}); "
                f"variant {variant(a.dtype, a.shape[1] // b.shape[1] * a.shape[2])}")
        del sdpa, mask
    Sq, Skv = a.shape[2], b.shape[2]
    rows = max(1, min(Sq, ORACLE_SCORES // Skv))
    spans = {"last": (slice(Sq - rows, Sq), slice(None))}
    if rows < Sq and Sq == Skv and kw.get("causal") and kw.get("kv_len") is None:
        spans["first"] = (slice(0, rows), slice(0, rows))
    r["oracle_err"] = 0.0
    for span, (qs, ks) in spans.items():
        oracle = ref.mha_attention_ref(a[:, :, qs], b[:, :, ks], c[:, :, ks], **kw).float()
        part = got[:, :, qs].float()
        e = max_abs_err(part, oracle)
        r["oracle_err"] = max(r["oracle_err"], e)
        require(bool(torch.allclose(part, oracle, rtol=2e-2, atol=2e-2)),
                f"K5 ({name}) off the dense oracle by {e} on the {span} {rows} query rows")
        del oracle, part
    print(f"[{tag}] K5 {name}: q {tuple(a.shape)} k {tuple(b.shape)} v {tuple(c.shape)} "
          f"{a.dtype} {kw}: {held} (max abs err {err}); max abs err against the dense oracle "
          f"{r['oracle_err']} on the {' and '.join(spans)} {rows} query rows; with return_lse "
          f"the same output bits, lse max abs err {r['lse_err']:.3g} against the twin's "
          f"({lse_held})", flush=True)
    return r


def k5_checks(model, cfg, prompts, cache, k5, ref, torch):
    """Phase 7c: K5 against its twin on layer 0's real q/k/v at the model's
    prefill and decode shapes (kv_len = slots and < slots) and one Dv != D
    case (:func:`k5_check`); the decode shape also against the plain
    split-KV version; then the prefill and decode shapes timed beside the
    twin, ``scaled_dot_product_attention`` (``enable_gqa`` and a boolean
    mask for the window and kv_len) and the bound: CUDA events around
    back-to-back calls, and around a CUDA graph of the same calls (the
    device's time without the host's launch cost), kernel and SDPA in
    turns (kernel, SDPA, SDPA, kernel)."""
    from repro_torch.kernels.flash_attention import split_plan
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import _qkv
    S = prompts.shape[1]
    slots = cache["k"].shape[3]
    with torch.inference_mode():
        lp = model.layers[0]
        positions = torch.arange(S, dtype=torch.int32, device=prompts.device)
        q, k, v = (t.contiguous() for t in _qkv(lp["attn"], rms_norm(
            model.embed[prompts.long()], lp["ln1"]), cfg, positions))
    kr, vr = cache["k"][0], cache["v"][0]                 # layer 0's ring
    qd = q[:, :, -1:].contiguous()
    n = 1024
    cases = {
        "prefill": (q, k, v, dict(causal=True, window=cfg.window)),
        "decode": (qd, kr, vr, dict(kv_len=slots)),
        "decode kv_len<slots": (qd, kr, vr, dict(kv_len=slots * 3 // 4)),
        "Dv!=D": (q[:, :, :n].contiguous(), k[:, :, :n].contiguous(),
                  v[:, :, :n, :64].contiguous(), dict(causal=True, window=cfg.window)),
    }
    out = {name: k5_check(name, k5, ref, torch, *case) for name, case in cases.items()}
    a, b, c, kw = cases["decode"]
    k_begin, split, n_split = split_plan(b.shape[0] * b.shape[1], a.shape[2], b.shape[2],
                                         window=None, kv_end=kw["kv_len"])
    got = k5(a, b, c, **kw)
    plain = ref.flash_attention_split_ref(a, b, c, k_begin=k_begin, split=split, **kw)
    out["decode"]["split_ref_err"] = max_abs_err(got.float(), plain.float())
    excess = k5_rows_within("decode", torch, got, plain, out["decode"]["row_tol"],
                            against="plain split-KV version")
    print(f"[7] K5 decode ({n_split} splits of {split} keys a (batch, kv head)) against the "
          f"plain split-KV version (f32): max abs err {out['decode']['split_ref_err']}, every "
          f"row within its bound against the twin (worst row {excess:.3e} past it)",
          flush=True)
    for r in out.values():
        r.pop("row_tol", None)
    for name in ("prefill", "decode"):
        k5_timing(name, out[name], cases[name], k5, ref, torch,
                  reps=5 if name == "prefill" else 50)
    return out


def k5_timing(name, r, case, k5, ref, torch, reps, tag="7") -> None:
    """K5 on ``case`` (q, k, v, kwargs) timed beside the twin,
    ``scaled_dot_product_attention`` (``enable_gqa`` and a boolean mask)
    and the bound: CUDA events around back-to-back calls, and around a CUDA
    graph of the same calls, kernel, kernel with ``return_lse`` (the lse
    epilogue, ``lse_ms``) and SDPA in turns (kernel, lse, SDPA, SDPA, lse,
    kernel). The times go into ``r``."""
    import torch.nn.functional as F
    a, b, c, kw = case
    mask = sdpa_mask(torch, a.shape[2], b.shape[2], a.device, **kw)
    sdpa = lambda: F.scaled_dot_product_attention(a, b, c, attn_mask=mask,  # noqa: E731
                                                  enable_gqa=True, scale=kw.get("sm_scale"))
    kernel = lambda: k5(a, b, c, **kw)                                     # noqa: E731
    lse = lambda: k5(a, b, c, return_lse=True, **kw)                      # noqa: E731
    timed = {"ms": [], "library_ms": [], "graph_ms": [], "library_graph_ms": [],
             "lse_ms": [], "lse_graph_ms": []}
    for key, fn in (("", kernel), ("lse_", lse), ("library_", sdpa), ("library_", sdpa),
                    ("lse_", lse), ("", kernel)):
        timed[f"{key}ms"].append(cuda_ms(fn, reps=reps))
        timed[f"{key}graph_ms"].append(graph_ms(fn, reps=reps))
    r.update({key: float(np.mean(t)) for key, t in timed.items()})
    if "plain_ms" not in r:       # k5_check timed the twin's call that it held K5 to
        r["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(a, b, c, **kw), reps=1,
                                warmup=1)
    r["bound"] = k5_bound(a, b, c, **kw)
    r["shape"] = (f"q {tuple(a.shape)}, k {tuple(b.shape)}, v {tuple(c.shape)}, {a.dtype}, "
                  f"{', '.join(f'{key}={val}' for key, val in kw.items())}")
    print(f"[{tag}] K5 {name} timing: kernel {r['ms']:.4f} ms ({timed['ms']}), in a CUDA graph "
          f"{r['graph_ms']:.4f} ms ({timed['graph_ms']}); with return_lse {r['lse_ms']:.4f} ms "
          f"({timed['lse_ms']}), in a CUDA graph {r['lse_graph_ms']:.4f} ms "
          f"({timed['lse_graph_ms']}); scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms ({timed['library_ms']}), in a CUDA graph "
          f"{r['library_graph_ms']:.4f} ms ({timed['library_graph_ms']}); twin "
          f"{r['plain_ms']:.1f} ms; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}): the "
          f"kernel at {r['bound'][0] / r['ms'] * 100:.1f} % of it "
          f"({r['bound'][0] / r['graph_ms'] * 100:.1f} % in the graph)", flush=True)


def lm_check(arch, kern, ref, torch, device="cuda", seed=1, check=LM_CHECK):
    """Phase 7d, the reference's own invariant (``tests/test_models.py``):
    prefill + decode steps reproduce the full forward's logits, at full
    width in f32 with TF32 off, on prompts longer than the window."""
    from repro_torch.data.lm import LMDataConfig, LMTokenStream
    from repro_torch.kernels.flash_attention import simt_path
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import (LM, lm_decode, lm_forward, lm_param_defs,
                                                lm_prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = arch.full_config(dtype=torch.float32)
    B, S, steps = check["batch"], check["prompt"], check["steps"]
    L = cfg.n_layers
    model = LM(init_params(lm_param_defs(cfg), torch.Generator(device).manual_seed(seed),
                           device), cfg)
    toks = torch.as_tensor(LMTokenStream(LMDataConfig(
        vocab=cfg.vocab, batch=B, seq=S + steps, seed=seed)).batch(0)["tokens"]).to(device)
    reset(kern)
    full, _ = lm_forward(model, toks, cfg, device=device)
    full = full[:, S - 1:].clone()
    pl, cache = lm_prefill(model, toks[:, :S], cfg, max_len=S + steps, device=device)
    errs = [max_abs_err(pl, full[:, 0])]
    require(bool(torch.allclose(pl, full[:, 0], rtol=2e-2, atol=2e-2)),
            f"f32 prefill logits != forward (max abs err {errs[0]})")
    for t in range(steps):
        step, cache = lm_decode(model, cache, toks[:, S + t:S + t + 1], S + t, cfg,
                                device=device)
        errs.append(max_abs_err(step, full[:, 1 + t]))
        require(bool(torch.allclose(step, full[:, 1 + t], rtol=5e-2, atol=5e-2)),
                f"f32 decode step {t} != forward (max abs err {errs[-1]})")
    launches = counted(kern, "lm:f32-check", {"K5": L * (2 + steps)})
    G, slots = cfg.n_heads // cfg.n_kv_heads, cache["k"].shape[3]
    want = collections.Counter({simt_path(G * (S + steps), S + steps, cfg.dh, cfg.dh): L})
    want[simt_path(G * S, S, cfg.dh, cfg.dh)] += L                  # the prefill
    want[simt_path(G, slots, cfg.dh, cfg.dh)] += L * steps          # the decode steps
    paths = simt_paths(kern, "lm:f32-check", want)
    print(f"[7] decode == forward at full width in f32 ({B} prompts x {S} tokens, ring of "
          f"{cache['k'].shape[3]} slots, {steps} steps): prefill logits max abs err "
          f"{errs[0]:.3e} (rtol/atol 2e-2), decode steps max abs err {max(errs[1:]):.3e} "
          f"(rtol/atol 5e-2); largest |logit| {float(full.abs().max()):.3f}; K5 f32 paths "
          f"{paths}", flush=True)
    # (d): the f32 kernel on layer 0's q/k/v of this prefill, bitwise and timed
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import _qkv
    del full, pl, step, cache
    with torch.inference_mode():
        lp = model.layers[0]
        positions = torch.arange(S, dtype=torch.int32, device=toks.device)
        q, k, v = (t.contiguous() for t in _qkv(lp["attn"], rms_norm(
            model.embed[toks[:, :S].long()], lp["ln1"]), cfg, positions))
    del model
    label, _, q_shape, kv_shape, kw, reps = simt_shapes()[3]
    require(tuple(q.shape) == q_shape and tuple(k.shape) == kv_shape == tuple(v.shape),
            f"K5 {label}: q {tuple(q.shape)}, k {tuple(k.shape)}; table {q_shape}, {kv_shape}")
    simt = simt_case(label, (q, k, v, kw), kern["K5"], ref, torch, reps=reps, tag="7")
    return launches, paths, {label: simt}


def lm_phase(kern, ref, torch, arch_name=LM_ARCH, serve=LM_SERVE, check=LM_CHECK,
             device="cuda", seed=0):
    """Phase 7: the LM serving path on the card at full width."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMDataConfig, LMTokenStream
    from repro_torch.models.common import count_params, init_params
    from repro_torch.models.transformer import LM, lm_decode, lm_param_defs, lm_prefill
    t_phase = time.perf_counter()
    arch = get_arch(arch_name)
    cfg = arch.full_config()
    defs = lm_param_defs(cfg)
    t0 = time.perf_counter()
    model = LM(init_params(defs, torch.Generator(device).manual_seed(seed), device), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    require(n_params == count_params(defs) == cfg.param_count(), "parameter count")
    print(f"[7] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} kv heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, {cfg.dtype}: {n_params} parameters, {n_bytes} B, made from seed "
          f"{seed} in {time.perf_counter() - t0:.1f} s", flush=True)
    B, S, steps = serve["batch"], serve["prompt"], serve["steps"]
    prompts = torch.as_tensor(LMTokenStream(LMDataConfig(
        vocab=cfg.vocab, batch=B, seq=S, seed=seed)).batch(0)["tokens"]).to(device)
    # warm the libraries up for both shapes: a short prefill and one decode step
    logits, cache = lm_prefill(model, prompts[:, :128], cfg, max_len=128 + steps, device=device)
    lm_decode(model, cache, logits.argmax(-1, keepdim=True), 128, cfg, device=device)
    del logits, cache
    torch.cuda.synchronize()
    serve_r, launches, cache = lm_serve(model, cfg, prompts, steps, kern, torch, device)
    checks = k5_checks(model, cfg, prompts, cache, kern["K5"], ref, torch)
    del model, cache
    torch.cuda.empty_cache()
    launches["lm:f32-check"], paths, simt = lm_check(arch, kern, ref, torch, device,
                                                      seed=seed + 1, check=check)
    serve_r["simt"] = {"shapes": simt, "paths": {"lm:f32-check": paths}}
    torch.cuda.empty_cache()
    print(f"[7] phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return serve_r, checks, launches


def k5_line(serve, k5, launches) -> dict:
    """K5's entry in the kernels line: launches on the serving route
    (prefill + decode steps), times at the prefill shape (the tensor-core
    kernel), the decode shape's (split-KV) beside them."""
    pre, dec = k5["prefill"], k5["decode"]
    keys = ("ms", "graph_ms", "lse_ms", "lse_graph_ms", "plain_ms", "library_ms",
            "library_graph_ms", "shape")
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
        "replaces": "src/repro/kernels/flash_attention.py:128",
        "launches": launches["lm:prefill"]["K5"] + launches["lm:decode"]["K5"],
        "launches_on": "lm:prefill + lm:decode",
        "launches_by_route": {route: c["K5"] for route, c in launches.items()},
        "launches_by_variant": serve["variants"],
        "max_abs_err": max(r["err"] for r in k5.values()),
        "tolerance": {name: r.get("tol", 0.0) for name, r in k5.items()},
        "ms": pre["ms"], "graph_ms": pre["graph_ms"], "lse_ms": pre["lse_ms"],
        "lse_graph_ms": pre["lse_graph_ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound"][0], "bound_by": pre["bound"][1],
        "library_ms": pre["library_ms"], "library_graph_ms": pre["library_graph_ms"],
        "shape": pre["shape"],
        "decode": {**{key: dec[key] for key in keys}, "bound_ms": dec["bound"][0],
                   "bound_by": dec["bound"][1]},
        "serve": {key: serve[key] for key in ("prefill_ms", "p50", "p99", "tok_s", "peak")},
    }


# -- phase 8: recsys serving on K6 --------------------------------------------------

RECSYS_ARCHS = ("fm", "dcn-v2", "bst", "bert4rec")
RECSYS_SHAPES = dict(serve_p99=512, serve_bulk=262_144, cands=1_000_000, k=100)
# serve_bulk here for fm, dcn-v2 and bst (bst gives K5 262,144 × 8 =
# 2,097,152 (batch · kv head) blocks on its flat grid); bert4rec's (128
# chunks of 2,048 sequences, each 2 K5 launches and a top-100 over 2²⁰
# items on K2, ~5.5 s a call) runs at the same 262,144 rows as phase 15's
# cell, unsharded and sharded, so phase 8 does not run it a second time
BULK_ARCHS = ("fm", "dcn-v2", "bst")
RECSYS_REPS = dict(serve_p99=30, serve_bulk=3, retrieval=5)
ORACLE_ROWS = 64
ORACLE_RTOL = 1e-5             # of the logit's summed magnitudes (FM's pair term cancels)
RETRIEVAL_TOL = 1e-6           # of Σ_d |u_d·c_d|: two f32 orders of one dot
# K6's timed shapes: (name, architecture, table) at serve_bulk
K6_SHAPES = (("fm linear", "fm", "linear"), ("fm tower", "fm", "emb"),
             ("dcn tower", "dcn-v2", "emb"))


def recsys_batch(cfg, batch: int, seed: int = 0, step: int = 0) -> dict:
    """A serving batch from the repo's synthetic streams, shaped as the
    reference's recsys cells: fm {sparse}, dcn {dense, sparse}, bst {seq,
    target}, bert4rec {seq}."""
    from repro_torch.data.recsys_data import CTRStream, SequenceStream
    if cfg.kind == "bert4rec":
        return {"seq": SequenceStream(n_items=cfg.n_items, seq_len=cfg.seq_len, batch=batch,
                                      seed=seed).batch_at(step)["seq"]}
    out = CTRStream(n_sparse=cfg.n_sparse, rows_per_field=cfg.rows_per_field, batch=batch,
                    n_dense=cfg.n_dense, seq_len=cfg.seq_len if cfg.kind == "bst" else 0,
                    n_items=cfg.n_items, seed=seed).batch_at(step)
    keys = {"fm": ("sparse",), "dcn": ("dense", "sparse"), "bst": ("seq", "target")}[cfg.kind]
    return {k: out[k] for k in keys}


def merge_rounds(survivors: int, k: int) -> int:
    """K2 launches of ``topk.merge`` over ``survivors`` per row: a round
    until exactly k are left."""
    from repro_torch.kernels.topk import DEFAULT_CHUNK
    chunk, n = max(DEFAULT_CHUNK, 2 * k), 0
    while survivors != k:
        survivors, n = -(-survivors // chunk) * k, n + 1
    return n


def topk_launches(n: int, k: int) -> int:
    """K2 launches of one ``topk`` over rows of ``n`` scores."""
    from repro_torch.kernels.topk import DEFAULT_CHUNK
    return 1 + merge_rounds(-(-n // max(DEFAULT_CHUNK, k)) * k, k)


def timed_route(kern, route, fn, reps, expected, torch) -> list:
    """``reps`` calls of ``fn`` after one warm-up, host clock around each
    call ending in ``synchronize``; the launch counters set to 0 after the
    warm-up and checked against ``expected`` (per call) after the reps."""
    fn()
    torch.cuda.synchronize()
    reset(kern)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, counted(kern, route, {n: c * reps for n, c in expected.items()})


def k6_case(k6, ref, table, ids, torch) -> float:
    """K6 against its twin, bitwise, on all-ones weights; the max abs err."""
    w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    got, want = k6(table, ids, w), ref.embedding_bag_ref(table, ids, w)
    torch.cuda.synchronize()
    require(bits_equal(got, want), f"K6 != twin on a {tuple(table.shape)} {table.dtype} table "
                                   f"at ids {tuple(ids.shape)}")
    return max_abs_err(got, want)


def k6_timing(k6, ref, table, ids, torch) -> dict:
    """K6 at one main-path shape: CUDA-event times of the kernel, its twin and
    ``torch.nn.functional.embedding_bag`` (mode "sum", pads as id 0 with
    weight 0), and the bound: idx, w, the distinct rows gathered and the
    output, each moved once, over the HBM rate."""
    import torch.nn.functional as F
    w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    err = k6_case(k6, ref, table, ids, torch)
    safe = torch.clamp(ids, min=0).long()
    w_masked = torch.where(ids >= 0, w, 0.0)
    lib = lambda: F.embedding_bag(safe, table, per_sample_weights=w_masked, mode="sum")  # noqa: E731
    B, L = ids.shape
    D = table.shape[1]
    rows = int(torch.unique(ids[ids >= 0]).numel())
    row_bytes = D * table.element_size()
    sector_bytes = -(-row_bytes // 32) * 32                 # HBM moves 32-byte sectors
    r = dict(err=err, ms=cuda_ms(lambda: k6(table, ids, w)),
             plain_ms=cuda_ms(lambda: ref.embedding_bag_ref(table, ids, w), reps=3, warmup=1),
             library_ms=cuda_ms(lib), library_err=max_abs_err(lib(), k6(table, ids, w)),
             bound=bound_ms(B * L * 8 + rows * row_bytes + B * D * 4, 2 * B * L * D),
             gathers_bound_ms=(B * L * (8 + row_bytes) + B * D * 4) / HBM_BYTES_PER_S * 1e3,
             sector_bound_ms=(B * L * 8 + rows * sector_bytes + B * D * 4) / HBM_BYTES_PER_S
             * 1e3,
             rows=rows, shape=f"B={B}, L={L}, D={D}, table {tuple(table.shape)} {table.dtype}")
    return r


def fm_oracle(params, batch, cfg, logits, torch) -> float:
    """FM logits of the first rows against a float64 evaluation of the same
    rows gathered to the host; |Δ| ≤ ORACLE_RTOL × (|bias| + Σ|lin| +
    ½Σ_d[(Σ_f|v|)² + Σ_f v²]). Returns the largest |Δ| / scale."""
    from repro_torch.models.recsys import _flat_ids
    ids = _flat_ids(cfg, torch.as_tensor(batch["sparse"][:ORACLE_ROWS]).to(
        logits.device)).long()
    v = params["emb"][ids].double().cpu().numpy()
    lin = params["linear"][ids][..., 0].double().cpu().numpy()
    bias = float(params["bias"][0])
    s = v.sum(1)
    want = bias + lin.sum(1) + 0.5 * (s * s - (v * v).sum(1)).sum(-1)
    a = np.abs(v).sum(1)
    scale = abs(bias) + np.abs(lin).sum(1) + 0.5 * (a * a + (v * v).sum(1)).sum(-1)
    return float((np.abs(logits[:ORACLE_ROWS].double().cpu().numpy() - want) / scale).max())


def dcn_oracle(params, batch, cfg, logits, torch) -> float:
    """DCN-v2 logits of the first rows against a float64 evaluation on the
    host; the scale is the same network run on magnitudes (|x0|, |W|, |b|).
    Returns the largest |Δ| / scale."""
    from repro_torch.models.recsys import _flat_ids
    host = lambda t: t.double().cpu().numpy()                       # noqa: E731
    ids = _flat_ids(cfg, torch.as_tensor(batch["sparse"][:ORACLE_ROWS]).to(
        logits.device)).long()
    v = host(params["emb"][ids])
    x0 = np.concatenate([batch["dense"][:ORACLE_ROWS].astype(np.float64),
                         v.reshape(v.shape[0], -1)], -1)
    x, m = x0, np.abs(x0)
    for i in range(cfg.n_cross_layers):
        W, b = host(params[f"cross_w{i}"]), host(params[f"cross_b{i}"])
        x = x0 * (x @ W + b) + x
        m = np.abs(x0) * (m @ np.abs(W) + np.abs(b)) + m
    n = len([k for k in params["mlp"] if k.startswith("w")])
    for i in range(n):
        W, b = host(params["mlp"][f"w{i}"]), host(params["mlp"][f"b{i}"])
        x = x @ W + b
        x = np.maximum(x, 0) if i < n - 1 else x
        m = m @ np.abs(W) + np.abs(b)
    W, b = host(params["head"]), host(params["head_b"])
    want = (x @ W + b)[:, 0]
    scale = (m @ np.abs(W) + np.abs(b))[:, 0]
    return float((np.abs(logits[:ORACLE_ROWS].double().cpu().numpy() - want) / scale).max())


def retrieval_agree(u, cand, kern_route, plain_route) -> int:
    """The K4 route against the plain route: at each rank the ids are equal,
    or the two rows' exact scores tie within RETRIEVAL_TOL·Σ_d|u_d·c_d|; each
    route's scores are within the f32 error bound of a D-term dot (γ_D ·
    Σ|u·c|) of the exact score of its id. Returns how many ranks differ."""
    (kv, ki), (pv, pi) = kern_route, plain_route
    u = u.double()
    D = u.shape[0]
    gamma = D * 2.0 ** -24 / (1 - D * 2.0 ** -24)
    def exact(ids):
        c = cand[ids.long()].double()
        return (c @ u).cpu().numpy(), (c * u).abs().sum(-1).cpu().numpy()
    (ke, ks), (pe, ps) = exact(ki), exact(pi)
    for vals, e, sc, name in ((kv, ke, ks, "K4"), (pv, pe, ps, "plain")):
        err = np.abs(vals.double().cpu().numpy() - e)
        require(bool((err <= gamma * sc).all()), f"retrieval {name} route: a score off its "
                                                 f"exact value by {float((err / sc).max())} Σ|u·c|")
    ki, pi = ki.cpu().numpy(), pi.cpu().numpy()
    differ = np.flatnonzero(ki != pi)
    for r in differ:
        require(abs(ke[r] - pe[r]) <= RETRIEVAL_TOL * max(ks[r], ps[r]),
                f"retrieval rank {r}: K4 route id {ki[r]} != plain route id {pi[r]}, exact "
                f"scores {ke[r]} and {pe[r]}")
    return int(differ.size)


def simt_shapes() -> tuple:
    """The shapes K5's f32 kernel is checked and timed at, one table for
    phases 7 and 8 and ``--simt-only``: (label, architecture, q shape, k/v
    shape, kwargs, reps). (a)-(c) the encoders' layer 0 as phase 8 serves
    them (bst attends [history; target]; bert4rec's bulk call is chunks of
    ``BERT4REC_CHUNK`` sequences, two launches at (c) each), (d) the LM's
    f32 prefill as phase 7's check runs it."""
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys import BERT4REC_CHUNK

    def encoder(name, rows):
        cfg = get_arch(name).full_config()
        shape = (rows, cfg.n_heads, cfg.seq_len + (cfg.kind == "bst"),
                 cfg.embed_dim // cfg.n_heads)
        return name, shape, shape, {}

    lm = get_arch(LM_ARCH).full_config()
    B, S = LM_CHECK["batch"], LM_CHECK["prompt"]
    return (("(a) bst serve_bulk", *encoder("bst", RECSYS_SHAPES["serve_bulk"]), 10),
            ("(b) bst serve_p99", *encoder("bst", RECSYS_SHAPES["serve_p99"]), 50),
            ("(c) bert4rec chunk", *encoder("bert4rec", BERT4REC_CHUNK), 20),
            ("(d) h2o-danube f32 prefill", LM_ARCH, (B, lm.n_heads, S, lm.dh),
             (B, lm.n_kv_heads, S, lm.dh), dict(causal=True, window=lm.window), 3))


def served_seq(cfg, batch, device, torch):
    """The token ids the encoder attends: bst's [history; target] (as
    ``models/recsys.py::_bst`` builds it), bert4rec's sequence."""
    seq = torch.as_tensor(batch["seq"]).to(device)
    if cfg.kind == "bst":
        seq = torch.cat([seq, torch.as_tensor(batch["target"]).to(device)[:, None]], dim=1)
    return seq


def encoder_qkv(params, cfg, seq, torch):
    """The encoder's layer-0 q, k, v (B, H, S, d / H) over ``seq`` as
    ``models/recsys.py::_tx_block`` hands them to K5: transposed views."""
    from repro_torch.models.common import dense
    from repro_torch.models.embedding import embedding_lookup
    with torch.inference_mode():
        x = embedding_lookup(params["item_emb"], seq) + params["pos_emb"][None, :seq.shape[1]]
        p = params["b0"]
        B, S, d = x.shape
        H = cfg.n_heads
        return tuple(dense(x, p[w]).reshape(B, S, H, d // H).transpose(1, 2)
                     for w in ("wq", "wk", "wv"))


def simt_case(name, case, k5, ref, torch, reps, tag="8") -> dict:
    """K5's f32 kernel on one case (q, k, v, kwargs): :func:`k5_check`
    (bitwise == the twin, outputs and lse; the dense oracle; the twin's
    time, once), each of its two calls one launch of the path
    :func:`simt_path` names, then :func:`k5_timing` (the kernel, with lse,
    SDPA in turns, CUDA graphs) and the bound."""
    from repro_torch.kernels.flash_attention import simt_path
    a, b, c, kw = case
    path = simt_path(a.shape[1] // b.shape[1] * a.shape[2], b.shape[2], a.shape[3], c.shape[3])
    before = dict(k5.launches_by_path)
    r = k5_check(name, k5, ref, torch, a, b, c, kw, tag=tag)
    ran = {key: k5.launches_by_path[key] - n for key, n in before.items()}
    require(ran == {key: 2 * (key == path) for key in ran},
            f"K5 ({name}): f32 paths {ran}, expected 2 on {path}")
    k5_timing(name, r, case, k5, ref, torch, reps=reps, tag=tag)
    r["path"] = path
    return r


def simt_entry(r) -> dict:
    """One shape of the f32 kernel's entry in the kernels line."""
    return {**case_entry(r), **{key: r[key] for key in ("lse_ms", "library_graph_ms", "path",
                                                         "copy_ms") if key in r}}


def recsys_arch(name, kern, ref, torch, device, seed):
    """Phase 8 for one architecture: build its tables on the card, serve,
    retrieve, check; release nothing (the caller does)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as tr
    from repro_torch.kernels.dot_topk import survivors
    from repro_torch.kernels.flash_attention import simt_path
    from repro_torch.models.common import init_params, tree_leaves
    cfg = get_arch(name).full_config()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(tr.recsys_param_defs(cfg), torch.Generator(device).manual_seed(seed),
                         device)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    require(n_params == cfg.param_count(), f"{name}: parameter count")
    print(f"[8] {name}: {n_params} parameters ({sum(t.numel() * 4 for t in leaves)} B of f32) "
          f"made from seed {seed} in {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    k = RECSYS_SHAPES["k"]
    launches, errs = {}, []
    b4r = cfg.kind == "bert4rec"
    tower = {"K6": 1} if cfg.kind in ("fm", "dcn") else {"K5": cfg.n_blocks}
    per_forward = {"fm": {"K6": 1}, "dcn": {}, "bst": {"K5": cfg.n_blocks},
                   "bert4rec": {"K5": cfg.n_blocks,
                                "K2": topk_launches(cfg.n_items + 2, k)}}[cfg.kind]

    def serve(batch):
        if b4r:
            return tr.bert4rec_serve_topk(params, batch["seq"], cfg, k=k, device=device)
        return tr.recsys_forward(params, batch, cfg, device=device)

    # serve_p99, then serve_bulk: the main path, counters checked per route
    t0 = time.perf_counter()
    p99 = recsys_batch(cfg, RECSYS_SHAPES["serve_p99"], seed=seed)
    sizes = {"serve_p99": (p99, RECSYS_REPS["serve_p99"])}
    if name in BULK_ARCHS:
        sizes["serve_bulk"] = (recsys_batch(cfg, RECSYS_SHAPES["serve_bulk"], seed=seed),
                               RECSYS_REPS["serve_bulk"])
    print(f"[8] {name}: batches from the synthetic streams in {time.perf_counter() - t0:.1f} s",
          flush=True)
    answers = {}
    for shape, (batch, reps) in sizes.items():
        route = f"recsys:{name}:{shape}"
        B = len(next(iter(batch.values())))
        chunks = -(-B // tr.BERT4REC_CHUNK) if b4r else 1
        ms, launches[route] = timed_route(kern, route, lambda: answers.__setitem__(
            shape, serve(batch)), reps, {n: c * chunks for n, c in per_forward.items()}, torch)
        if "K5" in per_forward:           # the encoder attends S tokens, S rows, dh wide
            S, dh = cfg.seq_len + (cfg.kind == "bst"), cfg.embed_dim // cfg.n_heads
            out.setdefault("simt_paths", {})[route] = simt_paths(
                kern, route, {simt_path(S, S, dh, dh): launches[route]["K5"]})
        got = answers[shape]
        if b4r:
            vals, ids = got
            require(vals.shape == (B, k) and bool(torch.isfinite(vals).all())
                    and bool(((ids >= 0) & (ids < cfg.n_items + 2)).all()),
                    f"{route}: top-k malformed")
        else:
            require(got.shape == (B,) and bool(torch.isfinite(got).all()), f"{route}: logits")
        t = np.array(ms)
        out[shape] = dict(p50=float(np.percentile(t, 50)), p99=float(np.percentile(t, 99)),
                          rows_s=B / (np.percentile(t, 50) / 1e3), reps=reps)
        print(f"[8] {route}: {reps} calls of {B} rows, wall p50 {out[shape]['p50']:.3f} ms "
              f"p99 {out[shape]['p99']:.3f} ms ({out[shape]['rows_s']:.0f} rows/s at p50); "
              f"launches {launches[route]}", flush=True)

    for shape, (batch, reps) in sizes.items():       # 8 lines: the strided copies show
        profile_window("8", f"{name} {shape}", lambda _: serve(batch),
                       range(6 if shape == "serve_p99" else min(3, reps + 1)), kern, top=8)

    # K6 against its twin on this architecture's real tables and ids
    from repro_torch.models.recsys import _flat_ids
    if cfg.kind in ("fm", "dcn"):
        for shape, (batch, _) in sizes.items():
            ids = _flat_ids(cfg, torch.as_tensor(batch["sparse"]).to(device))
            tables = ("linear", "emb") if cfg.kind == "fm" else ("emb",)
            errs += [k6_case(kern["K6"], ref, params[t], ids, torch) for t in tables]
            if shape == "serve_p99" and cfg.kind == "fm":
                errs.append(k6_case(kern["K6"], ref, params["emb"].to(torch.bfloat16), ids,
                                    torch))
        out["k6"] = {label: k6_timing(kern["K6"], ref, params[table], _flat_ids(
            cfg, torch.as_tensor(sizes["serve_bulk"][0]["sparse"]).to(device)), torch)
            for label, arch, table in K6_SHAPES if arch == name}
        oracle = (fm_oracle if cfg.kind == "fm" else dcn_oracle)(params, p99, cfg,
                                                                answers["serve_p99"], torch)
        require(oracle <= ORACLE_RTOL, f"{name}: logits off the float64 evaluation by "
                                       f"{oracle} of their magnitude")
        out["oracle"] = oracle
        print(f"[8] {name}: K6 == twin bitwise on the real tables and batch ids"
              f"{' (and a bf16 copy of emb)' if cfg.kind == 'fm' else ''}; logits of "
              f"{ORACLE_ROWS} rows within {oracle:.3e} of their summed magnitudes of a float64 "
              f"evaluation (limit {ORACLE_RTOL})", flush=True)
    else:
        seq = torch.as_tensor(p99["seq"]).to(device)
        errs.append(k6_case(kern["K6"], ref, params["item_emb"], seq.to(torch.int32), torch))
        print(f"[8] {name}: K6 == twin bitwise on the item table pooled over the histories "
              f"{tuple(seq.shape)}", flush=True)
        # K5's f32 kernel on layer 0's q/k/v of the served sequences, at each shape
        out["simt"] = {}
        for label, arch, q_shape, _, kw, reps in simt_shapes():
            if arch == name:
                B = q_shape[0]
                batch = sizes["serve_bulk"][0] if B == RECSYS_SHAPES["serve_bulk"] else (
                    p99 if B == RECSYS_SHAPES["serve_p99"] else recsys_batch(cfg, B, seed=seed))
                views = encoder_qkv(params, cfg, served_seq(cfg, batch, device, torch), torch)
                require(all(tuple(t.shape) == q_shape for t in views),
                        f"K5 {label}: {name}'s q/k/v {tuple(views[0].shape)}, table {q_shape}")
                # the three copies K5's wrapper makes of the transposed views (.contiguous())
                copy_ms = cuda_ms(lambda: [t.contiguous() for t in views], reps=reps)
                case = (*(t.contiguous() for t in views), kw)
                out["simt"][label] = r = simt_case(f"{label}, {name} layer 0", case,
                                                   kern["K5"], ref, torch, reps)
                r["copy_ms"] = copy_ms
                print(f"[8] K5 {label}: the wrapper's .contiguous() of the transposed q, k, v "
                      f"{copy_ms:.4f} ms a call, beside the kernel's {r['ms']:.4f} ms",
                      flush=True)
                del views, case
        out["k5_err"] = max(r["err"] for r in out["simt"].values())
    if b4r:
        with torch.inference_mode():
            seq = torch.as_tensor(p99["seq"]).to(device)
            x = tr._bert4rec_hidden(params, seq, cfg)[:, -1]
            logits = x @ params["item_emb"].T + params["out_b"]
            want = ref.topk_ref(logits, k)
        got = answers["serve_p99"]
        require(bits_equal(got[0], want[0]) and bits_equal(got[1], want[1]),
                "bert4rec serving top-k != matmul + ref.topk_ref")
        print(f"[8] bert4rec: serving top-{k} == matmul + ref.topk_ref on the card (ids, bits)",
              flush=True)
        # K2 at the vocabulary top-k: the serving route's largest kernel
        out["k2_vocab"] = k2_case(kern["K2"], ref, torch, logits, k, "bert4rec vocabulary",
                                  reps=5)
        print_case("8", "K2, bert4rec's vocabulary top-k,", out["k2_vocab"])
        del logits, want

    # retrieval_cand on both routes
    D = cfg.embed_dim
    cand = torch.randn(RECSYS_SHAPES["cands"], D, device=device,
                       generator=torch.Generator(device).manual_seed(seed + 1))
    user = {key: v[:1] for key, v in p99.items()}
    routes = {}
    for use_kernel in (True, False):
        tag = "K4" if use_kernel else "plain"
        route = f"recsys:{name}:retrieval:{tag}"
        expected = dict(tower)
        if use_kernel:
            expected["K4"] = 1
            expected["K2"] = merge_rounds(survivors(RECSYS_SHAPES["cands"], k), k)
        else:
            expected["K2"] = topk_launches(RECSYS_SHAPES["cands"], k)
        ms, launches[route] = timed_route(kern, route, lambda: routes.__setitem__(
            tag, tr.retrieval_topk(params, user, cfg, cand, k, use_kernel=use_kernel,
                                   device=device)), RECSYS_REPS["retrieval"], expected, torch)
        out[f"retrieval_{tag}"] = dict(p50=float(np.percentile(ms, 50)), min=float(min(ms)))
    u = tr.user_vector(params, user, cfg, device=device)[0]
    differ = retrieval_agree(u, cand, routes["K4"], routes["plain"])
    out["peak"] = torch.cuda.max_memory_allocated() - base
    print(f"[8] {name}: retrieval 1 x {RECSYS_SHAPES['cands']} candidates, k={k}: K4 route wall "
          f"p50 {out['retrieval_K4']['p50']:.3f} ms, plain route (matmul + K2) p50 "
          f"{out['retrieval_plain']['p50']:.3f} ms; routes agree ({differ} ranks differ by a "
          f"tie within {RETRIEVAL_TOL} Σ|u·c|); launches "
          f"{launches[f'recsys:{name}:retrieval:K4']} (K4), "
          f"{launches[f'recsys:{name}:retrieval:plain']} (plain); max_memory_allocated "
          f"{out['peak']} B above the {base} B held before {name}", flush=True)
    del params, cand
    return out, launches, errs


def recsys_phase(kern, ref, torch, device="cuda", seed=0):
    """Phase 8: the four recsys architectures at full width on the card."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, launches, errs = {}, {}, []
    for name in RECSYS_ARCHS:
        r, l, e = recsys_arch(name, kern, ref, torch, device, seed)
        results[name] = r
        launches.update(l)
        errs += e
        gc.collect()
        torch.cuda.empty_cache()
    for label, arch, _ in K6_SHAPES:
        t = results[arch]["k6"][label]
        print(f"[8] K6 {label} ({t['shape']}, {t['rows']} distinct rows): kernel {t['ms']:.4f} "
              f"ms, twin {t['plain_ms']:.3f} ms, F.embedding_bag {t['library_ms']:.4f} ms (within "
              f"{t['library_err']:.3e} of K6), bound {t['bound'][0]:.4f} ms ({t['bound'][1]}; "
              f"{t['sector_bound_ms']:.4f} ms with each distinct row a whole number of 32-byte "
              f"sectors, {t['gathers_bound_ms']:.4f} ms if every gather moved its row)",
              flush=True)
    print(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results, launches, max(errs)


def simt_line(serve, results, launches) -> dict:
    """K5's f32 kernel's entry in the kernels line: launches on bst's bulk
    route (the short path), by route and by path on phases 7 and 8, times
    at (a), bst's bulk attention, with (b)–(d) beside them (``serve`` is
    phase 7's result, or None where phase 7 did not run)."""
    shapes = {label: results[arch]["simt"][label] for label, arch, *_ in simt_shapes()
              if arch in results}
    paths = dict(serve["simt"]["paths"]) if serve else {}
    if serve:
        shapes.update(serve["simt"]["shapes"])
    for arch in ("bst", "bert4rec"):
        paths.update(results[arch]["simt_paths"])
    head = shapes["(a) bst serve_bulk"]
    route = "recsys:bst:serve_bulk"
    return {
        "name": "flash_attention (f32)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:128",
        "launches": launches[route]["K5"], "launches_on": route,
        "launches_by_route": {r: sum(p.values()) for r, p in paths.items()},
        "launches_by_path": paths,
        "max_abs_err": max(r["err"] for r in shapes.values()),
        **{key: val for key, val in simt_entry(head).items() if key != "max_abs_err"},
        "shapes": {label: simt_entry(r) for label, r in shapes.items()},
    }


def k6_line(results, launches, err) -> dict:
    """K6's entry in the kernels line: launches summed over phase 8's routes,
    times at fm's tower shape, the other two shapes beside them."""
    shapes = {label: results[arch]["k6"][label] for label, arch, _ in K6_SHAPES}
    keys = ("ms", "plain_ms", "library_ms", "shape", "rows", "sector_bound_ms",
            "gathers_bound_ms")
    head = shapes["fm tower"]
    by_route = {route: c["K6"] for route, c in launches.items()}
    return {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:63",
        "launches": sum(by_route.values()), "launches_on": "recsys:* (phase 8)",
        "launches_by_route": by_route, "max_abs_err": err,
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound"][0],
        "bound_by": head["bound"][1], "library_ms": head["library_ms"], "shape": head["shape"],
        "shapes": {label: {**{key: r[key] for key in keys}, "bound_ms": r["bound"][0],
                           "bound_by": r["bound"][1]} for label, r in shapes.items()},
        "serve": {name: {key: r[key] for key in ("serve_p99", "serve_bulk", "retrieval_K4",
                                                 "retrieval_plain", "peak")
                         if key in r}
                  for name, r in results.items()},
    }


# -- --simt-only: K5's f32 kernel alone at the main path's shapes ----------------

def simt_phase(kern, ref, torch, device="cuda", seed=0) -> dict:
    """K5's f32 kernel at the :func:`simt_shapes` on seeded inputs:
    :func:`simt_case` (bitwise == the twin, the path, the times beside
    SDPA, the twin and the bound)."""
    g = torch.Generator(device).manual_seed(seed)
    out = {}
    for label, _, q_shape, kv_shape, kw, reps in simt_shapes():
        q = torch.randn(q_shape, generator=g, device=device)
        k = torch.randn(kv_shape, generator=g, device=device)
        v = torch.randn(kv_shape, generator=g, device=device)
        out[label] = simt_case(label, (q, k, v, kw), kern["K5"], ref, torch, reps, tag="s")
        del q, k, v
        torch.cuda.empty_cache()
    return out


# -- phase 9: the structured tier and the write path against oracles ---------------

# synth_fielded_corpus at B16's vocabulary rule (n_docs // 2), cut from
# 100,000 to fit the smoke's time limit: the v2 packs of the fleet and of
# the two generations' oracles are host numpy, ~0.5 ms a doc each
STRUCT_DOCS = 25_000
STRUCT_INCOMING = STRUCT_DOCS // 10    # the corpus's last docs arrive by commit
STRUCT_DELETES = STRUCT_DOCS // 20
STRUCT_K = 100                 # B16's fleet ceiling; requests take k 10
STRUCT_WINDOW = dict(max_window_s=0.08, target_batch=8, sparse_qps=2.0, p99_budget_s=2.0)
STRUCT_GAP_S = 0.01            # B16's arrival spacing (jittered ±10 %)
STRUCT_BAG_ORACLE = 16         # untruncated bag-of-words queries held to OracleSearcher
STRUCT_ROUTES = {"structured": ("K2",), "bag-of-words": ("K1",)}


def struct_offsets(n: int, seed: int = 16) -> "np.ndarray":
    """B16's burst schedule: arrival offsets ~``STRUCT_GAP_S`` apart."""
    rng = np.random.default_rng(seed)
    return np.cumsum(STRUCT_GAP_S * rng.uniform(0.9, 1.1, size=n))


def structured_traffic(app, sqs, bag, kern, gen):
    """Per kind (structured with a facet request, bag-of-words), every
    instance killed first: one cold query, 20 warm queries and the 64
    queries through ``submit``/``flush`` on B16's arrival schedule, the
    launch counters set to 0 before the kind and read after it. Returns
    {kind: (serial bodies, windowed bodies, walls ms of queries 2-21,
    launches)}."""
    out = {}
    for kind, expected in STRUCT_ROUTES.items():
        qs = sqs if kind == "structured" else bag
        kw = (lambda q: dict(sq=q, facets=["cat"])) if kind == "structured" else \
            (lambda q: dict(q=q))
        kill_all(app)
        reset(kern)
        serial, walls = [], []
        for q in qs[:21]:
            t0 = time.perf_counter()
            r = app.query(**kw(q), k=K, fetch_docs=False, t_arrival=app.runtime.clock + 0.05)
            walls.append((time.perf_counter() - t0) * 1e3)
            require(r.status == 200 and r.body["generation"] == gen,
                    f"{kind}: {r.status} {r.body}")
            serial.append(r.body)
        t_sub = app.runtime.clock + 1.0
        batches0 = app.gateway.window_stats("GET", "/search")["batches"]
        t0 = time.perf_counter()
        handles = [app.submit(**kw(q), k=K, fetch_docs=False, t_arrival=t_sub + float(off))
                   for q, off in zip(qs, struct_offsets(len(qs)))]
        app.flush()
        window_wall = (time.perf_counter() - t0) * 1e3
        windowed = [h.response for h in handles]
        require(all(w.status == 200 for w in windowed), f"{kind}: windowed status")
        launches = {name: fn.launches for name, fn in kern.items()}
        for name, n in launches.items():
            require((n > 0) == (name in expected),
                    f"{kind} (generation {gen}): kernel {name} launched {n} times, expected "
                    f"{'some' if name in expected else 'none'}")
        for i, (a, w) in enumerate(zip(serial, windowed)):
            require(a["ext_ids"] == w.body["ext_ids"] and _bits(a["scores"]) == _bits(w.body["scores"])
                    and a.get("facets") == w.body.get("facets"),
                    f"{kind} query {i}: windowed != serial")
        batches = app.gateway.window_stats("GET", "/search")["batches"] - batches0
        # the second query is warm but pays the rebuild of each lazy leg's
        # searcher after the cold query's backfill; queries 3-21 are steady
        print(f"[9] generation {gen}, {kind}: launches {launches}; cold wall {walls[0]:.1f} ms, "
              f"second query {walls[1]:.1f} ms; steady wall (queries 3-21) p50 "
              f"{np.percentile(walls[2:], 50):.3f} ms p99 {np.percentile(walls[2:], 99):.3f} ms; "
              f"{len(qs)} queries in {batches} window dispatches, {window_wall:.1f} ms of wall; "
              f"windowed == serial (bits, facets) on the first 21", flush=True)
        out[kind] = ([b for b in serial], [w.body for w in windowed], walls[1:], launches)
    return out


def structured_checks(app, sqs, bag, traffic, oracle, gen, max_postings):
    """A generation's answers against the oracles over its live corpus:
    structured top-k (ext ids, score bits, order) and merged facets ==
    ``StructuredOracleSearcher``; one phrase query's full result set ==
    ``exact_match_set``, its facets == ``exact_facet_counts``, its snippets
    cover every matched term; bag-of-words ext ids == ``OracleSearcher`` on
    the queries whose terms no partition truncates."""
    from repro_torch.index.tokenizer import flatten_text, tokenize
    from repro_torch.search.oracle import OracleSearcher
    live = app.indexer.live_corpus()
    t0 = time.perf_counter()
    for i, (sq, body) in enumerate(zip(sqs, traffic["structured"][1])):
        want = [(live[d][0], v) for d, v in oracle.search(sq, K)]
        require(list(zip(body["ext_ids"], body["scores"])) == want,
                f"structured query {i} {sq!r}: != StructuredOracleSearcher")
        require(body["facets"]["cat"] == oracle.facet_counts(sq, "cat"),
                f"structured query {i} {sq!r}: facets != the oracle's packed count")
    t1 = time.perf_counter()
    phrase = next(sq for sq in sqs if sq.startswith('"') and 0 < len(oracle.match_set(sq)) <= STRUCT_K)
    r = app.query(sq=phrase, k=STRUCT_K, facets=["cat"], snippets=True,
                  t_arrival=app.runtime.clock + 0.05).body
    exact = {live[d][0] for d in oracle.exact_match_set(phrase)}
    require(set(r["ext_ids"]) == exact, f"phrase {phrase!r}: result set != exact_match_set")
    require(r["facets"]["cat"] == oracle.exact_facet_counts(phrase, "cat"),
            f"phrase {phrase!r}: facets != exact_facet_counts")
    terms = set(oracle._query(phrase).terms)
    for doc, snip in zip(r["docs"], r["snippets"]):
        for t in terms & set(tokenize(doc["contents"])):
            require("<em>" in snip and t in snip.lower(), f"snippet misses {t!r}: {snip!r}")
    t2 = time.perf_counter()
    bag_oracle = OracleSearcher(live)
    df = app.indexer.stats["df"]
    checked = 0
    for i, (q, body) in enumerate(zip(bag, traffic["bag-of-words"][1])):
        if not all(df.get(t, 0) <= max_postings for t in tokenize(q)):
            continue
        want = [bag_oracle.doc_ids[d] for d, _ in bag_oracle.search(q, K)]
        require(body["ext_ids"] == want, f"bag-of-words query {i} {q!r}: != OracleSearcher")
        checked += 1
    # the mix's head terms outgrow max_blocks; more untruncated queries,
    # drawn as phase 6 draws them
    for q in fleet_queries([(e, flatten_text(t)) for e, t in live], df, max_postings,
                           STRUCT_BAG_ORACLE):
        body = app.query(q, k=K, fetch_docs=False, t_arrival=app.runtime.clock + 0.05).body
        want = [bag_oracle.doc_ids[d] for d, _ in bag_oracle.search(q, K)]
        require(body["ext_ids"] == want, f"bag-of-words query {q!r}: != OracleSearcher")
        checked += 1
    print(f"[9] generation {gen} ({len(live)} live docs): {len(sqs)} structured queries == "
          f"StructuredOracleSearcher (ext ids, score bits, order; facets) in {t1 - t0:.1f} s; "
          f"phrase {phrase!r}: {len(exact)} docs == exact_match_set, facets == "
          f"exact_facet_counts, snippets cover every matched term, in {t2 - t1:.1f} s; "
          f"{checked} untruncated bag-of-words queries == OracleSearcher (ext ids) in "
          f"{time.perf_counter() - t2:.1f} s", flush=True)


def evaluator_card_vs_cpu(app, cfg, sqs, torch, device, gen):
    """Partition 0's live packed arrays of generation ``gen``: the
    evaluator on the card equals the same function on the CPU, bit for bit
    (scores, eligibility, facets)."""
    from repro_torch.core.refresh import generation_version
    from repro_torch.search.query import parse_query
    from repro_torch.search.searcher import hydrate_searcher
    from repro_torch.search.structured import (StructuredState, evaluate_structured,
                                               facet_counts)
    searcher, _ = hydrate_searcher(app.catalog, app.assets[0], cfg, generation_version(gen),
                                   device)
    card = searcher.structured
    cpu = StructuredState.from_packed(searcher.packed, device="cpu")
    favg = app._field_avgdl()
    for i, sq in enumerate(sqs):
        q = parse_query(sq)
        a, ea = evaluate_structured(card, q, field_avgdl=favg)
        b, eb = evaluate_structured(cpu, q, field_avgdl=favg)
        require(bits_equal(a, b) and bits_equal(ea, eb)
                and facet_counts(card, ea, "cat") == facet_counts(cpu, eb, "cat"),
                f"structured query {i} {sq!r}: the evaluator on the card != on the CPU")
    print(f"[9] generation {gen}, partition 0 ({card.n_docs} docs, {card.nbytes} B of v2 "
          f"sidecar on the card): evaluate_structured on the card == on the CPU, bit for bit "
          f"(scores, eligibility, facets), {len(sqs)} queries", flush=True)


def leaf_split(app, sqs, kern, calls: int = 5) -> dict:
    """Device µs a warm structured query spends in each of the evaluator's
    profiler ranges (``structured.<leaf kind>``, ``structured.topk``,
    ``structured.facets``), summed over its partition legs, and in K2's
    kernel, from a ``torch.profiler`` trace of ``calls`` warm queries."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(q):
        app.query(sq=q, k=K, facets=["cat"], fetch_docs=False,
                  t_arrival=app.runtime.clock + 0.05)

    run(sqs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for q in sqs[1:1 + calls]:
            run(q)
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.key.startswith("structured.") and e.device_type == DeviceType.CPU:
            split[e.key] = (e.device_time_total / calls, e.count)
        elif any(t in e.key for t in TRACE_NAMES["K2"]) and e.device_type == DeviceType.CUDA:
            split["K2 topk_select_kernel"] = (e.self_device_time_total / calls, e.count)
    print(f"[9] device time a warm structured query (us, summed over its legs; from "
          f"{calls} queries): " + ", ".join(f"{k} {v:.1f} (x{n})" for k, (v, n) in sorted(split.items())),
          flush=True)
    return split


def oracle_on_cpu(docs):
    """``StructuredOracleSearcher`` over ``docs``, packed on the CPU in a
    worker process (the v2 pack is host numpy), its device state dropped
    for the trip back."""
    from repro_torch.search.oracle import StructuredOracleSearcher
    oracle = StructuredOracleSearcher(docs, facet_fields=("cat",), device="cpu")
    oracle.state = None
    return oracle


def oracle_on(future, device, what: str):
    """The worker's oracle with its state on ``device``."""
    from repro_torch.search.structured import StructuredState
    t0 = time.perf_counter()
    oracle = future.result()
    oracle.state = StructuredState.from_packed(oracle.packed, device=device)
    print(f"[9] {what}: full-corpus structured oracle ({len(oracle.docs)} docs) on the card, "
          f"{time.perf_counter() - t0:.1f} s after it was needed", flush=True)
    return oracle


def window_check(handles, sqs, oracle, corpus, gen) -> None:
    """Every answer of ``handles`` came from generation ``gen`` and equals
    that generation's oracle (ext ids, score bits, order; facets)."""
    for h, sq in zip(handles, sqs):
        b = h.response.body
        require(h.response.status == 200 and b["generation"] == gen,
                f"{sq!r}: admitted under generation {gen}, answered {b.get('generation')}")
        want = [(corpus[d][0], v) for d, v in oracle.search(sq, K)]
        require(list(zip(b["ext_ids"], b["scores"])) == want
                and b["facets"]["cat"] == oracle.facet_counts(sq, "cat"),
                f"{sq!r}: the window's answer != generation {gen}'s oracle")


def structured_phase(kern, torch, device="cuda", n_docs=STRUCT_DOCS):
    """Phase 9: the structured tier and the write path on the card, held to
    the oracles before and after a commit that lands inside an open
    admission window. Each generation's oracle packs in a worker process
    while the fleet is built or serves."""
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return _structured_phase(kern, torch, device, n_docs, pool)


def _structured_phase(kern, torch, device, n_docs, pool):
    from repro_torch.core.gateway import WindowPolicy
    from repro_torch.core.partition import FleetSpec, GatewaySpec, IndexSpec, ReplicationSpec
    from repro_torch.core.runtime import RuntimeConfig
    from repro_torch.data.corpus import (synth_fielded_corpus, synth_queries,
                                         synth_structured_queries)
    from repro_torch.index.tokenizer import flatten_text
    from repro_torch.search.searcher import SearchConfig
    from repro_torch.search.service import build_partitioned_search_app
    t_phase = time.perf_counter()
    docs = synth_fielded_corpus(n_docs, vocab=n_docs // 2, seed=0)
    base, incoming = docs[:n_docs - STRUCT_INCOMING], docs[n_docs - STRUCT_INCOMING:]
    # generation 1's live corpus is ``base``: the fleet splits it into
    # contiguous partitions (checked below)
    pending = pool.submit(oracle_on_cpu, base)
    sqs = synth_structured_queries(base, N_QUERIES, seed=16)
    bag = synth_queries([(e, flatten_text(t)) for e, t in base], N_QUERIES, seed=17)
    t0 = time.perf_counter()
    # B16's clock under --det: modeled exec and writer seconds, so the
    # window sizes itself from modeled latencies as B16's does, and no
    # query's host wall (a cold leg's view rebuilds) closes it
    cfg = SearchConfig(accumulator="pruned", use_kernel=True, use_topk_kernel=True,
                       k=STRUCT_K, lazy_hydration=True, sim_exec_s=0.002, sim_write_s=0.02)
    app = build_partitioned_search_app(base, FleetSpec(
        n_parts=FLEET_PARTS, replication=ReplicationSpec(replicas=2),
        gateway=GatewaySpec(window=WindowPolicy(**STRUCT_WINDOW)),
        index=IndexSpec(structured=True, facet_fields=("cat",)),
        search_config=cfg, runtime_config=RuntimeConfig(seed=0)), device=device)
    t1 = time.perf_counter()
    require(app.indexer.live_corpus() == base, "generation 1's live corpus != the fleet's docs")
    print(f"[9] {n_docs} fielded docs ({len(base)} in the fleet, {len(incoming)} incoming): "
          f"corpus {t0 - t_phase:.1f} s; fleet of {FLEET_PARTS} x 2 replicas, format v2, "
          f"pruned + kernels, k {STRUCT_K}, lazy: built in {t1 - t0:.1f} s", flush=True)
    oracle = oracle_on(pending, device, "generation 1")
    launches = {}
    traffic = structured_traffic(app, sqs, bag, kern, 1)
    launches.update({f"{kind}": tr[3] for kind, tr in traffic.items()})
    structured_checks(app, sqs, bag, traffic, oracle, 1, cfg.max_blocks * 128)
    evaluator_card_vs_cpu(app, cfg, sqs, torch, device, 1)
    split = leaf_split(app, sqs, kern)
    walls = {1: {kind: tr[2] for kind, tr in traffic.items()}}

    # the write: adds and seeded deletes committed inside an open window
    live_ids = [e for e, _ in app.indexer.live_corpus()]
    rng = np.random.default_rng(9)
    deleted = [live_ids[i] for i in rng.choice(len(live_ids), STRUCT_DELETES, replace=False)]
    corpus_g1 = app.indexer.live_corpus()
    t_sub = app.runtime.clock + 1.0
    half = N_QUERIES // 2
    offsets = struct_offsets(N_QUERIES, seed=11)
    pre = [app.submit(sq=q, k=K, facets=["cat"], fetch_docs=False, t_arrival=t_sub + float(off))
           for q, off in zip(sqs[:half], offsets)]
    t_w = t_sub + float(offsets[half - 1]) + 1e-3
    require(app.add_documents(incoming, t_arrival=t_w).ok
            and app.delete_documents(deleted, t_arrival=t_w).ok, "staging")
    t0 = time.perf_counter()
    c = app.commit(t_arrival=t_w)
    t_commit = time.perf_counter() - t0
    require(c.status == 200 and c.body["committed"] and c.body["gen"] == 2, f"commit {c.body}")
    corpus_g2 = app.indexer.live_corpus()
    pending = pool.submit(oracle_on_cpu, corpus_g2)
    t_post = max(app.runtime.clock, t_w)
    post = [app.submit(sq=q, k=K, facets=["cat"], fetch_docs=False,
                       t_arrival=t_post + float(off - offsets[half - 1]))
            for q, off in zip(sqs[half:], offsets[half:])]
    app.flush()
    print(f"[9] commit of {len(incoming)} adds and {STRUCT_DELETES} deletes inside an open "
          f"window: host wall {t_commit:.2f} s, modeled {c.latency_s:.4f} s, merged "
          f"{c.body['merged']}, {c.body['pings']} rollover pings; the window's {N_QUERIES} "
          f"queries in {len({h.response.body['generation'] for h in pre + post})} generations",
          flush=True)
    window_check(pre, sqs[:half], oracle, corpus_g1, 1)
    traffic2 = structured_traffic(app, sqs, bag, kern, 2)
    launches.update({f"{kind} gen 2": tr[3] for kind, tr in traffic2.items()})
    oracle2 = oracle_on(pending, device, "generation 2")
    window_check(post, sqs[half:], oracle2, corpus_g2, 2)
    print(f"[9] the window around the commit: {half} queries admitted before it answered from "
          f"generation 1, {N_QUERIES - half} after it from generation 2, each == its "
          f"generation's oracle", flush=True)
    structured_checks(app, sqs, bag, traffic2, oracle2, 2, cfg.max_blocks * 128)
    gone = {e for tr in traffic2.values() for body in tr[1] for e in body["ext_ids"]} & set(deleted)
    require(not gone, f"deleted ext ids served: {sorted(gone)[:5]}")
    evaluator_card_vs_cpu(app, cfg, sqs, torch, device, 2)
    walls[2] = {kind: tr[2] for kind, tr in traffic2.items()}
    for gen, w in walls.items():
        p = {kind: (np.percentile(x[1:], 50), np.percentile(x[1:], 99)) for kind, x in w.items()}
        print(f"[9] generation {gen} steady wall (queries 3-21): structured p50 {p['structured'][0]:.3f} ms p99 "
              f"{p['structured'][1]:.3f} ms; bag-of-words p50 {p['bag-of-words'][0]:.3f} ms p99 "
              f"{p['bag-of-words'][1]:.3f} ms; structured p99 / bag-of-words p99 "
              f"{p['structured'][1] / p['bag-of-words'][1]:.2f} (B16's gate is 2, printed, "
              f"not enforced)", flush=True)
    print(f"[9] phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, split


# -- phase 10: the paper's §3 mesh path at the anlessini geometry ------------------------

MESH_PARTS = 256               # the dry-run's 256 chips
MESH_SHAPE = (16, 16)          # ... as a ("data", "model") mesh, stacked on the one card
MESH_AXES = ("data", "model")
MESH_REPS = 20                 # warm batches timed per (shape, accumulator)
MESH_SAMPLE = (0, 17, 130, 255)    # partitions re-run one at a time
MESH_ZIPF, MESH_DOC_LEN = 1.3, 60  # synth_corpus's term model and passage length
MESH_CHUNK = 32                # partitions packed at a time while the state is made
MESH_K1, MESH_B = 0.9, 0.4     # IndexWriter's defaults
MESH_GEOMETRY_POSTINGS = 495_000_000   # configs/anlessini.py: ~495M postings in all


def anlessini_terms(cfg, seed: int = 0):
    """The term layout every partition shares: ``synth_corpus``'s Zipf(1.3)
    token model at 60 tokens a passage gives each rank's expected df in
    ``n_docs_local`` passages; ranks take blocks of 128 in order until the
    geometry's ``n_blocks_local`` is spent (the rest is padding), and a
    seeded permutation maps ranks to term ids. Every term pads its last
    block, and most live terms are rare, so the blocks hold about half the
    postings the geometry's ~495M (98 % of its lanes) would put in a
    partition: the array shapes are the geometry's, the postings the term
    model's. Returns (df by term id (V,), term_offsets (V + 1,), the live
    ranks' term ids and token probabilities)."""
    n, NB, B, V = cfg.n_docs_local, cfg.n_blocks_local, cfg.block, cfg.vocab
    p = np.arange(1, V + 1, dtype=np.float64) ** -MESH_ZIPF
    p /= p.sum()
    df = np.minimum(n, np.maximum(1, np.rint(n * -np.expm1(-MESH_DOC_LEN * p)))).astype(np.int64)
    blocks = -(-df // B)
    live = int(np.searchsorted(np.cumsum(blocks), NB, side="right"))
    ids = np.random.default_rng(seed).permutation(V)[:live]
    df_by_id = np.zeros(V, np.int64)
    df_by_id[ids] = df[:live]
    offsets = np.zeros(V + 1, np.int64)
    offsets[1:] = np.cumsum(-(-df_by_id // B))
    return df_by_id, offsets, ids, p[:live] / p[:live].sum()


def anlessini_state(cfg, torch, device, seed: int = 0):
    """``stack_partitions``' layout at the anlessini geometry, made from a
    seed on the card instead of packing 8.8M passages through
    ``IndexWriter``: per partition and live term, ``df`` distinct docs
    (``(a·j + c) mod n`` with a a unit mod n), tf ~ 1 + Geometric(0.6),
    doc lengths ~ ``synth_corpus``'s lognormal; global idf and avgdl; each
    term's postings sorted by f64 impact (stable, as ``IndexWriter.pack``)
    and cut into blocks of 128 whose ``block_max`` is the f32 of the
    largest; pad lanes and blocks docs = n_docs_local, tf = 0."""
    n, NB, B, V, P_ = cfg.n_docs_local, cfg.n_blocks_local, cfg.block, cfg.vocab, cfg.n_parts
    df_by_id, offsets, live_ids, probs = anlessini_terms(cfg, seed)
    live = np.flatnonzero(df_by_id)                      # id order
    counts = df_by_id[live]
    n_post = int(counts.sum())
    term = np.repeat(np.arange(len(live)), counts)       # posting → live-term index
    j = np.arange(n_post) - np.repeat(np.cumsum(counts) - counts, counts)
    dest = offsets[live][term] * B + j                   # flat (block, lane) slot
    first = j % B == 0
    rng = np.random.default_rng(seed + 1)
    a = 30 * rng.integers(0, n // 30, (P_, len(live))) + 1
    require(bool((np.gcd(a, n) == 1).all()), "a step is not a unit mod n_docs_local")
    c = rng.integers(0, n, (P_, len(live)))
    gen = torch.Generator(device=device).manual_seed(seed)
    doc_len = torch.ones(P_, n + 1, dtype=torch.float32, device=device)
    z = torch.randn(P_, n, generator=gen, device=device, dtype=torch.float64)
    doc_len[:, :n] = torch.clamp(torch.floor(torch.exp(math.log(MESH_DOC_LEN) + 0.4 * z)),
                                 min=4).float()
    avgdl = float(np.float32(doc_len[:, :n].double().mean().item()))
    N, df_g = P_ * n, P_ * df_by_id.astype(np.float64)
    idf = np.log(1.0 + (N - df_g + 0.5) / (df_g + 0.5)).astype(np.float32)
    term_t = torch.as_tensor(term, device=device)
    j_t = torch.as_tensor(j, device=device)
    dest_t = torch.as_tensor(dest, device=device)
    first_t = torch.as_tensor(first, device=device)
    bmax_dest = torch.as_tensor(dest[first] // B, device=device)
    idf_live = torch.as_tensor(idf[live], device=device).double()
    state = {
        "term_offsets": torch.as_tensor(offsets.astype(np.int32), device=device)
        .expand(P_, V + 1).contiguous(),
        "block_docs": torch.full((P_, NB, B), n, dtype=torch.int32, device=device),
        "block_tf": torch.zeros(P_, NB, B, dtype=torch.uint8, device=device),
        "block_max": torch.zeros(P_, NB, dtype=torch.float32, device=device),
        "doc_len": doc_len,
        "idf": torch.as_tensor(idf, device=device),
        "params": torch.tensor([MESH_K1, MESH_B, avgdl], dtype=torch.float32, device=device),
    }
    for lo in range(0, P_, MESH_CHUNK):
        hi = min(P_, lo + MESH_CHUNK)
        at = torch.as_tensor(a[lo:hi], device=device)[:, term_t]
        ct = torch.as_tensor(c[lo:hi], device=device)[:, term_t]
        docs = (at * j_t + ct) % n                                       # (C, n_post)
        u = torch.rand(hi - lo, n_post, generator=gen, device=device, dtype=torch.float64)
        tf = torch.clamp(1 + torch.floor(torch.log1p(-u) / math.log(0.4)), max=40)
        dl = torch.gather(doc_len[lo:hi], 1, docs).double()
        imp = idf_live[term_t] * tf / (tf + MESH_K1 * (1 - MESH_B + MESH_B * dl / avgdl))
        o1 = torch.sort(-imp, dim=1, stable=True).indices
        order = torch.gather(o1, 1, torch.sort(term_t[o1], dim=1, stable=True).indices)
        docs, tf, imp = (torch.gather(x, 1, order) for x in (docs, tf, imp))
        state["block_docs"][lo:hi].view(hi - lo, -1)[:, dest_t] = docs.int()
        state["block_tf"][lo:hi].view(hi - lo, -1)[:, dest_t] = tf.to(torch.uint8)
        state["block_max"][lo:hi][:, bmax_dest] = imp[:, first_t].float()
    blocks = -(-counts // B)
    return state, dict(live_ids=live_ids, probs=probs, offsets=offsets, df=df_by_id,
                       n_post=n_post,
                       n_terms=len(live), multi=int((blocks > 1).sum()),
                       multi_blocks=int(blocks[blocks > 1].sum()), largest=int(blocks.max()))


def anlessini_queries(terms: dict, Q: int, max_terms: int, seed: int):
    """``Q`` queries of 16 tokens drawn from the live terms' token
    probabilities (``synth_queries``' width of a query is its 16 token
    positions here), encoded as ``encode_queries`` does: distinct terms
    with their counts as qtf, padded with -1."""
    from collections import Counter
    rng = np.random.default_rng(seed)
    tids = np.full((Q, max_terms), -1, np.int32)
    qtf = np.zeros((Q, max_terms), np.float32)
    for q in range(Q):
        toks = terms["live_ids"][rng.choice(len(terms["probs"]), 16, p=terms["probs"])]
        for j, (t, c) in enumerate(Counter(toks.tolist()).items()):
            tids[q, j], qtf[q, j] = t, c
    return tids, qtf


def gathered_order(hierarchical: bool) -> list:
    """The partitions' order along a gathered row: the fused gather's is
    row-major over (data, model); the hierarchical one (data, then model)
    puts each model coordinate's data partitions together."""
    d_n, m_n = MESH_SHAPE
    if not hierarchical:
        return list(range(d_n * m_n))
    return [d * m_n + m for m in range(m_n) for d in range(d_n)]


def mesh_search(state, cfg, tids, qtf, mesh, kern, ref, torch, route, launches):
    """One shape's checks on the stacked mesh: both accumulators and both
    gathers, the launch counters around each; pruned == dense bitwise;
    fused == hierarchical but for ties; the survivors of sampled partitions
    run one at a time == the stacked body's, bitwise; the merge == K2 and
    its twin over the gathered survivors, bitwise. Returns the answers and
    the survivors' gathered rows."""
    import functools

    from repro_torch.parallel import compat
    from repro_torch.parallel.compat import P, StackedMesh
    from repro_torch.search import distributed as dist
    from repro_torch.search.distributed import make_dist_search_fn, partitions_per_call
    Q, k, n = tids.shape[0], cfg.k, cfg.n_docs_local
    chunks = -(-cfg.n_parts // partitions_per_call(cfg, Q, tids.shape[1]))
    per_call = chunks * topk_launches(n, k) + topk_launches(cfg.n_parts * k, k)
    out = {}
    for acc in ("dense", "pruned"):
        for fused in (False, True):
            c = dataclasses.replace(cfg, accumulator=acc, fused_gather=fused)
            fn = make_dist_search_fn(c, MESH_AXES, mesh=mesh)
            reset(kern)
            s, i = fn(state, tids, qtf)
            torch.cuda.synchronize()
            name = f"{route} {acc}{' fused' if fused else ''}"
            launches[name] = counted(kern, name, {"K2": per_call})
            require(s.shape == (Q, k) and bool(torch.isfinite(s).all())
                    and bool((s[:, :-1] >= s[:, 1:]).all()), f"{name}: not (Q, k) descending")
            out[acc, fused] = (s, i)
    for fused in (False, True):
        (sd, id_), (sp, ip) = out["dense", fused], out["pruned", fused]
        require(bits_equal(sd, sp) and bits_equal(id_, ip), f"{route}: pruned != dense")
    (sh, ih), (sf, i_f) = out["dense", False], out["dense", True]
    require(bits_equal(sh, sf), f"{route}: fused != hierarchical scores")
    for q, r in zip(*torch.nonzero(ih != i_f, as_tuple=True)):
        require(int((sh[q] == sh[q, r]).sum()) > 1, f"{route}: ids differ without a tie")
    ties = int((ih != i_f).sum())
    surv = compat.shard_map(
        functools.partial(dist._local_search, cfg=cfg, axes=MESH_AXES), mesh,
        in_specs=(dist.dist_state_specs(MESH_AXES), P(None, None), P(None, None)),
        out_specs=(P(MESH_AXES), P(MESH_AXES)))
    lv, li = surv(state, tids, qtf)
    lv, li = lv.view(cfg.n_parts, Q, k), li.view(cfg.n_parts, Q, k)
    one = StackedMesh((1, 1), MESH_AXES, device=mesh.device)
    specs = dist.dist_state_specs(MESH_AXES)
    for p in MESH_SAMPLE:
        sub = {key: v[p:p + 1] if specs[key][0] else v for key, v in state.items()}
        c1 = dataclasses.replace(cfg, n_parts=1)
        v1, i1 = compat.shard_map(
            functools.partial(dist._local_search, cfg=c1, axes=MESH_AXES), one,
            in_specs=(specs, P(None, None), P(None, None)),
            out_specs=(P(None, None), P(None, None)))(sub, tids, qtf)
        require(bits_equal(v1, lv[p]) and bits_equal(i1 + p * n, li[p]),
                f"{route}: partition {p} alone != the stacked body")
    rows = {}
    for fused in (False, True):
        order = torch.tensor(gathered_order(not fused), device=lv.device)
        gv = lv[order].permute(1, 0, 2).reshape(Q, -1).contiguous()
        gi = li[order].permute(1, 0, 2).reshape(Q, -1)
        (kv, kp), (tv, tp) = kern["K2"](gv, k), ref.topk_ref(gv, k)
        require(bits_equal(kv, tv) and bits_equal(kp, tp), f"{route}: K2 != twin on the merge")
        s, i = out["dense", fused]
        require(bits_equal(kv, s) and bits_equal(torch.gather(gi, 1, kp.long()), i),
                f"{route}: the merge of the gathered survivors != the mesh's answer")
        rows[fused] = gv
    print(f"[10] {route}: K2 {per_call} launches a call ({chunks} scoring calls of "
          f"{cfg.n_parts // chunks} partitions) and no other kernel; pruned == dense "
          f"bitwise (both gathers); fused == hierarchical but for {ties} tied ids; partitions "
          f"{list(MESH_SAMPLE)} one at a time == the stacked body; the merge == K2 == twin over "
          f"the gathered survivors", flush=True)
    return out, rows


def mesh_phase(kern, ref, torch, device="cuda"):
    """Phase 10: the paper's §3 mesh search path at the anlessini geometry,
    stacked on the card, then bert4rec's sharded vocabulary top-k and fm's
    row-sharded lookup. Returns (launches by route, K2's cases at the
    mesh's shapes, wall p50/p99 ms by accumulator and shape)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.embedding import sharded_lookup_shardmap
    from repro_torch.models.recsys import bert4rec_serve_topk, recsys_param_defs
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    from repro_torch.search import bm25
    from repro_torch.search import distributed as dist
    from repro_torch.search.distributed import make_dist_search_fn
    t_phase = time.perf_counter()
    an = get_arch("anlessini")
    cfg = an.full_config(MESH_PARTS)
    mesh = StackedMesh(MESH_SHAPE, MESH_AXES, device=device)
    t0 = time.perf_counter()
    state, terms = anlessini_state(cfg, torch, device)
    torch.cuda.synchronize()
    print(f"[10] anlessini full_config({MESH_PARTS}) on a stacked {MESH_SHAPE} mesh: "
          f"{cfg.n_docs_local} docs and {cfg.n_blocks_local} blocks of {cfg.block} a "
          f"partition, vocab {cfg.vocab}, {terms['n_terms']} live terms "
          f"({terms['n_post']} postings a partition: "
          f"{100 * terms['n_post'] * cfg.n_parts / MESH_GEOMETRY_POSTINGS:.1f} % of the "
          f"geometry's {MESH_GEOMETRY_POSTINGS // cfg.n_parts}, "
          f"{100 * terms['n_post'] / (cfg.n_blocks_local * cfg.block):.1f} % of the lanes), "
          f"{terms['multi']} of more than one block "
          f"holding {terms['multi_blocks']} blocks, the largest {terms['largest']}; made on the "
          f"card in {time.perf_counter() - t0:.1f} s: "
          f"{ {key: v.nbytes for key, v in state.items()} } B", flush=True)
    launches, cases, walls_ms = {}, {}, {}
    for sname, shape in an.SHAPES.items():
        Q = shape["Q"]
        tids, qtf = anlessini_queries(terms, Q, cfg.max_terms, seed=Q)
        t = np.maximum(tids, 0)
        nb = np.minimum(cfg.max_blocks, np.diff(terms["offsets"])[t]) * (tids >= 0)
        real = int(nb.sum())
        real_post = int(np.minimum(terms["df"][t], nb * cfg.block).sum())
        lanes = Q * cfg.max_terms * cfg.max_blocks * cfg.block
        print(f"[10] {sname}: {float((tids >= 0).sum(1).mean()):.2f} distinct terms a query, "
              f"{real / Q:.1f} of the {cfg.max_terms * cfg.max_blocks} gathered blocks a query "
              f"real, holding {real_post / Q:.1f} postings: "
              f"{100 * real_post / (real * cfg.block):.1f} % of the real blocks' lanes, "
              f"{100 * real_post / lanes:.1f} % of all gathered lanes", flush=True)
        route = f"mesh:anlessini {sname}"
        out, rows = mesh_search(state, cfg, tids, qtf, mesh, kern, ref, torch, route, launches)
        for acc in ("dense", "pruned"):
            fn = make_dist_search_fn(dataclasses.replace(cfg, accumulator=acc),
                                     MESH_AXES, mesh=mesh)
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(MESH_REPS + 1):
                t0 = time.perf_counter()
                fn(state, tids, qtf)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            walls = np.asarray(walls[1:]) * 1e3
            print(f"[10] {acc} {sname} (Q {Q}, hierarchical gather): wall p50 "
                  f"{np.percentile(walls, 50):.3f} ms p99 {np.percentile(walls, 99):.3f} ms over "
                  f"{MESH_REPS} warm batches; max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} B", flush=True)
            walls_ms[f"{acc} {sname}"] = [float(np.percentile(walls, 50)),
                                          float(np.percentile(walls, 99))]
            if acc == "dense":
                profile_window("10", f"dense {sname}", lambda b: fn(state, *b),
                               [(tids, qtf)] * 4, kern)
        # K2's local rows as the path launches them: one scoring call's partitions
        per = min(cfg.n_parts, dist.partitions_per_call(cfg, Q, cfg.max_terms))
        local = dist.stacked_search_state(
            {key: state[key][:per] for key in ("term_offsets", "block_docs", "block_tf",
                                               "block_max", "doc_len")},
            state["idf"], state["params"], cfg)
        rep = lambda x: torch.as_tensor(x, device=device).repeat(per, 1)
        scores = bm25.score_dense(local, rep(tids), rep(qtf), max_blocks=cfg.max_blocks)
        scores = scores.contiguous()
        cases[f"local top-k {sname}"] = k2_case(kern["K2"], ref, torch, scores, cfg.k,
                                                f"{route} local top-k")
        print_case("10", f"K2 on the mesh's local rows ({sname})", cases[f"local top-k {sname}"])
        del scores
        cases[f"merge {sname}"] = k2_case(kern["K2"], ref, torch, rows[False], cfg.k,
                                          f"{route} merge")
        print_case("10", f"K2 on the mesh's gathered survivors ({sname})",
                   cases[f"merge {sname}"])
    del state
    torch.cuda.empty_cache()
    print(f"[10] the search mesh took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # bert4rec's vocabulary top-k over a stacked (1, 4) mesh, 512 rows
    t0 = time.perf_counter()
    b4r = get_arch("bert4rec").full_config()
    params = init_params(recsys_param_defs(b4r), torch.Generator().manual_seed(0), device)
    seq = recsys_batch(b4r, RECSYS_SHAPES["serve_p99"])["seq"]
    V, k = b4r.n_items + 2, RECSYS_SHAPES["k"]
    reset(kern)
    want_v, want_i = bert4rec_serve_topk(params, seq, b4r, k=k, device=device)
    torch.cuda.synchronize()
    launches["mesh:bert4rec unsharded serve_p99"] = counted(
        kern, "bert4rec unsharded", {"K5": b4r.n_blocks, "K2": topk_launches(V, k)})
    sharded = dataclasses.replace(b4r, sharded_topk=True)
    with use_mesh(StackedMesh((1, 4), MESH_AXES, device=device)):
        reset(kern)
        got_v, got_i = bert4rec_serve_topk(params, seq, sharded, k=k, device=device)
        torch.cuda.synchronize()
        launches["mesh:bert4rec sharded_topk serve_p99"] = counted(
            kern, "bert4rec sharded_topk", {"K5": b4r.n_blocks,
                                            "K2": topk_launches(V // 4, k) + topk_launches(4 * k, k)})
    require(bits_equal(got_i, want_i) and bits_equal(got_v, want_v),
            "bert4rec sharded_topk != unsharded")
    print(f"[10] bert4rec sharded_topk over a stacked (1, 4) mesh, {seq.shape[0]} rows, k {k}: "
          f"ids and value bits == sharded_topk=False; launches "
          f"{launches['mesh:bert4rec sharded_topk serve_p99']} (unsharded "
          f"{launches['mesh:bert4rec unsharded serve_p99']}), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params

    # fm's row-sharded lookup over a stacked (2, 4) mesh
    fm = get_arch("fm").full_config()
    gen = torch.Generator(device=device).manual_seed(1)
    table = torch.randn(fm.rows_per_field, fm.embed_dim, generator=gen, device=device)
    ids = torch.as_tensor(recsys_batch(fm, RECSYS_SHAPES["serve_p99"])["sparse"],
                          device=device).reshape(-1)
    reset(kern)
    rows_ = sharded_lookup_shardmap(StackedMesh((2, 4), MESH_AXES, device=device), table, ids)
    torch.cuda.synchronize()
    launches["mesh:fm sharded lookup"] = counted(kern, "fm sharded lookup", {})
    require(bits_equal(rows_, torch.index_select(table, 0, ids.long())),
            "sharded_lookup_shardmap != index_select")
    print(f"[10] fm sharded_lookup_shardmap over a stacked (2, 4) mesh: {ids.numel()} ids into "
          f"{tuple(table.shape)} == index_select bitwise, no kernel", flush=True)
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, cases, walls_ms


# -- phase 11: the serve launcher and the Crane & Lin baseline ------------------------

SERVE_ARGS = dict(docs=20_000, queries=500, vocab=20_000, qps=20.0, k=10, memory_gb=2,
                  partitions=0, replicas=1, hedge=0.0, kernel=False)   # the launcher's defaults
SERVE_CPU_QUERIES = 20         # the first queries answered again by the same app on the CPU
B2_QUERIES = 200               # benchmarks/run.py's B2 at its default 20,000 docs


@contextlib.contextmanager
def recorded_apps(module, name: str, apps: list):
    """While open, every app built by ``module.name`` is appended to
    ``apps`` with the ids of each answer it gives kept in ``app.answers``."""
    build = getattr(module, name)

    def recording(*args, **kw):
        app = build(*args, **kw)
        app.answers = []
        query = app.query

        def answer(*qargs, **qkw):
            r = query(*qargs, **qkw)
            app.answers.append(list(r.body["ids"]) if r.ok else None)
            return r

        app.query = answer
        apps.append(app)
        return app

    setattr(module, name, recording)
    try:
        yield apps
    finally:
        setattr(module, name, build)


def serve_phase(kern, torch, device="cuda"):
    """Phase 11: ``python -m repro_torch.launch.serve`` on the card at its
    defaults, through ``run_single(--kernel)`` and ``run_partitioned(
    --partitions 4 --replicas 2)``: every response ok, the single run on K3
    alone (one launch a query), its first answers equal to the same launcher's
    on the CPU; then the reference's B2: ``KVPostingsIndex`` (Crane & Lin,
    plain Python, modeled DynamoDB time) against the card's warm p50."""
    from repro_torch.baselines.kvstore_search import KVPostingsIndex
    from repro_torch.data.corpus import synth_corpus, synth_queries
    from repro_torch.launch import serve
    from repro_torch.search import service
    t_phase = time.perf_counter()
    args = argparse.Namespace(**dict(SERVE_ARGS, kernel=True), device=device)
    reset(kern)
    t0 = time.perf_counter()
    with recorded_apps(serve, "build_search_app", []) as apps:
        single = serve.run_single(args)
    launches = {"serve:single": counted(kern, "serve:single", {"K3": args.queries})}
    require(len(apps) == 1 and len(apps[0].answers) == args.queries
            and all(a is not None for a in apps[0].answers), "serve: a response was not ok")
    print(f"[11] run_single --kernel on the card ({time.perf_counter() - t0:.1f} s; "
          f"launches {launches['serve:single']}): {json.dumps(single)}", flush=True)
    cpu_args = argparse.Namespace(**dict(vars(args), queries=SERVE_CPU_QUERIES, device="cpu"))
    t0 = time.perf_counter()
    with recorded_apps(serve, "build_search_app", []) as cpu_apps:
        serve.run_single(cpu_args)
    require(cpu_apps[0].answers == apps[0].answers[:SERVE_CPU_QUERIES],
            "serve: the card's ids != the CPU's")
    print(f"[11] the first {SERVE_CPU_QUERIES} answers' ids equal the same launcher's on the CPU "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del apps, cpu_apps
    part_args = argparse.Namespace(**dict(vars(args), kernel=False, partitions=4, replicas=2))
    t0 = time.perf_counter()
    with recorded_apps(service, "build_partitioned_search_app", []) as fleets:
        fleet = serve.run_partitioned(part_args)
    require(len(fleets[0].answers) == args.queries
            and all(a is not None for a in fleets[0].answers), "serve: a fleet response not ok")
    print(f"[11] run_partitioned --partitions 4 --replicas 2 on the card "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(fleet)}", flush=True)
    del fleets

    # B2 (benchmarks/run.py's bench_baseline), through the port
    t0 = time.perf_counter()
    docs = synth_corpus(args.docs, vocab=max(2000, args.docs // 2), seed=0)
    queries = synth_queries(docs, B2_QUERIES, seed=2)
    kv = KVPostingsIndex()
    kv.build(docs)
    kv_lat = [kv.search(q)[1] for q in queries]
    app = service.build_search_app(docs, device=device)
    t = 0.0
    for q in queries:
        require(app.query(q, t_arrival=t).ok, "B2: a response was not ok")
        t = app.runtime.clock + 0.05
    warm = [r.latency_s for r in app.runtime.records if not r.cold]
    kv_p50, our_p50 = float(np.median(kv_lat)), float(np.median(warm))
    b2 = {"kvstore_baseline_p50_ms": round(kv_p50 * 1e3, 1),
          "anlessini_warm_p50_ms": round(our_p50 * 1e3, 1),
          "speedup_x": round(kv_p50 / max(our_p50, 1e-9), 1)}
    print(f"[11] B2 vs Crane & Lin '17 ({args.docs} docs, {B2_QUERIES} queries, "
          f"{time.perf_counter() - t0:.1f} s): {json.dumps(b2)}", flush=True)
    print(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, {"single": single, "partitioned": fleet, "b2": b2}


# -- phases 12 and 13: the MoE and MLA LMs with expert-parallel MoE -------------------

MOE_RUNS = {
    # olmoe at full_config(); deepseek-v2 at full width on 4 of its 60 layers
    "olmoe-1b-7b": dict(tag="12", layers=None, batch=4, prompt=4096, steps=32),
    "deepseek-v2-236b": dict(tag="13", layers=4, batch=2, prompt=2048, steps=16),
}
EP_MESH = (1, 4)               # the EP check's stacked ("data", "model") mesh
# |EP − global| <= EP_TOL · max|global| on layer 0's routed FFN: the psum of
# 4 partials and one sequential sum of up to K bf16 adds round at other
# points, each add by up to 2^-9 of its partial sum: K · 2^-8 at K 8.
EP_TOL = 2.0 ** -5


def latent_cache_line(cfg, cache) -> str:
    """The MLA latent cache's bytes beside a GQA cache of the same heads
    (k of the qk dim, v of the v dim, every head)."""
    m = cfg.mla
    latent = sum(t.numel() * t.element_size() for t in cache.values())
    L, B, slots, _ = cache["ckv"].shape
    gqa = L * B * slots * cfg.n_heads * (m.nope_dim + m.rope_dim + m.v_dim) * \
        cache["ckv"].element_size()
    return (f"latent cache {latent} B (ckv {tuple(cache['ckv'].shape)} + krope "
            f"{tuple(cache['krope'].shape)}) against {gqa} B for k/v of the same {cfg.n_heads} "
            f"heads: {gqa / latent:.1f}x smaller")


def moe_layer0(model, cfg, prompts, torch):
    """Layer 0 on the prompts: its attention's q/k/v and K5 arguments, and
    the FFN's input (the hidden states the router sees)."""
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm
    from repro_torch.models.transformer import _mla_qkv, _qkv
    lp = model.layers[0]
    S = prompts.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=prompts.device)
    x = model.embed[prompts.long()]
    h = rms_norm(x, lp["ln1"])
    if cfg.mla is not None:
        m = cfg.mla
        B, H = prompts.shape[0], cfg.n_heads
        q_nope, q_rope, c_kv, k_rope = _mla_qkv(lp["attn"], h, cfg, positions)
        kv = (c_kv @ lp["attn"]["wkv_b"]).reshape(B, S, H, m.nope_dim + m.v_dim).transpose(1, 2)
        q = torch.cat([q_nope, q_rope], dim=-1).contiguous()
        k = torch.cat([kv[..., :m.nope_dim], k_rope[:, None].expand(B, H, S, m.rope_dim)],
                      dim=-1).contiguous()
        v = kv[..., m.nope_dim:].contiguous()
        kw = dict(causal=True, sm_scale=1.0 / math.sqrt(m.nope_dim + m.rope_dim))
    else:
        q, k, v = (t.contiguous() for t in _qkv(lp["attn"], h, cfg, positions))
        kw = dict(causal=True, window=cfg.window)
    o = attention(q, k, v, **kw)
    a = o.transpose(1, 2).reshape(*x.shape[:2], -1) @ lp["attn"]["wo"]
    return (q, k, v, kw), rms_norm(x + a, lp["ln2"])


def ep_check(ffn, h, cfg, kern, torch, tag) -> dict:
    """Layer 0's routed FFN on the prompts' real hidden states: the
    expert-parallel path on a stacked ``EP_MESH`` mesh against the global
    dispatch (``moe_ffn``): the kept assignments and slot tables equal,
    the outputs within ``EP_TOL``; the global combine run twice, equal bit
    for bit."""
    from repro_torch.models import moe
    from repro_torch.models.moe_ep import ep_moe_ffn, ep_tables
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    mesh = StackedMesh(EP_MESH, device=h.device)
    _, keep, slots = moe._tables(ffn, h, cfg.moe)
    y, aux = moe.moe_ffn(ffn, h, cfg.moe)
    again, _ = moe.moe_ffn(ffn, h, cfg.moe)
    with use_mesh(mesh):
        ep_keep, ep_slots = ep_tables(ffn, h, cfg.moe)
        ep_y, ep_aux = ep_moe_ffn(ffn, h, cfg.moe)
    torch.cuda.synchronize()
    require(torch.equal(ep_keep, keep.reshape(ep_keep.shape)) and torch.equal(ep_slots, slots),
            "EP's kept assignments or slot tables != the global dispatch's")
    require(same_bits(y, again), "the MoE combine is not deterministic")
    err, top = max_abs_err(ep_y, y), float(y.float().abs().max())
    require(err <= EP_TOL * top, f"EP off the global dispatch by {err}, more than "
                                 f"{EP_TOL} of {top}")
    T, K = keep.shape
    r = dict(err=err, tol=EP_TOL * top, kept=int(keep.sum()), dropped=T * K - int(keep.sum()),
             capacity=slots.shape[1], aux=float(aux), ep_aux=float(ep_aux))
    print(f"[{tag}] EP on a stacked {EP_MESH} mesh against the global dispatch on layer 0's "
          f"{T} tokens: kept assignments and the ({cfg.moe.n_experts}, {r['capacity']}) slot "
          f"table equal ({r['kept']} kept, {r['dropped']} dropped); outputs max abs err {err} "
          f"(tolerance {r['tol']:.4g} = {EP_TOL} x max|y| {top}); aux {r['aux']} vs "
          f"{r['ep_aux']}; the global combine twice: equal bit for bit", flush=True)
    return r


def moe_phase(kern, ref, torch, arch_name, device="cuda", seed=0):
    """Phase 12 (olmoe-1b-7b at ``full_config()``) or 13 (deepseek-v2-236b
    at full width on 4 layers): bf16 weights from a seeded
    ``torch.Generator`` on the card, served as shipped (``moe_impl="ep"``)
    under a stacked (1, 1) mesh; :func:`lm_serve` with the launch counters
    checked; a profiler window over one prefill; K5 and K2 against their
    twins on layer 0's real inputs and timed; EP against the global
    dispatch (:func:`ep_check`)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMDataConfig, LMTokenStream
    from repro_torch.models.common import count_params, init_params
    from repro_torch.models.transformer import LM, lm_decode, lm_param_defs, lm_prefill
    from repro_torch.parallel.compat import StackedMesh, use_mesh
    run = MOE_RUNS[arch_name]
    tag = run["tag"]
    t_phase = time.perf_counter()
    cfg = get_arch(arch_name).full_config(**({"n_layers": run["layers"]} if run["layers"] else {}))
    defs = lm_param_defs(cfg)
    t0 = time.perf_counter()
    model = LM(init_params(defs, torch.Generator(device).manual_seed(seed), device), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    require(n_params == count_params(defs) == cfg.param_count(), "parameter count")
    mo = cfg.moe
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
          f"{'MLA ' + str(cfg.mla) if cfg.mla else f'{cfg.n_kv_heads} kv heads of {cfg.dh}'}, "
          f"MoE {mo.n_experts} experts top-{mo.top_k} of d_ff {mo.d_ff} + {mo.n_shared} shared, "
          f"cf {mo.capacity_factor}, moe_impl {cfg.moe_impl!r}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n_params} parameters ({cfg.active_param_count()} active a token), {n_bytes} B, "
          f"made from seed {seed} in {time.perf_counter() - t0:.1f} s", flush=True)
    B, S, steps = run["batch"], run["prompt"], run["steps"]
    prompts = torch.as_tensor(LMTokenStream(LMDataConfig(
        vocab=cfg.vocab, batch=B, seq=S, seed=seed)).batch(0)["tokens"]).to(device)
    with use_mesh(StackedMesh((1, 1), device=device)), torch.inference_mode():
        # warm the libraries up for both shapes: a short prefill and one decode step
        logits, cache = lm_prefill(model, prompts[:, :128], cfg, max_len=128 + steps,
                                   device=device)
        lm_decode(model, cache, logits.argmax(-1, keepdim=True), 128, cfg, device=device)
        del logits, cache
        torch.cuda.synchronize()
        serve_r, launches, cache = lm_serve(model, cfg, prompts, steps, kern, torch, device,
                                            tag=tag)
        if cfg.mla is not None:
            print(f"[{tag}] {latent_cache_line(cfg, cache)}", flush=True)
        profile_window(tag, "lm prefill", lambda i: lm_prefill(
            model, prompts, cfg, max_len=S + steps, device=device), range(2), kern)
        attn, h = moe_layer0(model, cfg, prompts, torch)
        k5 = {"prefill": k5_check("prefill", kern["K5"], ref, torch, *attn, tag=tag)}
        k5_timing("prefill", k5["prefill"], attn, kern["K5"], ref, torch, reps=5, tag=tag)
        if cfg.mla is None:
            slots = cache["k"].shape[3]
            dec = (attn[0][:, :, -1:].contiguous(), cache["k"][0], cache["v"][0],
                   dict(kv_len=slots))
            k5["decode"] = k5_check("decode", kern["K5"], ref, torch, *dec, tag=tag)
            k5_timing("decode", k5["decode"], dec, kern["K5"], ref, torch, reps=50, tag=tag)
        for r in k5.values():
            r.pop("row_tol", None)
        ffn = model.layers[0]["ffn"]
        probs = torch.softmax(h.reshape(-1, cfg.d_model).float() @ ffn["router"], dim=-1)
        k2 = k2_case(kern["K2"], ref, torch, probs, mo.top_k, f"{cfg.name} router")
        print_case(tag, f"K2 ({cfg.name}'s router, layer 0)", k2)
        ep = ep_check(ffn, h, cfg, kern, torch, tag)
    del model, cache, attn, h, probs, ffn
    gc.collect()
    torch.cuda.empty_cache()
    name = arch_name.split("-")[0]
    launches = {f"{name}:{route.split(':')[1]}": c for route, c in launches.items()}
    print(f"[{tag}] phase {tag} took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(serve=serve_r, launches=launches, k5=k5, k2=k2, ep=ep)


def moe_entry(r) -> dict:
    """Phase 12's or 13's results for the JSON lines."""
    return {"serve": {key: r["serve"][key] for key in ("prefill_ms", "p50", "p99", "tok_s",
                                                       "peak", "variants")},
            "launches_by_route": r["launches"], "ep": r["ep"],
            "k5": {case: case_entry(c) for case, c in r["k5"].items()},
            "k2": case_entry(r["k2"])}


# -- 14. training on the card ------------------------------------------------------------

# graphcast at minibatch_lg: reddit's node count and feature width, the degree cut
# from ~492 to 25 for host time; 1,024 seeds, fanout 15-10 (configs/cells.py). The
# aggregator is the config's "mean" option, not its "sum": synth_graph's zipf sources
# make hubs whose in-degree in a sample reaches thousands (3,630 at 64 seeds), and
# 16 unnormalised residual sums over them overflow f32 by layer 13 (NaN at step 0 in
# either package). full_graph_sm and molecule keep "sum".
GNN_TRAIN = dict(nodes=232_965, degree=25, d_feat=602, seeds=1024, fanout=(15, 10), steps=8,
                 every=4, fail_at=6, repeat=2, aggregator="mean")
GNN_SMALL = dict(full_graph_sm=2, molecule=2)          # steps of the two other regimes
LM_TRAIN = dict(arch="h2o-danube-1.8b", batch=2, seq=4096, steps=4, lr=3e-4)
LAUNCHER_ARGV = ["--arch", "stablelm-3b", "--preset", "100m", "--steps", "20", "--batch", "16",
                 "--seq", "256", "--ckpt-every", "5", "--fail-at", "17"]
RECSYS_TRAIN = dict(archs=("fm", "dcn-v2"), batch=65_536, steps=3,
                    bert4rec_batch=4096, bert4rec_steps=3)


def tree_bits_equal(a, b) -> bool:
    """Two trees of tensors (the port's train states), leaf for leaf, bit
    for bit."""
    from repro_torch.checkpoint.manager import tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    return len(la) == len(lb) and all(
        pa == pb and same_bits(x.detach().cpu(), y.detach().cpu())
        for (pa, x), (pb, y) in zip(la, lb))


def host_copy(state):
    from repro_torch.checkpoint.manager import tree_leaves_with_path, tree_unflatten
    return tree_unflatten(state, [t.detach().to("cpu", copy=True)
                                  for _, t in tree_leaves_with_path(state)])


def timed_steps(step_fn, state, batches, torch, record=None):
    """``state = step_fn(state, batch)`` over ``batches``: (state, losses,
    walls in ms) — each wall from before the step to its loss on the host."""
    losses, walls = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
        require(math.isfinite(losses[-1]), f"a non-finite loss {losses[-1]} at step {i}")
        if record is not None:
            record(i, state)
    return state, losses, walls


def gnn_minibatch(sampler, n_nodes, d_out, step, torch, device):
    """Step ``step``'s sampled subgraph on the card: seeds from
    ``default_rng(step)``, seeded targets of width ``d_out``."""
    rng = np.random.default_rng((7, step))
    seeds = rng.choice(n_nodes, GNN_TRAIN["seeds"], replace=False)
    sub = sampler.sample(seeds, step=step)
    sub["target"] = rng.normal(size=(sub["feat"].shape[0], d_out)).astype(np.float32)
    return {k: torch.as_tensor(sub[k]).to(device) for k in ("feat", "src", "dst", "node_mask",
                                                              "target")}, sub["n_real_nodes"]


def graphcast_train(torch, device, tmp) -> dict:
    """Phase 14a: graphcast at full width on a minibatch_lg sample stream
    through ``run_with_restarts`` (a checkpoint every 4 steps to a
    filesystem ObjectStore, one injected failure), then the restore and two
    steps from the same init, each held to their first readings bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.core.object_store import FilesystemBackend, ObjectStore
    from repro_torch.data.graphs import NeighborSampler, padded_sizes, synth_graph
    from repro_torch.ft.faults import FailureInjector, run_with_restarts
    from repro_torch.models.common import init_params
    from repro_torch.models.gnn import gnn_loss, gnn_param_defs
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    run = GNN_TRAIN
    t0 = time.perf_counter()
    cfg = get_arch("graphcast").full_config(d_feat=run["d_feat"], aggregator=run["aggregator"])
    g = synth_graph(run["nodes"], avg_degree=run["degree"], d_feat=run["d_feat"], seed=0)
    sampler = NeighborSampler(g, fanout=run["fanout"], seed=0)
    t1 = time.perf_counter()
    batches, real, sample_s = {}, {}, []
    for step in range(run["steps"]):
        s0 = time.perf_counter()
        batches[step], real[step] = gnn_minibatch(sampler, run["nodes"], cfg.d_out, step, torch,
                                                  device)
        sample_s.append(time.perf_counter() - s0)
    N, E = padded_sizes(run["seeds"], run["fanout"])
    require(tuple(batches[0]["feat"].shape) == (N, run["d_feat"])
            and tuple(batches[0]["src"].shape) == (E,), "the sample's padded shapes")
    print(f"[14a] graphcast full_config(d_feat={run['d_feat']}): {cfg.n_layers} layers, d "
          f"{cfg.d_hidden}, {cfg.d_out} outputs, {cfg.aggregator}, remat "
          f"{cfg.remat_policy}, {cfg.param_count()} parameters; synth_graph({run['nodes']}, "
          f"avg_degree={run['degree']}) {t1 - t0:.1f} s; {run['steps']} samples of "
          f"{run['seeds']} seeds, fanout {run['fanout']} (padded {N} nodes, {E} edges; real "
          f"nodes {min(real.values())}-{max(real.values())}) in {sum(sample_s):.1f} s",
          flush=True)
    step_fn = make_train_step(lambda p, b: gnn_loss(p, b, cfg),
                              OptConfig(lr=1e-3, warmup_steps=2, total_steps=run["steps"]))

    def init():
        return init_train_state(init_params(gnn_param_defs(cfg),
                                            torch.Generator(device=device).manual_seed(0),
                                            device))

    # why not the config's sum: the sample's hub in-degree, and the sum's loss at init
    b0 = batches[0]
    indeg = int(torch.bincount(b0["dst"][b0["dst"] < N].long()).max())
    with torch.no_grad():
        sum_cfg = dataclasses.replace(cfg, aggregator="sum")
        sum_loss = float(gnn_loss(init()["params"], b0, sum_cfg)[0])
    print(f"[14a] step 0's sample: max in-degree {indeg}; with the sum aggregator the loss at "
          f"init is {sum_loss} ({cfg.n_layers} unnormalised sums), so this run takes "
          f"{cfg.aggregator!r}",
          flush=True)

    ckpt = CheckpointManager(ObjectStore(FilesystemBackend(str(tmp / "graphcast"))), "graphcast",
                             CheckpointConfig(every_steps=run["every"], keep=3))
    history, walls, snaps = [], [], {}

    def one_step(state, step):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[step])
        loss = float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
        require(math.isfinite(loss), f"graphcast: loss {loss} at step {step}")
        history.append((step, loss))
        if step in (1, run["every"]) and step not in snaps:
            snaps[step] = host_copy(state)
        return state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    state, stats = run_with_restarts(one_step, init(), run["steps"], ckpt,
                                     injector=FailureInjector(fail_at=(run["fail_at"],)))
    wall = time.perf_counter() - t2
    peak = torch.cuda.max_memory_allocated()
    lost = run["fail_at"] - (run["fail_at"] // run["every"]) * run["every"] - 1
    require(stats.restarts == 1 and stats.steps_lost == lost
            and stats.steps_run == run["steps"] + lost,
            f"graphcast restarts: {stats}, expected 1 restart and {lost} lost step(s)")
    # the steps run again after the restore give their first losses, bit for bit
    first = {}
    for step, loss in history:
        if step in first:
            require(loss == first[step], f"graphcast step {step} after the restore: loss "
                                         f"{loss!r}, first {first[step]!r}")
        first[step] = loss
    restored, at = ckpt.restore(state, step=run["every"])
    require(at == run["every"] and tree_bits_equal(restored, snaps[run["every"]]),
            f"the state restored at step {run['every']} is not the saved state bit for bit")
    del restored
    print(f"[14a] {run['steps']} steps, a failure injected at step {run['fail_at']}: "
          f"restarts={stats.restarts} steps_lost={stats.steps_lost} steps_run={stats.steps_run} "
          f"in {wall:.1f} s; checkpoints {ckpt.saves} ({ckpt.save_seconds:.1f} s in the writer "
          f"thread); step wall p50 {np.percentile(walls, 50):.1f} ms (p max "
          f"{max(walls):.1f}); peak memory {peak} B; losses "
          f"{[round(loss, 5) for _, loss in history]}", flush=True)
    print(f"[14a] restore at step {run['every']} == the saved state bit for bit; the "
          f"{lost} step(s) re-run after it give their first losses bit for bit", flush=True)
    # the first two steps again from the same init: the same bits
    again, _, _ = timed_steps(step_fn, init(), [batches[i] for i in range(run["repeat"])], torch)
    require(tree_bits_equal(again, snaps[run["repeat"] - 1]),
            f"graphcast: {run['repeat']} steps from one init differ between two runs")
    print(f"[14a] steps 0-{run['repeat'] - 1} run again from the same init: the same bits",
          flush=True)
    out = dict(params=cfg.param_count(), nodes=N, edges=E, max_in_degree=indeg,
               sum_loss_at_init=sum_loss, steps_run=stats.steps_run,
               restarts=stats.restarts, steps_lost=stats.steps_lost,
               wall_p50_ms=float(np.percentile(walls, 50)), peak=peak,
               losses=[loss for _, loss in history], sample_s=sum(sample_s),
               restore_bitwise=True, repeat_bitwise=True)
    del state, again, batches, snaps, g, sampler
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graphcast_small(torch, device) -> dict:
    """Phase 14a, the two other regimes: full_graph_sm (cora's 2,708 nodes,
    10,556 edges, 1,433 features) and molecule (128 graphs of 30 nodes, 64
    edges), 2 steps each from a seeded init, on seeded data."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.cells import GNN_SHAPES
    from repro_torch.data.graphs import molecule_batch
    from repro_torch.models.common import init_params
    from repro_torch.models.gnn import gnn_loss, gnn_param_defs
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    out = {}
    for name, steps in GNN_SMALL.items():
        sh = GNN_SHAPES[name]
        cfg = get_arch("graphcast").full_config(d_feat=sh["d_feat"])
        N, E, F = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
        if sh.get("batch"):
            b = molecule_batch(sh["batch"], N, E, F, cfg.d_out, seed=3)
        else:
            rng = np.random.default_rng(3)
            b = {"feat": rng.normal(size=(N, F)).astype(np.float32),
                 "src": rng.integers(0, N, E).astype(np.int32),
                 "dst": rng.integers(0, N, E).astype(np.int32),
                 "target": rng.normal(size=(N, cfg.d_out)).astype(np.float32),
                 "node_mask": np.ones(N, np.float32)}
        batch = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        state = init_train_state(init_params(gnn_param_defs(cfg),
                                             torch.Generator(device=device).manual_seed(1),
                                             device))
        step_fn = make_train_step(lambda p, bb: gnn_loss(p, bb, cfg),
                                  OptConfig(lr=1e-3, warmup_steps=1, total_steps=steps))
        torch.cuda.reset_peak_memory_stats()
        state, losses, walls = timed_steps(step_fn, state, [batch] * steps, torch)
        out[name] = dict(losses=losses, walls_ms=walls, peak=torch.cuda.max_memory_allocated())
        print(f"[14a] graphcast {name} ({sh.get('batch', 1)} graph(s) of {N} nodes, {E} edges, "
              f"{F} features, {cfg.aggregator}): {steps} steps, losses {losses}, walls "
              f"{[round(w, 1) for w in walls]} ms, peak memory {out[name]['peak']} B", flush=True)
        del state, batch
    return out


def lm_train(torch, device) -> dict:
    """Phase 14b: h2o-danube-1.8b at full width in bf16, remat
    nothing_saveable, 2 × 4,096 tokens, ``make_train_step(lm_loss)`` on one
    repeated batch: the loss falls, and the first step's loss is the same
    bits when the first step is run again from the same init."""
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import LMDataConfig, LMTokenStream
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.transformer import lm_loss, lm_param_defs
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    run = LM_TRAIN
    cfg = get_arch(run["arch"]).full_config()
    require(cfg.remat and cfg.remat_policy == "nothing_saveable" and cfg.dtype == torch.bfloat16,
            f"{cfg.name}: remat {cfg.remat} {cfg.remat_policy}, {cfg.dtype}")
    defs = lm_param_defs(cfg)
    batch = LMTokenStream(LMDataConfig(vocab=cfg.vocab, batch=run["batch"], seq=run["seq"],
                                       seed=0)).batch(0)
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg),
                              OptConfig(lr=run["lr"], warmup_steps=1, total_steps=run["steps"]))

    def init():
        return init_train_state(init_params(defs, torch.Generator(device=device).manual_seed(0),
                                            device))

    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    print(f"[14b] {cfg.name} full_config(): {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count()} parameters in {cfg.dtype}, f32 moments: train state "
          f"{state_bytes} B, made from seed 0 in {time.perf_counter() - t0:.1f} s; batch "
          f"{run['batch']} x {run['seq']} tokens (train_4k's sequence, its batch cut from 256)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    state, losses, walls = timed_steps(step_fn, state, [batch] * run["steps"], torch)
    peak = torch.cuda.max_memory_allocated()
    require(losses[-1] < losses[0], f"{cfg.name}: the loss did not fall: {losses}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _, again, _ = timed_steps(step_fn, init(), [batch], torch)
    require(again[0] == losses[0], f"{cfg.name}: first-step loss {again[0]!r} on a second run, "
                                   f"{losses[0]!r} on the first")
    print(f"[14b] {run['steps']} steps: losses {losses}; step wall p50 "
          f"{np.percentile(walls[1:], 50):.1f} ms (first {walls[0]:.1f} ms); peak memory {peak} B; "
          f"the first step's loss on a second run: the same bits", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, wall_p50_ms=float(np.percentile(walls[1:], 50)),
                first_ms=walls[0], peak=peak, state_bytes=state_bytes, repeat_bitwise=True)


def launcher_drill(torch, tmp) -> dict:
    """Phase 14c: ``python -m repro_torch.launch.train`` with LAUNCHER_ARGV,
    run through its ``main`` in this process (so the launch counters see
    it): one restart, and the last 10 steps' mean loss below the first 10's."""
    import io
    from repro_torch.launch import train
    argv = LAUNCHER_ARGV + ["--ckpt-dir", str(tmp / "launcher"),
                            "--metrics-out", str(tmp / "launcher.json")]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"[14c] {line}", flush=True)
    m = json.loads((tmp / "launcher.json").read_text())
    first = float(np.mean([h["loss"] for h in m["history"][:10]]))
    last = float(np.mean([h["loss"] for h in m["history"][-10:]]))
    require(rc == 0 and m["restarts"] == 1, f"the launcher: rc {rc}, restarts {m['restarts']}")
    require(last < first, f"the launcher: last10 {last} not below first10 {first}")
    walls = [h["sec"] * 1e3 for h in m["history"]]
    print(f"[14c] python -m repro_torch.launch.train {' '.join(LAUNCHER_ARGV)}: restarts="
          f"{m['restarts']} steps_lost={m['steps_lost']}, first10 {first:.4f} > last10 "
          f"{last:.4f}, step wall p50 {np.percentile(walls, 50):.1f} ms, {wall:.1f} s in all",
          flush=True)
    return dict(restarts=m["restarts"], steps_lost=m["steps_lost"], first10=first, last10=last,
                wall_p50_ms=float(np.percentile(walls, 50)), wall_s=wall)


def recsys_train(torch, device) -> dict:
    """Phase 14d: fm and dcn-v2 at ``full_config()``, ``train_batch``'s
    65,536 rows, 3 steps each; bert4rec's sampled loss (1,024 negatives, 32
    masked positions) at the batch RECSYS_TRAIN names."""
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import CTRStream, SequenceStream
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys import recsys_loss, recsys_param_defs
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    run = RECSYS_TRAIN
    out = {}
    for name in run["archs"] + ("bert4rec",):
        cfg = get_arch(name).full_config()
        if name == "bert4rec":
            B, steps = run["bert4rec_batch"], run["bert4rec_steps"]
            stream = SequenceStream(n_items=cfg.n_items, seq_len=cfg.seq_len, batch=B, seed=0)
        else:
            B, steps = run["batch"], run["steps"]
            stream = CTRStream(n_sparse=cfg.n_sparse, rows_per_field=cfg.rows_per_field,
                               batch=B, n_dense=cfg.n_dense, n_items=cfg.n_items, seed=0)
        batches = [{k: torch.as_tensor(v).to(device) for k, v in stream.batch_at(s).items()}
                   for s in range(steps)]
        t0 = time.perf_counter()
        state = init_train_state(init_params(recsys_param_defs(cfg),
                                             torch.Generator(device=device).manual_seed(0),
                                             device))
        step_fn = make_train_step(lambda p, b, cfg=cfg: recsys_loss(p, b, cfg),
                                  OptConfig(lr=1e-3, warmup_steps=1, total_steps=steps))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        state, losses, walls = timed_steps(step_fn, state, batches, torch)
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(batch=B, losses=losses, walls_ms=walls, peak=peak,
                         params=cfg.param_count())
        print(f"[14d] {name} full_config() ({cfg.param_count()} parameters, state made in "
              f"{t_init:.1f} s), batch {B}: {steps} steps, losses {losses}, walls "
              f"{[round(w, 1) for w in walls]} ms, peak memory {peak} B", flush=True)
        del state, batches
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_phase(kern, torch, device="cuda") -> tuple[dict, dict]:
    """Phase 14: the training path on the card (see the module docstring).
    The launch counters are set to 0 before it and must read 0 after it:
    training runs no hand kernel."""
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    reset(kern)
    out = {"memory_allocated_before": torch.cuda.memory_allocated()}
    print(f"[14] memory_allocated at the start {out['memory_allocated_before']} B", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tmp = Path(tmp)
        out["graphcast"] = graphcast_train(torch, device, tmp)
        out["graphcast_small"] = graphcast_small(torch, device)
        out["lm"] = lm_train(torch, device)
        out["launcher"] = launcher_drill(torch, tmp)
        out["recsys"] = recsys_train(torch, device)
    launches = counted(kern, "phase 14 (training)", {})
    gc.collect()
    torch.cuda.empty_cache()
    out["memory_allocated_after"] = torch.cuda.memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[14] training launched no hand kernel ({launches}); memory_allocated after release "
          f"{out['memory_allocated_after']} B; phase 14 took {out['seconds']:.1f} s", flush=True)
    return out, {"phase 14 (training)": launches}



# -- phase 15: the cells: the dry run, the cells that fit on the card, the launcher's mesh

CELLS_FIT_BYTES = 60e9          # global arguments + the trace's peak a card run may take
CELLS_SEED_BLOCK = 1 << 22      # seeded values a leaf draws; a larger leaf tiles them
CELLS_LM_BATCH = 1              # LM serving cells run at this batch (cut from 32 / 128)
CELLS_LAUNCHER = ["--arch", "stablelm-3b", "--preset", "100m", "--steps", "6", "--batch",
                  "16", "--seq", "256", "--log-every", "100"]
CELLS_ON_PATH = ("K2", "K4", "K5", "K6")    # the kernels the cells launch; K1 and K3 are not
CELLS_JOBS = 7                  # dry-run cells traced at a time, each in a worker process
CELLS_RANKS = 2                 # processes of phase 15c's rank mesh, all on the one card
# 15(d): each recsys serve and retrieval cell's sharded function, on these stacked meshes;
# serve_bulk's is cut from (16, 16): a stacked mesh runs the model replicas' towers in turn
SHARDED_MESHES = {"serve_p99": (16, 16), "serve_bulk": (4, 2), "retrieval_cand": (16, 16)}
SHARDED_RANK_MESH = (1, 2)      # 15(d)'s rank mesh: 2 gloo processes on the one card
SHARDED_RANK_CELLS = ("fm/serve_p99", "dcn-v2/serve_p99", "bst/serve_p99", "bert4rec/serve_p99",
                      "fm/retrieval_cand")
# 15(e): the dense LM serving cells' sharded functions on these stacked meshes: the
# production width of model (16) for prefill and decode_32k, so no weight is
# copied; long_500k's sequence over both axes of (2, 8)
LM_SHARDED_MESHES = {"prefill_32k": (1, 16), "decode_32k": (1, 16), "long_500k": (2, 8)}
LM_RANK_CELLS = ("h2o-danube-1.8b/decode_32k",)   # also on the (1, 2) rank mesh
UNIT = 2.0 ** -24               # f32's unit roundoff


def seeded_block(n: int, *, integer: bool, seed: int, high: int = 4, scale: float = 0.05,
                 positive: bool = False) -> "np.ndarray":
    """At most CELLS_SEED_BLOCK of a leaf's ``n`` values, made from ``seed``
    by tests/test_system.py's rule: integers in [0, high), floats normal ×
    ``scale`` (|·| for batch floats). A larger leaf tiles them: a full
    LM's billions of parameters would take minutes to draw on the host."""
    rng = np.random.default_rng(seed)
    m = min(n, CELLS_SEED_BLOCK)
    if integer:
        return rng.integers(0, high, m).astype(np.int32)
    block = (rng.standard_normal(m) * scale).astype(np.float32)
    return np.abs(block) if positive else block


def tiled_on(device, block: "np.ndarray", shape, dtype, torch):
    """``block`` on the card, tiled there over ``shape`` in ``dtype``."""
    n = math.prod(shape)
    t = torch.from_numpy(block).to(device)
    return t.repeat(-(-n // max(t.numel(), 1)))[:n].reshape(shape).to(dtype)


def cell_args(cell, args, torch, device, seed, held: dict):
    """A cell's arguments on the card, from seeds: each parameter leaf its
    seeded block tiled on the card in f32, then cast there to the leaf's
    dtype — the values ``models/weights.py::tree_from_numpy`` gives the
    tiled array, without tiling billions of values on the host (a train
    cell's state is ``init_train_state`` of those parameters: zero moments,
    as the reference's smoke test makes it), batch and cache leaves by the
    same rule, a graph's edges over all its nodes. The serving cells of one
    arch share one parameter tree, kept in ``held``."""
    from repro_torch.models.common import tree_map
    from repro_torch.train.steps import init_train_state
    seeds = iter(range(seed, seed + 1_000_000))

    def param(t):
        block = seeded_block(t.numel(), integer=False, seed=next(seeds))
        return tiled_on(device, block, tuple(t.shape), torch.float32, torch).to(t.dtype)

    def batch_leaf(t, high=4):
        block = seeded_block(t.numel(), integer=not t.is_floating_point(), seed=next(seeds),
                             high=high, positive=True)
        return tiled_on(device, block, tuple(t.shape), t.dtype, torch)

    def batch_tree(tree):
        if not isinstance(tree, dict):
            return batch_leaf(tree)
        nodes = tree["feat"].shape[-2] if "feat" in tree and "src" in tree else 4
        return {k: batch_tree(v) if isinstance(v, dict) else
                batch_leaf(v, nodes if k in ("src", "dst") else 4) for k, v in tree.items()}

    out = []
    for i, a in enumerate(args):
        if i == 0 and cell.kind == "train":
            out.append(init_train_state(tree_map(param, a["params"])))
        elif i == 0:
            if "params" not in held:
                held["params"] = tree_map(param, a)
            out.append(held["params"])
        else:
            out.append(batch_tree(a))
    return tuple(out)


def lm_cut(cell, batch: int):
    """An LM serving cell's abstract arguments at ``batch`` sequences."""
    import torch
    from repro_torch.configs.cells import LM_SHAPES, SDS, _lm_cache_abstract
    cfg = cell.fn.keywords["cfg"]
    S = LM_SHAPES[cell.shape]["seq"]
    if cell.kind == "prefill":
        return (cell.args[0], SDS((batch, S), torch.int32))
    return (cell.args[0], _lm_cache_abstract(cfg, batch, S), SDS((batch, 1), torch.int32),
            SDS((), torch.int32))


def meta_trace(fn, args, mesh):
    """``fn(*args)`` on meta tensors: its outputs' shapes, and the global
    argument bytes and peak of new storage the dry run's ``CostMode`` sees."""
    from repro_torch.launch import dryrun
    from repro_torch.parallel import compat
    with compat.use_mesh(mesh), dryrun.CostMode() as cost:
        out = fn(*args)
    arg_bytes = sum(t.numel() * t.element_size() for t in dryrun._tensors(args))
    return out, arg_bytes, cost.peak


def leaves_of(tree) -> list:
    from repro_torch.launch import dryrun
    return dryrun._tensors(tree)


class DryRun:
    """Phase 15a in a thread while 15b runs: ``repro_torch.launch.dryrun``
    over every full cell on both production meshes (single-pod first), into
    a temporary directory, its worker processes on the host's other cores.
    ``record(name)`` waits for one single-pod record."""

    def __init__(self, jobs: int):
        import tempfile
        import threading
        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_")
        self.jobs = jobs
        self.records: list = []
        self.error = None
        self.cond = threading.Condition()
        self.t0 = time.perf_counter()
        self.wall = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        from repro_torch.launch import dryrun
        try:
            for rec in dryrun.run_iter(out=self.tmp.name, force=True, jobs=self.jobs):
                print(f"[15a] {dryrun.describe(rec)}", flush=True)
                with self.cond:
                    self.records.append(rec)
                    self.cond.notify_all()
        except Exception as e:        # reported by result(); the phase fails there
            self.error = e
        finally:
            with self.cond:
                self.wall = time.perf_counter() - self.t0
                self.cond.notify_all()

    def record(self, name: str) -> dict:
        with self.cond:
            while True:
                for r in self.records:
                    if r["cell"] == name and r["mesh"] == "pod1_16x16":
                        return r
                require(self.wall is None, f"dry run ended without a record of {name}: "
                                           f"{self.error!r}")
                self.cond.wait()

    def result(self) -> tuple[list, dict]:
        """Every record, once the run has ended: each ok or a skip the
        reference also skips (512k tokens on a full-attention arch)."""
        from repro_torch.configs.cells import LONG_NOTE
        self.thread.join()
        self.tmp.cleanup()
        require(self.error is None, f"dry run: {self.error!r}")
        bad = [r["cell"] for r in self.records if not (r.get("ok") or (
            r.get("skip") and r["note"] == LONG_NOTE))]
        require(not bad, f"dry run: cells neither ok nor a reference skip: {bad}")
        per_mesh = {}
        for r in self.records:
            m = per_mesh.setdefault(r["mesh"], {"ok": 0, "skip": 0, "trace_s": 0.0})
            m["skip" if r.get("skip") else "ok"] += 1
            m["trace_s"] += r.get("compile_s", 0.0)
        print(f"[15a] dry run: {len(self.records)} (cell, mesh) records in {self.wall:.1f} s "
              f"({self.jobs} worker processes); {per_mesh}", flush=True)
        return self.records, dict(wall_s=self.wall, per_mesh=per_mesh)


def cells_on_card(dry: DryRun, kern, torch, device="cuda", seed=0) -> tuple[dict, dict, dict]:
    """Phase 15b: every full single-pod cell whose global arguments plus its
    trace's peak fit CELLS_FIT_BYTES, materialized on the card from seeds;
    the LM serving cells at CELLS_LM_BATCH sequences (cut) when the full
    weights plus that trace's peak fit. Each run holds its outputs finite
    and shaped as the meta trace at the same arguments (a train cell: the
    loss finite, the new parameters finite, the first leaf moved), and
    counts its launches of K1–K6. Phase 15d: after each recsys serve and
    retrieval cell, its sharded function on the same inputs
    (:func:`sharded_cell`); the rank mesh (:class:`ServingRanks`) beside.
    Returns (b)'s results, every run's launches, and (d)'s record."""
    from repro_torch.configs import build_cells
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import compat
    from repro_torch.parallel.compat import StackedMesh
    meta_mesh = StackedMesh((1, 1), device="meta")
    card_mesh = StackedMesh((1, 1), device=device)
    prod_meta = make_production_mesh(device="meta")
    prod_card = make_production_mesh(device=device)
    results, launches, sharded, lm_sharded, stacked_small = {}, {}, {}, {}, {}
    held: dict = {}                 # one arch's serving parameters, while its cells run
    cells = {}
    ranks = ServingRanks(seed, device)      # 15(d)'s rank mesh, beside (b)
    from repro_torch.configs import ASSIGNED
    # the LMs last: their train cells' records (the dry run's longest traces)
    # come in while the others run
    for arch in sorted(ASSIGNED + ["anlessini"], key=lambda a: a in LM_ARCHS):
        for shape, cell in build_cells(arch).items():
            cells[f"{arch}/{shape}"] = cell
    try:
        for name, cell in cells.items():
            rec = dry.record(name)
            if held.get("arch") != name.split("/")[0]:
                held.clear()
                gc.collect()
                torch.cuda.empty_cache()
                held["arch"] = name.split("/")[0]
            if rec.get("skip"):
                continue
            lm = name.split("/")[0] in LM_ARCHS and cell.kind in ("prefill", "decode")
            late = cell.fn is None          # anlessini: the mesh search is built for its mesh
            # a recsys cell with a sharded build (15d); a dense LM's is 15(e)
            serving = hasattr(cell, "build") and not late and not lm
            if late:
                fn, args, _ = cell.build(prod_meta)
                mesh_meta, mesh_card = prod_meta, prod_card
            else:
                fn, args = cell.fn, cell.args
                mesh_meta, mesh_card = meta_mesh, card_mesh
            if lm:
                args = lm_cut(cell, CELLS_LM_BATCH)
            if not (lm or serving):         # the record of a serving cell is its sharded trace's
                # the record decides the fit: a cell that does not fit (an LM's
                # train_4k) is not traced again here
                arg_bytes, peak = rec["global"]["argument_bytes"], rec["global"]["peak_bytes"]
                if arg_bytes + peak <= CELLS_FIT_BYTES:
                    want = meta_trace(fn, args, mesh_meta)[0]
            else:
                want, arg_bytes, peak = meta_trace(fn, args, mesh_meta)
            if arg_bytes + peak > CELLS_FIT_BYTES:
                results[name] = dict(run=False, bytes=arg_bytes + peak)
                continue
            t0 = time.perf_counter()
            if late:
                run_fn = cell.build(prod_card)[0]
                cargs = anlessini_args(args, torch, device, seed)
            else:
                run_fn = fn
                cargs = cell_args(cell, args, torch, device, seed, held)
            torch.cuda.synchronize()
            t_make = time.perf_counter() - t0
            before = (leaves_of(cargs[0]["params"])[0].detach().clone()
                      if cell.kind == "train" else None)
            reset(kern)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with compat.use_mesh(mesh_card):
                out = run_fn(*cargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak_card = torch.cuda.max_memory_allocated()
            got = {k: fn_.launches for k, fn_ in kern.items()}
            launches[f"phase 15 {name}"] = got
            if cell.kind == "train":
                new_state, metrics = out
                loss = float(metrics["loss"])
                require(math.isfinite(loss), f"{name}: loss {loss}")
                gl, wl = leaves_of(new_state), leaves_of(want[0])
                after = leaves_of(new_state["params"])[0]
                require(not torch.equal(before, after), f"{name}: the first parameter leaf did "
                                                        "not move")
            else:
                loss = None
                gl, wl = leaves_of(out), leaves_of(want)
            require(len(gl) == len(wl) and all(
                tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype for g, w in zip(gl, wl)),
                f"{name}: output shapes {[tuple(g.shape) for g in gl]} != the meta trace's "
                f"{[tuple(w.shape) for w in wl]}")
            require(all(bool(torch.isfinite(g.float()).all()) for g in gl if g.is_floating_point()),
                    f"{name}: non-finite outputs")
            cut = f"batch {CELLS_LM_BATCH} (cut)" if lm else "full"
            results[name] = dict(run=True, cut=cut, make_s=t_make, wall_ms=wall * 1e3,
                                 peak=peak_card, loss=loss, launches=got,
                                 bytes=arg_bytes + peak)
            print(f"[15b] {name} at {cut}: made in {t_make:.1f} s, ran in {wall * 1e3:.1f} ms, "
                  f"peak {peak_card} B (trace: args + peak {arg_bytes + peak} B), outputs finite "
                  f"and shaped as the meta trace{'' if loss is None else f', loss {loss:.6g}'}; "
                  f"launches {got}", flush=True)
            if serving:
                sharded[name], host = sharded_cell(name, cell, cargs, out, kern, torch, device)
                launches[f"phase 15d {name}"] = sharded[name]["launches"]
                stacked_small.update(host)
            elif lm and hasattr(cell, "build"):
                lm_sharded[name], host = lm_sharded_cell(name, cell, cargs, out, kern, torch,
                                                         device)
                for run in lm_sharded[name]["runs"]:
                    launches[f"phase 15e {name} {run['at']}"] = run["launches"]
                stacked_small.update(host)
            del out, cargs, before
            gc.collect()
            torch.cuda.empty_cache()
    except BaseException:            # the ranks end with the phase
        ranks.stop()
        raise
    held.clear()
    ranks_out = ranks.check(stacked_small)
    bad = {n: r["why"] for n, r in sharded.items() if not r["ok"]}
    require(len(sharded) == 12 and not bad, f"phase 15d: {len(sharded)} sharded cells ran; "
                                            f"failed: {bad}")
    seconds = sum(r["seconds"] for r in sharded.values())
    print(f"[15d] the 12 sharded cells took {seconds:.1f} s in the main process (walls, checks "
          f"and the stacked {SHARDED_RANK_MESH} runs)", flush=True)
    bad = {n: [r["why"] for r in c["runs"] if not r["ok"]] for n, c in lm_sharded.items()}
    bad = {n: w for n, w in bad.items() if w}
    require(len(lm_sharded) == 7 and not bad, f"phase 15e: {len(lm_sharded)} dense LM cells "
                                               f"ran sharded; failed: {bad}")
    lm_seconds = sum(r["seconds"] for r in lm_sharded.values())
    print(f"[15e] the 7 sharded dense LM cells took {lm_seconds:.1f} s in the main process "
          f"(the sharded runs, the unsharded steps at the extra positions, the checks and the "
          f"stacked {SHARDED_RANK_MESH} run)", flush=True)
    sharded_out = dict(cells=sharded, ranks=ranks_out, seconds=seconds,
                       lm=dict(cells=lm_sharded, seconds=lm_seconds))
    ran = [n for n, r in results.items() if r["run"]]
    print(f"[15b] {len(ran)} cells ran on the card: {ran}; not run (over "
          f"{CELLS_FIT_BYTES:.0f} B): {[n for n, r in results.items() if not r['run']]}",
          flush=True)
    total = {k: sum(c[k] for c in launches.values()) for k in kern}
    require(all(total[k] > 0 for k in CELLS_ON_PATH) and total["K1"] == total["K3"] == 0,
            f"phase 15b launches {total}: K2, K4, K5, K6 expected, K1 and K3 not")
    return results, launches, sharded_out


LM_ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b", "starcoder2-3b", "stablelm-3b", "h2o-danube-1.8b")


def anlessini_args(args, torch, device, seed):
    """The mesh search cell's partitioned index from seeds, tiled on the
    card: even term offsets, docs in [0, n_docs] (n_docs: a pad), tf 1-4
    on live docs, lengths, idf, (k1, b, avgdl); queries over the
    vocabulary."""
    state, tids, qtf = args
    Pn, NB, B = state["block_docs"].shape
    V = state["idf"].shape[0]
    n = state["doc_len"].shape[1] - 1
    offsets = torch.from_numpy(np.linspace(0, NB, V + 1).astype(np.int32)).to(device)
    docs = tiled_on(device, seeded_block(Pn * NB * B, integer=True, seed=seed, high=n + 1),
                    (Pn, NB, B), torch.int32, torch)
    tf = tiled_on(device, seeded_block(Pn * NB * B, integer=True, seed=seed + 1) + 1,
                  (Pn, NB, B), torch.uint8, torch)
    rng = np.random.default_rng(seed + 2)
    host = {"block_max": rng.uniform(0.5, 4.0, (Pn, NB)).astype(np.float32),
            "doc_len": rng.uniform(5.0, 60.0, (Pn, n + 1)).astype(np.float32),
            "idf": rng.uniform(0.1, 5.0, V).astype(np.float32),
            "params": np.array([0.9, 0.4, 30.0], np.float32)}
    state = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    state.update(term_offsets=offsets.expand(Pn, V + 1).contiguous(), block_docs=docs,
                 block_tf=torch.where(docs < n, tf, 0).to(torch.uint8))
    Q, T = tids.shape
    return (state, torch.from_numpy(rng.integers(0, V, (Q, T)).astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(1, 3, (Q, T)).astype(np.float32)).to(device))


def sharded_expect(cell, mesh) -> dict:
    """The launches of a recsys cell's sharded function on ``mesh``, from
    its body: fm's first-order term one K6 (its pooled lookup), dcn-v2 no
    kernel (row gathers and GEMMs), bst one K5 a block; bert4rec per chunk
    of each shard's sequences its blocks' K5 and a top-k over the shard's
    vocabulary rows, then one top-k merging the (B, k·M) survivors; a
    retrieval its user tower (fm, dcn-v2: one K6; bst, bert4rec: K5 a
    block), one K4 a partition with its K2 merges, then one top-k merging
    the (1, k·data) survivors."""
    from repro_torch.kernels.dot_topk import survivors
    from repro_torch.models.recsys import bert4rec_chunk
    cfg = cell.fn.keywords["cfg"]
    L, M = mesh.size, mesh.shape["model"]
    tower = {"K6": 1} if cfg.kind in ("fm", "dcn") else {"K5": cfg.n_blocks}
    if cell.kind == "retrieval":
        N = cell.args[2].shape[0]
        n, k = N // mesh.shape["data"], min(100, N)
        k_loc = min(k, n)
        return {**tower, "K4": L, "K2": L * merge_rounds(survivors(n, k_loc), k_loc)
                + topk_launches(k_loc * mesh.shape["data"], k)}
    if cfg.kind != "bert4rec":
        return {"fm": {"K6": 1}, "dcn": {}, "bst": {"K5": cfg.n_blocks}}[cfg.kind]
    V = cfg.n_items + 2
    b = cell.args[1]["seq"].shape[0] // (L // M)
    v_loc, k = V // M, min(100, cfg.n_items)
    k_loc = min(k, v_loc)
    chunks = -(-b // min(b, bert4rec_chunk(L * v_loc, V)))
    return {"K5": cfg.n_blocks * chunks,
            "K2": chunks * topk_launches(v_loc, k_loc) + topk_launches(k_loc * M, k)}


def pooled_tol(cell, cargs, want, torch):
    """Where the sharded K6 sums a bag in another order (shard by shard,
    then the psum): the bound on |sharded − unsharded|. Two orders of an
    F-term sum differ by at most 2·(F-1)·2⁻²⁴·Σ_f|row_f| a dimension. fm's
    logit: that bound on the first-order term, plus 2⁻²² of the logit's
    terms (|bias| + Σ|w_f| + |logit|) for the two adds after it. A
    retrieval score: each user vector dimension's bound δu_d (dcn-v2's
    mean: δu_d / F and the division's rounding, 2⁻²³·|u_d|), as Σ_d
    |c_d|·δu_d, plus the two D-term dots' rounding, 2·γ_D·Σ_d|c_d|·(|u_d| +
    δu_d). Returns the bound a value (float64, on the card), or None where
    no bag is summed (the sharded run must then be bitwise)."""
    from repro_torch.models.recsys import _flat_ids
    cfg = cell.fn.keywords["cfg"]
    pooled = cfg.kind in ("fm", "dcn") and (cell.kind == "retrieval" or cfg.kind == "fm")
    if not pooled:
        return None
    params, batch = cargs[0], cargs[1]
    ids = _flat_ids(cfg, batch["sparse"]).long()
    F = ids.shape[1]
    if cell.kind == "serve":
        w = params["linear"].double()[ids][..., 0].abs().sum(1)
        return (2 * (F - 1) * UNIT * w + 4 * UNIT * (
            params["bias"].double().abs() + w + want.double().abs()))
    rows = params["emb"].double()[ids[0]]                    # (F, D)
    u, du = rows.sum(0), 2 * (F - 1) * UNIT * rows.abs().sum(0)
    if cfg.kind == "dcn":
        u, du = u / F, du / F + 2 * UNIT * (u / F).abs()
    c = cargs[2].double()[want[1].long()].abs()              # (k, D)
    D = c.shape[1]
    gamma = D * UNIT / (1 - D * UNIT)
    return c @ du + 2 * gamma * (c @ (u.abs() + du))


def shape_twin(cell, cargs, mesh):
    """The unsharded function at the sharded body's GEMM shapes: the cell's
    plain ``fn`` on its batch laid out as the partitions of ``mesh`` hold it
    (each partition's block in turn, ``StackedMesh.shard``), its outputs
    joined as the sharded function joins them. The body runs its towers
    and encoders once over all the rows the partitions hold, so a GEMM
    there sees those rows, not the batch's; this run sees the same. None
    for bert4rec's serve, whose vocabulary GEMMs are per shard."""
    cfg = cell.fn.keywords["cfg"]
    if cell.kind == "serve" and cfg.kind == "bert4rec":
        return None
    from repro_torch.parallel.compat import P
    specs = cell.in_specs[1]
    rows = {k: mesh.shard(v, specs[k]).flatten(0, 1) for k, v in cargs[1].items()}
    out = cell.fn(cargs[0], rows, *cargs[2:])
    if cell.kind == "retrieval":
        return out
    return mesh.unshard(out.view(mesh.size, -1), P(next(iter(specs.values()))[0]))


def sharded_compare(name, cell, cargs, want, got, mesh, torch) -> dict:
    """A sharded cell's outputs against the unsharded run's on the same
    inputs: shapes and dtypes equal, then one of three, each named in the
    record's ``held``:

    * ``bitwise``: every output the unsharded run's bits;
    * ``pooled-sum order bound``: where the sharded K6 sums a bag in another
      order (:func:`pooled_tol`), values within the bound and ids equal but
      where the two values lie within it;
    * ``GEMM shapes``: where a GEMM of the body sees other rows than the
      whole batch's, every output the bits of :func:`shape_twin` (the same
      function at the body's shapes); ``max_abs_err`` is then the GEMM
      shapes' effect on the values.

    ``swaps`` counts ids that differ from the unsharded run's. Returns the
    comparison; ``ok`` False says what failed."""
    wl, gl = leaves_of(want), leaves_of(got)
    if [(tuple(g.shape), g.dtype) for g in gl] != [(tuple(w.shape), w.dtype) for w in wl]:
        return dict(ok=False, why=f"shapes {[tuple(g.shape) for g in gl]} != "
                                  f"{[tuple(w.shape) for w in wl]}")
    tol = pooled_tol(cell, cargs, want, torch)
    gv, wv = gl[0], wl[0]
    r = dict(ok=True, bits=all(bits_equal(g, w) for g, w in zip(gl, wl)),
             max_abs_err=max_abs_err(gv, wv),
             swaps=int((gl[1] != wl[1]).sum()) if len(gl) == 2 else 0)
    if tol is not None:
        ratio = float(((gv.double() - wv.double()).abs() / tol).max())
        tied = len(gl) < 2 or not bool(
            ((gv.double() - wv.double()).abs() > tol)[gl[1] != wl[1]].any())
        r.update(held=f"pooled-sum order bound ({ratio:.3g} of it)", err_over_bound=ratio,
                 ok=ratio <= 1.0 and tied)
        if not r["ok"]:
            r["why"] = f"{ratio:.3g} of the pooled-sum bound; ids tie where they differ: {tied}"
    elif r["bits"]:
        r["held"] = "bitwise"
    else:
        twin = shape_twin(cell, cargs, mesh)
        same = twin is not None and all(bits_equal(g, t) for g, t in zip(gl, leaves_of(twin)))
        r.update(held="GEMM shapes: bitwise to the unsharded function at the body's shapes",
                 ok=same)
        if not same:
            r["why"] = (f"not bitwise (max |Δ| {r['max_abs_err']:.3g}), and "
                        f"{'no' if twin is None else 'not the bits of the'} same-shape run")
    return r


def sharded_cell(name, cell, cargs, want, kern, torch, device) -> tuple[dict, dict]:
    """Phase 15(d) for one recsys serve or retrieval cell, right after its
    unsharded run in (b) on the same inputs: ``cell.build`` over its stacked
    mesh (SHARDED_MESHES) on the card, its launches counted against
    :func:`sharded_expect`, its wall and peak, its outputs against the
    unsharded ones (:func:`sharded_compare`). A SHARDED_RANK_CELLS cell also
    runs on a stacked SHARDED_RANK_MESH, and the rank mesh's outputs are
    held bitwise to the run whose GEMMs see the rank's rows: that stacked
    run where the body has no GEMM (fm: gathers, K6 and a psum over 2, in
    either order the same sum), else the unsharded run (the rank holds the
    whole batch of the mesh's one data block). Returns (the record, those
    outputs on the host, each beside the stacked run's)."""
    from repro_torch.parallel.compat import StackedMesh
    t_cell = time.perf_counter()
    mesh = StackedMesh(SHARDED_MESHES[cell.shape], ("data", "model"), device=device)
    fn = cell.build(mesh)[0]
    gc.collect()
    torch.cuda.empty_cache()
    reset(kern)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = fn(*cargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = counted(kern, f"phase 15d {name}", sharded_expect(cell, mesh))
    r = sharded_compare(name, cell, cargs, want, got, mesh, torch)
    r.update(mesh=list(SHARDED_MESHES[cell.shape]), wall_ms=wall * 1e3, peak=peak,
             launches=launches)
    del got
    host = {}
    if name in SHARDED_RANK_CELLS:
        small = StackedMesh(SHARDED_RANK_MESH, ("data", "model"), device=device)
        out = leaves_of(cell.build(small)[0](*cargs))
        gemm = pooled_tol(cell, cargs, want, torch) is None
        for i, (t, w) in enumerate(zip(out, leaves_of(want))):
            host[f"{name}/{i}"] = ((w if gemm else t).cpu().numpy(), t.cpu().numpy())
        del out
    r["seconds"] = time.perf_counter() - t_cell
    print(f"[15d] {name} on a stacked {tuple(r['mesh'])} mesh: {r['wall_ms']:.1f} ms, peak "
          f"{peak} B, launches {launches}; against the unsharded run: {r.get('held')}, "
          f"max |Δ| {r['max_abs_err']:.3g}, ids swapped {r['swaps']}"
          f"{'' if r['ok'] else ' - FAILED: ' + r['why']}", flush=True)
    return r, host


def lm_seq_shards(cell, mesh) -> tuple[int, int]:
    """(sequence shards, slots a shard) of a decode cell's cache on ``mesh``."""
    from repro_torch.models.transformer import _decode_seq_axes
    n = math.prod(mesh.shape[a] for a in _decode_seq_axes(cell.in_specs[1]))
    return n, cell.args[1]["k"].shape[3] // n


def lm_extra_position(cell, mesh) -> int:
    """15(e)'s second decode position: for decode_32k the middle of the
    middle shard's slots (the shards before it full, it partial, the rest
    empty); for long_500k past the ring's wrap, in the middle of a shard
    (every shard full)."""
    n, sl = lm_seq_shards(cell, mesh)
    if cell.shape == "long_500k":
        return n * sl + (n // 2) * sl + sl // 2
    return (n // 2 - 1) * sl + sl // 2


def lm_sharded_expect(cell, mesh, pos) -> tuple[dict, dict]:
    """K5's launches in one run of a dense LM cell's sharded body, by kernel
    and by variant: a prefill one "tc" call a layer over every partition's
    heads; a decode one "split" call a layer for each partition whose
    slice of the ring holds a visible key (min(pos + 1, slots) keys from
    the first slot), none for one that holds none."""
    cfg = cell.fn.keywords["cfg"]
    L = cfg.n_layers
    if cell.kind == "prefill":
        return {"K5": L}, {"tc": L}
    n, sl = lm_seq_shards(cell, mesh)
    kv_len = min(pos + 1, n * sl)
    calls = L * (mesh.size // n) * sum(kv_len > s * sl for s in range(n))
    return {"K5": calls}, {"split": calls}


def layer_max_err(a, b) -> float:
    """max|a − b| over (layers, ...) caches, a layer at a time (no f64 copy
    of a whole cache on the card)."""
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def lm_sharded_compare(cell, mesh, got, want, rows_want=None, pos=None) -> dict:
    """A dense LM cell's sharded outputs against the unsharded ones: the
    logits within :func:`~repro_torch.models.transformer.sharded_bound`, and
    the next token's argmax equal but where the unsharded top two lie
    within it; the cache within its own bound: a prefill's whole cache, a
    decode's new k and v rows in slot ``pos % slots`` (``rows_want``, the
    unsharded step's)."""
    import torch
    from repro_torch.models.transformer import sharded_bound
    cfg = cell.fn.keywords["cfg"]
    bound = functools.partial(sharded_bound, cfg, cell.kind, mesh, cell.in_specs)
    (gl, got_cache), (wl, want_cache) = got, want
    r = dict(logits_err=max_abs_err(gl, wl), logits_bound=bound(wl))
    top2 = wl.float().topk(2, -1).values
    close = (top2[:, 0] - top2[:, 1]) <= r["logits_bound"]
    same = gl.float().argmax(-1) == wl.float().argmax(-1)
    r.update(argmax=gl.float().argmax(-1).tolist(), argmax_equal=bool(same.all()),
             argmax_tied=int((~same & close).sum()))
    cache_err, cache_bound = 0.0, 0.0
    for key in ("k", "v"):
        if cell.kind == "prefill":
            g, w = got_cache[key], want_cache[key]
        else:
            g, w = got_cache[key][:, :, :, pos % got_cache[key].shape[3]], rows_want[key]
        cache_err = max(cache_err, layer_max_err(g, w))
        cache_bound = max(cache_bound, bound(w))
    r.update(cache_err=cache_err, cache_bound=cache_bound)
    ok = r["logits_err"] <= r["logits_bound"] and bool((same | close).all()) and \
        cache_err <= cache_bound
    r.update(ok=ok)
    if not ok:
        r["why"] = (f"logits off by {r['logits_err']:.4g} (bound {r['logits_bound']:.4g}), "
                    f"argmax {r['argmax']} vs {wl.float().argmax(-1).tolist()}, cache off by "
                    f"{cache_err:.4g} (bound {cache_bound:.4g})")
    del top2
    torch.cuda.empty_cache()
    return r


def lm_k5_check(name, cell, mesh, cache, pos, kern, torch, device) -> dict:
    """K5 with ``return_lse`` at the sharded decode's shapes (phase 7c's
    :func:`k5_check`): q (b, H, 1, Dh) of seeded values against layer 0's
    slice of the ring on the last sequence shard that holds a visible key
    at ``pos``, with that shard's local kv_len."""
    from repro_torch.kernels import ref
    cfg = cell.fn.keywords["cfg"]
    n, sl = lm_seq_shards(cell, mesh)
    kv_len = min(pos + 1, n * sl)
    s = (kv_len - 1) // sl
    k, v = (cache[key][0, :, :, s * sl:(s + 1) * sl].contiguous() for key in ("k", "v"))
    g = torch.Generator(device=device).manual_seed(28)
    q = torch.randn(k.shape[0], cfg.n_heads, 1, cfg.dh, generator=g, device=device).to(k.dtype)
    r = k5_check(f"{name} at pos {pos}, sequence shard {s}'s slice", kern["K5"], ref, torch,
                 q, k, v, dict(kv_len=kv_len - s * sl), tag="15e")
    r.pop("row_tol", None)
    return r


def lm_sharded_cell(name, cell, cargs, want, kern, torch, device) -> tuple[dict, dict]:
    """Phase 15(e) for one dense LM serving cell, right after its unsharded
    run in (b) on the same inputs: ``cell.build`` over its stacked mesh
    (LM_SHARDED_MESHES) on the card, its wall, peak and K5 launches by
    variant (:func:`lm_sharded_expect`), its outputs against the unsharded
    ones (:func:`lm_sharded_compare`). A decode runs at (b)'s position (a
    decode writes its slot before it attends, so (b)'s write changes no
    input) and at :func:`lm_extra_position`, where an unsharded step on the
    same cache is the reference; its K5 is then held to its twin at the
    body's shapes (:func:`lm_k5_check`). A LM_RANK_CELLS cell also runs on
    a stacked SHARDED_RANK_MESH, which the rank mesh is held to. Returns
    (the record, that run's logits on the host beside its bound)."""
    from repro_torch.models.transformer import sharded_bound
    from repro_torch.parallel.compat import StackedMesh
    t_cell = time.perf_counter()
    mesh = StackedMesh(LM_SHARDED_MESHES[cell.shape], ("data", "model"), device=device)
    fn = cell.build(mesh)[0]
    if cell.kind == "prefill":
        runs = [(None, want)]
    else:
        runs = [(int(cargs[3]), want), (lm_extra_position(cell, mesh), None)]
    records = []
    for pos, ref_out in runs:
        args, rows = cargs, None
        if cell.kind == "decode":
            params, cache, token = cargs[:3]
            if ref_out is None:             # the unsharded step at this position
                ref_out = cell.fn(params, cache, token, torch.tensor(pos, device=device))
            slot = pos % cache["k"].shape[3]
            rows = {key: cache[key][:, :, :, slot].clone() for key in ("k", "v")}
            args = (params, cache, token, torch.tensor(pos, device=device))
        gc.collect()
        torch.cuda.empty_cache()
        reset(kern)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        at = "prefill" if pos is None else f"pos {pos}"
        expect, by = lm_sharded_expect(cell, mesh, pos)
        launches = counted(kern, f"phase 15e {name} {at}", expect)
        variants = k5_variants(kern, f"phase 15e {name} {at}", by)
        r = lm_sharded_compare(cell, mesh, got, ref_out, rows, pos)
        r.update(at=at, wall_ms=wall * 1e3, peak=peak, launches=launches, k5_by=variants)
        records.append(r)
        print(f"[15e] {name} {at} on a stacked {LM_SHARDED_MESHES[cell.shape]} mesh: "
              f"{r['wall_ms']:.1f} ms, peak {peak} B, K5 {variants} (the body's count); "
              f"logits max |Δ| {r['logits_err']:.4g} against the unsharded run (bound "
              f"{r['logits_bound']:.4g}), argmax {r['argmax']} "
              f"{'equal' if r['argmax_equal'] else 'within the bound of a tie'}; "
              f"{'cache' if pos is None else 'new k/v rows'} max |Δ| {r['cache_err']:.4g} "
              f"(bound {r['cache_bound']:.4g}){'' if r['ok'] else ' - FAILED: ' + r['why']}",
              flush=True)
        del got, ref_out, rows
    k5 = None
    if cell.kind == "decode":
        k5 = lm_k5_check(name, cell, mesh, cargs[1], runs[-1][0], kern, torch, device)
    host = {}
    if name in LM_RANK_CELLS:
        small = StackedMesh(SHARDED_RANK_MESH, ("data", "model"), device=device)
        logits = cell.build(small)[0](*cargs)[0]
        tol = sharded_bound(cell.fn.keywords["cfg"], cell.kind, small, cell.in_specs, logits)
        host[f"{name}/0"] = (logits.float().cpu().numpy(),) * 2 + (tol,)
        del logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(mesh=list(LM_SHARDED_MESHES[cell.shape]), runs=records, k5=k5,
                seconds=time.perf_counter() - t_cell), host


class ServingRanks:
    """Phase 15(d)'s rank mesh: CELLS_RANKS processes of :func:`serving_rank`,
    started with (b) and running beside it; :meth:`check` waits for them and
    holds each rank's outputs to the stacked SHARDED_RANK_MESH run's, bit for
    bit."""

    def __init__(self, seed: int, device="cuda", reduced: bool = False):
        import tempfile

        import torch.multiprocessing as mp
        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serving_")
        self.t0 = time.perf_counter()
        self.procs = mp.start_processes(serving_rank,
                                        args=(CELLS_RANKS, self.tmp.name, seed, str(device),
                                              reduced),
                                        nprocs=CELLS_RANKS, join=False, start_method="spawn")

    def stop(self) -> None:
        """End the rank processes that are still running."""
        for proc in self.procs.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()

    def check(self, host: dict) -> dict:
        """Wait for the ranks; each output bitwise to ``host``'s reference
        run (the first of each pair), beside the stacked run's (the second:
        its largest difference printed). An entry with a third member, a
        bound (the LM_RANK_CELLS' logits), is held within it of the stacked
        run, and whether it came out bitwise is printed."""
        try:
            while not self.procs.join():
                pass
        finally:
            self.stop()
        wall = time.perf_counter() - self.t0
        outs = [dict(np.load(Path(self.tmp.name) / f"serving_rank{r}.npz"))
                for r in range(CELLS_RANKS)]
        self.tmp.cleanup()
        rank_s = [float(out.pop("seconds")) for out in outs]

        def bits(a):
            return a.view(np.uint32) if a.dtype == np.float32 else a
        differ, to_stacked, lm_bits = {}, {}, {}
        for r, out in enumerate(outs):
            require(sorted(out) == sorted(host), f"rank {r}: outputs {sorted(out)}")
            for key, (want, stacked, *tol) in host.items():
                got = out[key]
                same = got.shape == want.shape and np.array_equal(bits(got), bits(want))
                err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
                if tol:
                    lm_bits[key] = lm_bits.get(key, True) and same
                if not same and (not tol or err > tol[0]):
                    differ[f"rank {r} {key}"] = err
                to_stacked[key] = max(to_stacked.get(key, 0.0), float(np.abs(
                    got.astype(np.float64) - stacked.astype(np.float64)).max()))
        require(not differ, f"phase 15d/e: the rank mesh != the run with its GEMM shapes "
                            f"(15d) or off the stacked run by more than the bound (15e): "
                            f"{differ}")
        print(f"[15d] {SHARDED_RANK_CELLS} over a {SHARDED_RANK_MESH} rank mesh of "
              f"{CELLS_RANKS} gloo processes on the card (each holding half of the tables): "
              f"bit for bit, on every rank, the stacked {SHARDED_RANK_MESH} run where the body "
              f"has no GEMM (fm), else the unsharded run (the same GEMM rows); max |Δ| to the "
              f"stacked run {to_stacked}; each rank {max(rank_s):.1f} s at most in its process, "
              f"beside (b), joined {wall:.1f} s from their start", flush=True)
        print(f"[15e] {LM_RANK_CELLS} over the same rank mesh (each rank holding half of the "
              f"heads, the vocabulary and the ring): logits within the sharded bound of the "
              f"stacked {SHARDED_RANK_MESH} run on every rank, bit for bit: {lm_bits}",
              flush=True)
        return dict(cells=list(SHARDED_RANK_CELLS), mesh=list(SHARDED_RANK_MESH),
                    ranks=CELLS_RANKS, rank_s=rank_s, joined_s=wall, bitwise=True,
                    max_abs_to_stacked=to_stacked, lm_cells=list(LM_RANK_CELLS),
                    lm_bitwise=lm_bits)


def serving_rank(rank: int, world: int, tmp: str, seed: int, device: str = "cuda",
                 reduced: bool = False) -> None:
    """One rank of phase 15(d)'s rank mesh: a gloo process group over a
    FileStore in ``tmp``, a SHARDED_RANK_MESH rank mesh on the card, and
    SHARDED_RANK_CELLS' sharded functions on (b)'s seeded inputs (each
    arch's parameters made at its first cell, as (b) makes them), each
    rank holding its half of the tables, then LM_RANK_CELLS' (the
    parameters made at the arch's prefill cell, as (b) makes them; the
    decode at (b)'s position); the outputs to ``tmp/serving_rank<r>.npz``. ``reduced`` (the configs' reduced cells)
    rehearses it on the CPU."""
    import datetime

    import torch
    import torch.distributed as dist
    from repro_torch.configs import build_cells
    from repro_torch.parallel.compat import RankMesh
    t0 = time.perf_counter()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "serving_store"),
                                                         world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = RankMesh(SHARDED_RANK_MESH, ("data", "model"), device=device)
        out = {}
        for arch in RECSYS_ARCHS:
            held: dict = {}
            cells = build_cells(arch, reduced=reduced)
            for name in [n for n in SHARDED_RANK_CELLS if n.split("/")[0] == arch]:
                cell = cells[name.split("/")[1]]
                cargs = cell_args(cell, cell.args, torch, device, seed, held)
                res = cell.build(mesh)[0](*cargs)
                out.update({f"{name}/{i}": t.cpu().numpy() for i, t in enumerate(leaves_of(res))})
                del cargs, res
            held.clear()
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        for name in LM_RANK_CELLS:
            arch, shape = name.split("/")
            cells, held = build_cells(arch, reduced=reduced), {}
            first = cells["prefill_32k"]
            cell_args(first, lm_cut(first, CELLS_LM_BATCH), torch, device, seed, held)
            cell = cells[shape]
            cargs = cell_args(cell, lm_cut(cell, CELLS_LM_BATCH), torch, device, seed, held)
            out[f"{name}/0"] = cell.build(mesh)[0](*cargs)[0].float().cpu().numpy()
            del cargs, held
        np.savez(Path(tmp) / f"serving_rank{rank}.npz", **out,
                 seconds=np.float64(time.perf_counter() - t0))
    finally:
        dist.destroy_process_group()


def launcher_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 15c's rank mesh: a gloo process group over a
    FileStore in ``tmp``, then ``launch.train`` with CELLS_LAUNCHER on
    ``--mesh host`` — a (world, 1) rank mesh on the card (the sharded step:
    the gradient and metrics averaged over ``data`` by gloo, the clip over
    the whole reduced gradient, AdamW on the rank's blocks)."""
    import datetime
    import io

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(tmp) / "store"), world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = train.main(CELLS_LAUNCHER + ["--mesh", "host", "--ckpt-dir",
                                              str(Path(tmp) / "ranks"), "--metrics-out",
                                              str(Path(tmp) / f"rank{rank}.json")])
        require(rc == 0, f"launch.train on rank {rank}: rc {rc}")
    finally:
        dist.destroy_process_group()


def launcher_ranks(tmp):
    """Phase 15c's CELLS_RANKS processes, started with phase 15 so that they
    run beside (b) (their start-up is most of their time; the card and the
    host are shared). Returns their start time and their context."""
    import torch.multiprocessing as mp
    return time.perf_counter(), mp.start_processes(
        launcher_rank, args=(CELLS_RANKS, str(tmp)), nprocs=CELLS_RANKS, join=False,
        start_method="spawn")


def stop_ranks(ranks) -> None:
    for proc in ranks.processes:
        if proc.is_alive():
            proc.terminate()
            proc.join()


def launcher_meshes(torch, tmp, started) -> dict:
    """Phase 15c: ``launch.train`` with CELLS_LAUNCHER on ``--mesh prod``
    (the (16, 16) production mesh stacked on the card: the host step once
    the batch and state split over it) and ``--mesh host``: the same loss
    bits, step for step; then ``--mesh host`` in CELLS_RANKS processes of
    a gloo group (``started``, from :func:`launcher_ranks`), each on the
    card (the rank mesh's sharded step), against the host step: each
    step's loss within 1e-4 and grad norm within 1e-4 of itself (gloo sums
    the ranks' gradients in its own order)."""
    import io

    from repro_torch.launch import train
    history, walls = {}, {}
    t_ranks, ranks = started
    try:
        for mesh in ("prod", "host"):
            out = tmp / f"launcher_{mesh}.json"
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = train.main(CELLS_LAUNCHER + ["--mesh", mesh, "--ckpt-dir",
                                                  str(tmp / mesh), "--metrics-out", str(out)])
            walls[mesh] = time.perf_counter() - t0
            require(rc == 0, f"launch.train --mesh {mesh}: rc {rc}")
            history[mesh] = json.loads(out.read_text())["history"]
        while not ranks.join():
            pass
    finally:
        stop_ranks(ranks)
    walls["ranks"] = time.perf_counter() - t_ranks
    losses = {mesh: [h["loss"] for h in hist] for mesh, hist in history.items()}
    require(losses["prod"] == losses["host"], f"--mesh prod losses {losses['prod']} != --mesh "
                                              f"host {losses['host']}")
    print(f"[15c] python -m repro_torch.launch.train {' '.join(CELLS_LAUNCHER)}: --mesh prod "
          f"(16 x 16 stacked) == --mesh host, {len(losses['host'])} losses bit for bit "
          f"({losses['host'][0]:.6f} -> {losses['host'][-1]:.6f}); {walls['prod']:.1f} s and "
          f"{walls['host']:.1f} s", flush=True)
    loss_err = norm_err = 0.0
    for r in range(CELLS_RANKS):
        got = json.loads((tmp / f"rank{r}.json").read_text())["history"]
        require(len(got) == len(history["host"]), f"rank {r}: {len(got)} steps")
        for a, b in zip(got, history["host"]):
            loss_err = max(loss_err, abs(a["loss"] - b["loss"]))
            norm_err = max(norm_err, abs(a["grad_norm"] / b["grad_norm"] - 1))
    require(loss_err <= 1e-4 and norm_err <= 1e-4,
            f"--mesh host over {CELLS_RANKS} ranks: loss off by {loss_err}, grad norm by "
            f"{norm_err} of itself (bounds 1e-4)")
    print(f"[15c] --mesh host over {CELLS_RANKS} gloo ranks on the card (a ({CELLS_RANKS}, 1) "
          f"rank mesh) == the host step to {loss_err:.3g} in the loss and {norm_err:.3g} of the "
          f"grad norm (bounds 1e-4), {len(history['host'])} steps, grad norm "
          f"{history['host'][0]['grad_norm']:.4f} at the first (clip 1.0); "
          f"{walls['ranks']:.1f} s from their start, beside (b) and the two stacked runs",
          flush=True)
    return dict(losses=losses["host"], walls_s=walls, ranks=CELLS_RANKS,
                ranks_loss_err=loss_err, ranks_norm_rel_err=norm_err)


def cells_phase(kern, torch, device="cuda", seed=0) -> tuple[dict, dict]:
    """Phase 15: (a) the dry run of every full cell on both production
    meshes, in worker processes while (b) runs the cells that fit on the
    card, (c) the launcher's production mesh against its host mesh, and
    its host mesh over a group of ranks against the host step."""
    import os
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dry = DryRun(jobs=max(1, min(CELLS_JOBS, (os.cpu_count() or 2) - 1)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cells_") as tmp:
        started = launcher_ranks(Path(tmp))     # (c)'s ranks, beside (b)
        try:
            results, launches, sharded = cells_on_card(dry, kern, torch, device, seed)
        except BaseException:
            stop_ranks(started[1])
            raise
        t_b = time.perf_counter() - t_phase
        t_c = time.perf_counter()
        reset(kern)
        launcher = launcher_meshes(torch, Path(tmp), started)
        launches["phase 15 launcher"] = counted(kern, "phase 15 launcher", {})
        t_c = time.perf_counter() - t_c
    _, summary = dry.result()
    summary.update(cards_s=t_b, launcher_s=t_c)
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[15] phase 15 took {seconds:.1f} s (dry run {summary['wall_s']:.1f} beside the "
          f"cells on the card {t_b:.1f}, launcher {t_c:.1f})", flush=True)
    return dict(dry_run=summary, cells=results, sharded=sharded, launcher=launcher,
                seconds=seconds), launches


# -- phase 16: the examples on the card -------------------------------------------------

EXAMPLES = {                   # python -m repro_torch.examples.<name> <argv>, on the card
    "quickstart": [],
    "partitioned_search": [],
    "serve_msmarco": ["--docs", "50000", "--queries", "400", "--qps", "25.0"],
    "train_lm": [],
}
NEAR_TIE = 1e-6                # oracle scores this close (relative) may rank either way


def run_example(name: str, kern, torch) -> tuple[list, dict, float]:
    """``python -m repro_torch.examples.<name>`` with ``EXAMPLES[name]`` in
    this process (``runpy``, as ``__main__``: the kernels built in phase 2
    and their counters serve it), in a temporary directory of its own that
    ``tempfile`` hands out while it runs. Its output is echoed; any exception
    propagates. Returns its lines, peak memory and wall."""
    import io
    import runpy
    import tempfile
    module = f"repro_torch.examples.{name}"
    buf = io.StringIO()
    saved = sys.argv, tempfile.tempdir
    reset(kern)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
            sys.argv, tempfile.tempdir = [module, *EXAMPLES[name]], tmp
            try:
                with contextlib.redirect_stdout(buf):
                    runpy.run_module(module, run_name="__main__")
            except SystemExit as e:
                require(e.code == 0, f"{name}: exit code {e.code}")
            else:
                raise RuntimeError(f"{name}: did not exit through SystemExit(main())")
            finally:
                sys.argv, tempfile.tempdir = saved
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0         # before the directory's removal
    finally:
        for line in buf.getvalue().splitlines():
            print(f"[16] {name}: {line}", flush=True)
    mem = {"max_memory_allocated": torch.cuda.max_memory_allocated()}
    return buf.getvalue().splitlines(), mem, wall


def same_top(got: list, ranked: list, k: int) -> bool:
    """``got``'s first k ids are the oracle's (``ranked``: (id as printed,
    score), k + 1 deep), up to order among scores within ``NEAR_TIE`` of
    each other (the card sums in f32, the oracle in f64)."""
    if len(got) < k or len(set(got[:k])) < k:
        return False
    for j, g in enumerate(got[:k]):
        s = ranked[j][1]
        if g not in {d for d, v in ranked if abs(v - s) <= NEAR_TIE * max(1.0, abs(s))}:
            return False
    return True


def check_quickstart(lines: list) -> dict:
    """Five answers, the first cold and the rest warm, each query's top 3 the
    oracle's on the host."""
    from repro_torch.examples import quickstart
    from repro_torch.search.oracle import OracleSearcher
    docs, queries = quickstart.corpus_and_queries()
    oracle = OracleSearcher(docs)
    answers = [ln for ln in lines if ln.startswith("q") and "] '" in ln]
    require(len(answers) == len(queries) == 5, f"quickstart: {len(answers)} answer lines")
    kinds = [ln.split("[", 1)[1].split()[0] for ln in answers]
    require(kinds == ["cold"] + ["warm"] * 4, f"quickstart: kinds {kinds}")
    for q, ln in zip(queries, answers):
        got = [hit.split(":")[0] for hit in ln.split(" → ", 1)[1].split(", ")]
        require(same_top(got, [(str(i), v) for i, v in oracle.search(q, k=4)], 3),
                f"quickstart: {got} != the oracle's top 3 for {q!r}")
    return {"cold": kinds.count("cold"), "warm": kinds.count("warm")}


def mesh_k2_launches() -> int:
    """K2's launches in partitioned_search's mesh half, as the body implies:
    a local top-k over the partition's documents a chunk of
    ``partitions_per_call`` partitions, then one merge of the gathered row."""
    from repro_torch.examples import partitioned_search as ps
    from repro_torch.search.distributed import (DistSearchConfig, partition_corpus,
                                                partitions_per_call)
    docs, queries = ps.corpus_and_queries()
    parts = ps.MESH_SHAPE[0] * ps.MESH_SHAPE[1]
    cfg = DistSearchConfig(n_parts=parts, n_docs_local=partition_corpus(docs, parts)[1],
                           n_blocks_local=0, vocab=0, **ps.MESH_CFG)
    chunks = -(-parts // partitions_per_call(cfg, len(queries), cfg.max_terms))
    return chunks * topk_launches(cfg.n_docs_local, cfg.k) + topk_launches(parts * cfg.k, cfg.k)


def mesh_k2_cases(kern, ref, torch, device="cuda") -> dict:
    """K2 against its twin, bitwise, at the shapes that partitioned_search's
    mesh half gives it, on the example's state rebuilt on the card: the
    stacked body's local rows (one scoring call's partitions) and the merge
    of the gathered row. The twin's top-k of those local rows must be the
    body's survivors, and its merge of that gathered row the search's whole
    top-k, ids and score bits."""
    import functools

    from repro_torch.examples import partitioned_search as ps
    from repro_torch.parallel import compat
    from repro_torch.parallel.compat import P
    from repro_torch.search import bm25
    from repro_torch.search import distributed as dist
    docs, queries = ps.corpus_and_queries()
    parts = ps.MESH_SHAPE[0] * ps.MESH_SHAPE[1]
    state, cfg, vocab = dist.build_partitioned_state(docs, parts, ps.MESH_CFG, device=device)
    mesh = compat.make_mesh(ps.MESH_SHAPE, MESH_AXES, device=device)
    tids, qtf = bm25.encode_queries(vocab, queries, max_terms=cfg.max_terms,
                                    idf=state["idf"].cpu().numpy())
    tids, qtf = (torch.as_tensor(x, device=device) for x in (tids, qtf))
    Q, k = len(queries), cfg.k
    body = functools.partial(dist._local_search, cfg=cfg, axes=MESH_AXES)
    specs = (dist.dist_state_specs(MESH_AXES), P(None, None), P(None, None))
    gathered = P(None, dist.gather_axes(MESH_AXES, cfg.fused_gather))
    with compat.use_mesh(mesh):
        s, i = dist.make_dist_search_fn(cfg, MESH_AXES, mesh=mesh)(state, tids, qtf)
        lv, _ = compat.shard_map(body, mesh, in_specs=specs,
                                 out_specs=(P(MESH_AXES), P(MESH_AXES)))(state, tids, qtf)
        gv, gi = compat.shard_map(body, mesh, in_specs=specs,
                                  out_specs=(gathered, gathered))(state, tids, qtf)
    per = min(parts, dist.partitions_per_call(cfg, Q, cfg.max_terms))
    local = dist.stacked_search_state(
        {key: state[key][:per] for key in ("term_offsets", "block_docs", "block_tf",
                                           "block_max", "doc_len")},
        state["idf"], state["params"], cfg)
    scores = bm25.score_dense(local, tids.repeat(per, 1), qtf.repeat(per, 1),
                              max_blocks=cfg.max_blocks).contiguous()
    require(bits_equal(ref.topk_ref(scores, k)[0], lv.view(parts, Q, k)[:per].reshape(-1, k)),
            "partitioned_search mesh: the twin's top-k of the local rows != the body's")
    tv, tp = ref.topk_ref(gv.contiguous(), k)
    require(bits_equal(tv, s) and bits_equal(torch.gather(gi, 1, tp.long()), i),
            "partitioned_search mesh: the twin's merge != the search's top-k")
    cases = {"local top-k": k2_case(kern["K2"], ref, torch, scores, k,
                                    "partitioned_search mesh local top-k"),
             "merge": k2_case(kern["K2"], ref, torch, gv.contiguous(), k,
                              "partitioned_search mesh merge")}
    for name, r in cases.items():
        print_case("16", f"K2 on partitioned_search's mesh {name}", r)
    return {name: case_entry(r) for name, r in cases.items()}


def check_partitioned(lines: list) -> dict:
    """Every top 3 == the oracle (the example's own marks), the batch in 4
    invocations, 5 backup legs in the hedged half, 5 mesh answers."""
    text = "\n".join(lines)
    require("!=" not in text, "partitioned_search: a top 3 != the oracle")
    require("batch Q=5: 4 invocations" in text and "5/5 top3 == oracle" in text,
            "partitioned_search: the batch line")
    require("(5 backup legs)" in text, "partitioned_search: backup legs")
    mesh = next(i for i, ln in enumerate(lines) if ln.startswith("== mesh-level"))
    require("(4 partitions)" in lines[mesh], f"partitioned_search: {lines[mesh]}")
    n_mesh = sum("top3 == oracle (" in ln for ln in lines[mesh + 1:])
    require(n_mesh == 5, f"partitioned_search: {n_mesh} mesh answers == the oracle")
    return {"mesh_answers_equal_oracle": n_mesh}


def check_serve_msmarco(lines: list) -> dict:
    """Every replayed response ok (the example raises otherwise), the first
    query on v2 ok, the fungibility line; the scorecard's numbers."""
    text = "\n".join(lines)
    require("first query on v2: ok (version v2)" in text, "serve_msmarco: the v2 query")
    require("$1.00 ≡ 100 QPS×1,000 s = $1.00" in text, "serve_msmarco: fungibility")
    warm = re.search(r"warm queries: (\d+)\s+p50\s+([\d.]+) ms\s+p99\s+([\d.]+) ms", text)
    cold = re.search(r"cold queries: (\d+)", text)
    fleet = re.search(r"fleet peak size: (\d+) instances; hedged: (\d+)", text)
    cost = re.search(r"for (\d+) queries → ([\d,]+) q/\$", text)
    wall = re.search(r"real wall time: ([\d.]+)s", text)
    require(all((warm, fleet, cost, wall)), "serve_msmarco: the scorecard")
    n_cold = int(cold[1]) if cold else 0
    argv = EXAMPLES["serve_msmarco"]
    replayed = int(argv[argv.index("--queries") + 1])
    require(int(warm[1]) + n_cold == replayed, f"serve_msmarco: warm + cold != {replayed}")
    return {"warm": int(warm[1]), "warm_p50_ms": float(warm[2]), "warm_p99_ms": float(warm[3]),
            "cold": n_cold, "fleet_peak": int(fleet[1]), "hedged": int(fleet[2]),
            "invocations": int(cost[1]), "q_per_dollar": int(cost[2].replace(",", "")),
            "replay_wall_s": float(wall[1])}


def train_lm_steps_lost(argv: list) -> int:
    """The steps that train_lm at ``argv`` loses to its one injected failure,
    by the launcher's rules: a checkpoint after every step that
    ``--ckpt-every`` divides, a failure just before its step runs, and the
    restart from the last checkpoint before it (none: from scratch)."""
    from repro_torch.examples import train_lm
    args = train_lm.parser().parse_args(argv)
    handed = train_lm.launcher_argv(args)
    every = int(handed[handed.index("--ckpt-every") + 1])
    require(len(args.fail_at) == 1 and args.fail_at[0] < args.steps,
            f"train_lm: one failure within the run, not {args.fail_at}")
    fail = args.fail_at[0]
    restored = max((s for s in range(fail) if s % every == 0), default=-1)
    return fail - restored - 1


def check_train_lm(lines: list) -> dict:
    """One restart, the steps lost that the launcher's checkpoint rule
    implies, the loss falling; the step times the example printed."""
    text = "\n".join(lines)
    lost = train_lm_steps_lost(EXAMPLES["train_lm"])
    done = re.search(r"done: (\d+) steps in ([\d.]+)s; restarts=(\d+) steps_lost=(\d+)", text)
    loss = re.search(r"first10=([\d.]+) last10=([\d.]+)", text)
    require(done and loss, "train_lm: the done and loss lines")
    require(int(done[3]) == 1 and int(done[4]) == lost,
            f"train_lm: restarts={done[3]} steps_lost={done[4]}, expected 1 and {lost}")
    require(float(loss[2]) < float(loss[1]), f"train_lm: last10 {loss[2]} >= first10 {loss[1]}")
    step_ms = [int(ms) for ms in re.findall(r"\((\d+) ms/step\)", text)]
    return {"steps": int(done[1]), "run_s": float(done[2]), "restarts": int(done[3]),
            "steps_lost": int(done[4]), "first10": float(loss[1]), "last10": float(loss[2]),
            "logged_step_ms": step_ms}


def examples_phase(kern, ref, torch) -> tuple[dict, dict]:
    """Phase 16: the four examples, ``python -m repro_torch.examples.<name>``
    on the card at ``EXAMPLES``' argv, each in a fresh temporary directory,
    the launch counters set to 0 before each and checked after it (K2 alone,
    in partitioned_search's mesh half; no other kernel in any), then each
    one's output checked."""
    t_phase = time.perf_counter()
    checks = {"quickstart": check_quickstart, "partitioned_search": check_partitioned,
              "serve_msmarco": check_serve_msmarco, "train_lm": check_train_lm}
    out, launches = {}, {}
    for name in EXAMPLES:
        gc.collect()
        torch.cuda.empty_cache()
        lines, mem, wall = run_example(name, kern, torch)
        route = f"examples:{name}"     # (the expectation imports the example: after its run)
        launches[route] = counted(kern, route, {"K2": mesh_k2_launches()}
                                  if name == "partitioned_search" else {})
        out[name] = {"wall_s": wall, "launches": {k: c for k, c in launches[route].items() if c},
                     **mem, **checks[name](lines)}
        if name == "partitioned_search":
            out[name]["k2"] = mesh_k2_cases(kern, ref, torch)
        print(f"[16] {' '.join([name, *EXAMPLES[name]])}: {wall:.1f} s, launches "
              f"{out[name]['launches'] or 'none'}, max_memory_allocated "
              f"{mem['max_memory_allocated']} B; {json.dumps(out[name])}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[16] phase 16 took {out['seconds']:.1f} s", flush=True)
    return out, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=50_000,
                    help="passages of phases 3-6's corpus (the single node and the fleet)")
    ap.add_argument("--lm-only", action="store_true",
                    help="phases 1, 2 and 7 only (a shake-out of the LM path; prints no "
                         "ok line)")
    ap.add_argument("--topk-only", action="store_true",
                    help="phases 1, 2 and K2 and K4 at the main path's shapes on seeded data "
                         "(prints no ok line)")
    ap.add_argument("--k1-k6-only", action="store_true",
                    help="phases 1, 2 and K1 and K6 at the main path's shapes on seeded data "
                         "(prints no ok line)")
    ap.add_argument("--k3-only", action="store_true",
                    help="phases 1, 2 and K3's two entry points at the main path's shapes on "
                         "seeded data (prints no ok line)")
    ap.add_argument("--recsys-only", action="store_true",
                    help="phases 1, 2 and 8 only (a shake-out of the recsys path; prints no "
                         "ok line)")
    ap.add_argument("--structured-only", action="store_true",
                    help="phases 1, 2 and 9 only (a shake-out of the structured tier and the "
                         "write path; prints no ok line)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 10 only (a shake-out of the mesh path; prints no ok "
                         "line)")
    ap.add_argument("--serve-only", action="store_true",
                    help="phases 1, 2 and 11 only (a shake-out of the serve launcher and the "
                         "baseline; prints no ok line)")
    ap.add_argument("--moe-only", action="store_true",
                    help="phases 1, 2, 12 and 13 only (a shake-out of the MoE and MLA LMs; "
                         "prints no ok line)")
    ap.add_argument("--train-only", action="store_true",
                    help="phases 1, 2 and 14 only (a shake-out of the training path; prints no "
                         "ok line)")
    ap.add_argument("--simt-only", action="store_true",
                    help="phases 1, 2 and K5's f32 kernel alone at the main path's shapes on "
                         "seeded data (prints no ok line)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the first numpy seed of phase 15's cell inputs (each leaf draws the "
                         "next)")
    ap.add_argument("--cells-only", action="store_true",
                    help="phases 1, 2 and 15 only (a shake-out of the dry run, the cells on the "
                         "card and the launcher's production mesh; prints no ok line)")
    ap.add_argument("--examples-only", action="store_true",
                    help="phases 1, 2 and 16 only (the four examples on the card; prints no "
                         "ok line)")
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
        from repro_torch.kernels.bm25_block import bm25_block_impacts
        from repro_torch.kernels.bm25_pruned import bm25_pruned_topk
        from repro_torch.kernels.dot_topk import dot_topk_batch
        from repro_torch.kernels.embedding_bag import embedding_bag
        from repro_torch.kernels.flash_attention import flash_attention
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
    kern = {"K3": bm25_block_impacts, "K2": topk, "K1": bm25_pruned_topk, "K4": dot_topk_batch,
            "K5": flash_attention, "K6": embedding_bag}
    t_start = time.perf_counter()

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
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[2] {name}: {line.strip()}", flush=True)

    if args.lm_only:
        serve, k5, lm_launches = lm_phase(kern, ref, torch)
        print(json.dumps({"kernels": [k5_line(serve, k5, lm_launches)]}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --lm-only, a partial run", flush=True)
        return 0
    if args.simt_only:
        t0 = time.perf_counter()
        cases = simt_phase(kern, ref, torch)
        print(f"[s] K5's f32 kernel checked and timed in {time.perf_counter() - t0:.1f} s",
              flush=True)
        print(json.dumps({"simt_only": {label: simt_entry(r) for label, r in cases.items()}}),
              flush=True)
        print(smi, flush=True)
        print("chip_smoke: --simt-only, a partial run", flush=True)
        return 0
    if args.topk_only:
        t0 = time.perf_counter()
        cases = topk_phase(kern, ref, torch)
        print(f"[t] K2 and K4 checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"topk_only": {name: case_entry(r) for name, r in cases.items()}}),
              flush=True)
        print(smi, flush=True)
        print("chip_smoke: --topk-only, a partial run", flush=True)
        return 0
    if args.k1_k6_only:
        t0 = time.perf_counter()
        cases = k1_k6_phase(kern, ref, torch)
        print(f"[k] K1 and K6 checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"k1_k6_only": {name: {**case_entry(r), **{
            key: r[key] for key in ("twin_turns", "split_us") if key in r}}
            for name, r in cases.items()}}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --k1-k6-only, a partial run", flush=True)
        return 0
    if args.k3_only:
        t0 = time.perf_counter()
        cases = k3_phase(kern, ref, torch)
        print(f"[3] K3 checked and timed in {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"k3_only": {name: {**case_entry(r), "eager_chain_turns": r[
            "turns_with_chain"], "eager_chain_graph_ms": r["eager_chain_graph_ms"],
            "bm25_block_scores": case_entry(r["scores"])}
            for name, r in cases.items()}}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --k3-only, a partial run", flush=True)
        return 0
    if args.recsys_only:
        results, rs_launches, err = recsys_phase(kern, ref, torch)
        print(json.dumps({"kernels": [k6_line(results, rs_launches, err),
                                      simt_line(None, results, rs_launches)]}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --recsys-only, a partial run", flush=True)
        return 0
    if args.structured_only:
        st_launches, split = structured_phase(kern, torch)
        print(json.dumps({"structured_only": {"launches_by_route": st_launches,
                                              "device_us": split}}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --structured-only, a partial run", flush=True)
        return 0
    if args.mesh_only:
        mesh_launches, mesh_cases, walls = mesh_phase(kern, ref, torch)
        print(json.dumps({"mesh_only": {"launches_by_route": mesh_launches, "walls_ms": walls,
                                        "k2": {name: case_entry(r)
                                               for name, r in mesh_cases.items()}}}),
              flush=True)
        print(smi, flush=True)
        print("chip_smoke: --mesh-only, a partial run", flush=True)
        return 0
    if args.serve_only:
        serve_launches, serve_out = serve_phase(kern, torch)
        print(json.dumps({"serve_only": {"launches_by_route": serve_launches, **serve_out}}),
              flush=True)
        print(smi, flush=True)
        print("chip_smoke: --serve-only, a partial run", flush=True)
        return 0
    if args.train_only:
        training, _ = train_phase(kern, torch)
        print(json.dumps({"training": training}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --train-only, a partial run", flush=True)
        return 0
    if args.cells_only:
        cells_out, _ = cells_phase(kern, torch, seed=args.seed)
        print(json.dumps({"cells": cells_out}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --cells-only, a partial run", flush=True)
        return 0
    if args.moe_only:
        moe = {name: moe_phase(kern, ref, torch, name) for name in MOE_RUNS}
        print(json.dumps({"moe_only": {name: moe_entry(r) for name, r in moe.items()}}),
              flush=True)
        print(smi, flush=True)
        print("chip_smoke: --moe-only, a partial run", flush=True)
        return 0

    if args.examples_only:
        examples, _ = examples_phase(kern, ref, torch)
        print(json.dumps({"examples": examples}), flush=True)
        print(smi, flush=True)
        print("chip_smoke: --examples-only, a partial run", flush=True)
        return 0

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
    k1_wide = k1_wide_check(kern, ref, torch)
    latency_phase(searcher, queries, torch, {
        "pruned+kernels": pruned_cfg,
        "dense+kernels": SearchConfig(use_kernel=True, use_topk_kernel=True),
        "dense plain": SearchConfig()}, kern)
    del searcher
    torch.cuda.empty_cache()

    # 5. the main path through the gateway
    torch.cuda.reset_peak_memory_stats()
    launches = gateway_phase(app, queries, torch, kern)
    print(f"[5] max_memory_allocated {torch.cuda.max_memory_allocated()} B; phases 1-5 took "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 6. the partitioned fleet with its dense tier, on the same corpus
    k4, fleet_launches, sizes = fleet_phase(docs, queries, app, torch, ref, kern)
    launches.update({f"fleet:{mode}": c for mode, c in fleet_launches.items()})
    print(f"[6] phases 1-6 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 7. LM serving at full width on K5, with the search apps released
    del app, docs
    gc.collect()
    torch.cuda.empty_cache()
    serve, k5, lm_launches = lm_phase(kern, ref, torch)
    launches.update(lm_launches)
    print(f"[7] phases 1-7 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 8. recsys serving at full width on K6 (K5, K4, K2 beside it)
    gc.collect()
    torch.cuda.empty_cache()
    results, rs_launches, k6_err = recsys_phase(kern, ref, torch)
    launches.update(rs_launches)
    print(f"[8] phases 1-8 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 9. the structured tier and the write path against oracles
    gc.collect()
    torch.cuda.empty_cache()
    st_launches, split = structured_phase(kern, torch)
    launches.update({f"phase 9 {route}": c for route, c in st_launches.items()})
    print(f"[9] phases 1-9 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 10. the paper's §3 mesh path at the anlessini geometry, stacked on the card
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh_cases, mesh_walls = mesh_phase(kern, ref, torch)
    launches.update(mesh_launches)
    print(f"[10] phases 1-10 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 11. the serve launcher (--kernel: K3) and the Crane & Lin baseline (B2)
    gc.collect()
    torch.cuda.empty_cache()
    serve_launches, serve_out = serve_phase(kern, torch)
    launches.update(serve_launches)
    print(f"[11] phases 1-11 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 12, 13. olmoe-1b-7b and deepseek-v2-236b (4 layers) at full width, EP as shipped
    gc.collect()
    torch.cuda.empty_cache()
    moe = {}
    for name in MOE_RUNS:
        moe[name] = moe_phase(kern, ref, torch, name)
        launches.update(moe[name]["launches"])
        print(f"[{MOE_RUNS[name]['tag']}] phases 1-{MOE_RUNS[name]['tag']} took "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    # 14. training: graphcast, h2o-danube-1.8b, the launcher, recsys (no hand kernel)
    training, train_launches = train_phase(kern, torch)
    launches.update(train_launches)
    print(json.dumps({"training": training}), flush=True)
    print(f"[14] phases 1-14 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 15. the cells: the dry run on both production meshes beside the cells
    # that fit on the card, then the launcher's production mesh
    cells_out, cell_launches = cells_phase(kern, torch, seed=args.seed)
    launches.update(cell_launches)
    print(json.dumps({"cells": cells_out}), flush=True)
    print(f"[15] phases 1-15 took {time.perf_counter() - t_start:.1f} s", flush=True)

    # 16. the four examples, as a user runs them, on the card
    examples, example_launches = examples_phase(kern, ref, torch)
    launches.update(example_launches)
    print(json.dumps({"examples": examples}), flush=True)
    print(f"[16] phases 1-16 took {time.perf_counter() - t_start:.1f} s", flush=True)

    Q = len(queries)
    meta = {
        "K3": ("bm25_block_impacts", "src/repro_torch/kernels/csrc/bm25_block.cu",
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
    k3 = rows["K3"][Q]
    line["kernels"][0].update(
        eager_chain_ms=k3["turns_with_chain"][1], eager_chain_graph_ms=k3["eager_chain_graph_ms"],
        entry_points={"bm25_block_impacts": case_entry(k3),
                      "bm25_block_scores": case_entry(k3["scores"])},
        shapes={f"Q={q}": {"bm25_block_impacts": case_entry(rows["K3"][q]),
                           "bm25_block_scores": case_entry(rows["K3"][q]["scores"])}
                for q in sorted(rows["K3"])})
    line["kernels"][2]["shapes"] = {f"Q={q}": {key: rows["K1"][q][key] for key in (
        "ms", "graph_ms", "plain_ms", "err")} for q in sorted(rows["K1"])}
    line["kernels"][2]["shapes"]["past the old range limit"] = case_entry(k1_wide)
    line["kernels"][1]["shapes"] = {"search": case_entry(rows["K2"][Q]),
                                    "bert4rec vocabulary": case_entry(results["bert4rec"]["k2_vocab"])}
    line["kernels"][1]["shapes"].update(
        {f"mesh {name}": case_entry(r) for name, r in mesh_cases.items()})
    line["kernels"][1]["shapes"].update(
        {f"{name} router": case_entry(r["k2"]) for name, r in moe.items()})
    line["kernels"][1]["shapes"].update(
        {f"examples:partitioned_search mesh {name}": r
         for name, r in examples["partitioned_search"]["k2"].items()})
    line["kernels"][1]["mesh_walls_ms"] = mesh_walls
    line["kernels"][1]["launches_on"] = [COUNTED_ON["K2"]] + [
        route for route, c in mesh_launches.items() if c["K2"]] + [
        route for r in moe.values() for route, c in r["launches"].items() if c["K2"]] + [
        route for route, c in example_launches.items() if c["K2"]]
    line["kernels"][1]["structured_device_us"] = {
        key: v for key, (v, _) in split.items()}
    line["kernels"].append({
        "name": "dot_topk_batch", "route": "cuda", "source": "src/repro_torch/kernels/csrc/dot_topk.cu",
        "replaces": "src/repro/kernels/dot_topk.py:69", "launches": launches["fleet:dense"]["K4"],
        "launches_on": "fleet:dense",
        "launches_by_route": {route: c["K4"] for route, c in launches.items()},
        "max_abs_err": k4[Q]["err"], "ms": k4[Q]["ms"], "plain_ms": k4[Q]["plain_ms"],
        "bound_ms": k4[Q]["bound"][0], "bound_by": k4[Q]["bound"][1],
        "library_ms": k4[Q]["library_ms"],
        "shape": f"Q={Q}, N={sizes[0]}, D={VEC_DIM}, k={K}; ms includes K2's merge of "
                 f"{k4[Q]['survivors']} survivors",
        "shapes": {f"Q={q}": case_entry(k4[q]) for q in sorted(k4)}})
    line["kernels"].append(k5_line(serve, k5, launches))
    line["kernels"][-1]["shapes"] = {f"{name} {case}": case_entry(c) for name, r in moe.items()
                                     for case, c in r["k5"].items()}
    line["kernels"][-1]["moe"] = {name: moe_entry(r) for name, r in moe.items()}
    line["kernels"][0]["serve_launcher"] = serve_out
    line["kernels"].append(k6_line(results, rs_launches, k6_err))
    line["kernels"].append(simt_line(serve, results, launches))
    names = {"bm25_block_impacts": "K3", "topk": "K2", "bm25_pruned_topk": "K1",
             "dot_topk_batch": "K4", "flash_attention": "K5", "embedding_bag": "K6"}
    for entry in line["kernels"]:
        k = names.get(entry["name"])      # the f32 K5's count is K5's, with the bf16 ones
        if k is None:
            continue
        entry["launches_phase15"] = {route: c[k] for route, c in cell_launches.items() if c[k]}
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
