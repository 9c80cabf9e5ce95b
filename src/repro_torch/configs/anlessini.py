"""anlessini — the paper's own architecture: serverless BM25 search over
MS MARCO passages (8.8M docs, ~700MB Anserini BM25 index).

Dry-run geometry (MS MARCO passage scale, document-partitioned over the
whole mesh per paper §3): 8,847,360 docs → 34,560 per partition on 256
chips; ~495M postings → ~3.93M blocks of 128 → 15,360 per partition;
vocab 2¹⁹. Two serve shapes: interactive (Q=1, the paper's <300 ms
operating point) and batched scatter-gather (Q=64).

The cells are late-bound: the partition count comes from the mesh the dry
run binds, so each cell carries ``build(mesh) -> (fn, args, specs)``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.cells import SDS, CellSpec
from repro_torch.parallel.compat import P
from repro_torch.parallel.sharding import ShardRules
from repro_torch.search.distributed import (DistSearchConfig, abstract_dist_state,
                                            dist_state_specs, make_dist_search_fn)

ARCH_ID = "anlessini"
FAMILY = "search"

SHAPES = {
    "serve_q1": dict(Q=1),
    "serve_q64": dict(Q=64),
}
SHAPES_REDUCED = {
    "serve_q1": dict(Q=1),
    "serve_q64": dict(Q=4),
}

def full_config(n_parts: int) -> DistSearchConfig:
    return DistSearchConfig(
        n_parts=n_parts,
        n_docs_local=8_847_360 // n_parts,
        n_blocks_local=3_932_160 // n_parts,
        vocab=1 << 19, block=128, max_terms=16, max_blocks=32, k=100)


def reduced_config(n_parts: int = 1) -> DistSearchConfig:
    return DistSearchConfig(n_parts=n_parts, n_docs_local=64,
                            n_blocks_local=32, vocab=256, block=128,
                            max_terms=8, max_blocks=4, k=10)


def rules(**kw):
    return ShardRules(mapping={}, batch=("data",))


def cells(rules_, *, reduced: bool = False):
    # partition over every mesh axis (data, model [, pod])
    axes = tuple(rules_.batch) + ("model",)
    shapes = SHAPES_REDUCED if reduced else SHAPES
    return {sname: _search_cell(sname, sh["Q"], axes, reduced) for sname, sh in shapes.items()}


def _search_cell(sname: str, Q: int, axes, reduced: bool) -> CellSpec:
    # the partition count is the mesh's extent over ``axes``: the cell
    # builds its function and abstract state from the mesh it is bound to
    def build(mesh):
        n_parts = 1
        for ax in axes:
            n_parts *= mesh.shape[ax]
        cfg = reduced_config(n_parts) if reduced else full_config(n_parts)
        fn = make_dist_search_fn(cfg, axes, mesh=mesh)
        state = abstract_dist_state(cfg)
        args = (state, SDS((Q, cfg.max_terms), torch.int32),
                SDS((Q, cfg.max_terms), torch.float32))
        specs = (dist_state_specs(axes), P(None, None), P(None, None))
        return fn, args, specs

    cell = CellSpec(ARCH_ID, sname, "serve", None, (), (),
                    note="paper's own arch; geometry bound to mesh at dry-run")
    cell.build = build          # late-bound (needs mesh axis sizes)
    return cell
