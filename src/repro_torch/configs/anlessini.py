"""anlessini — the paper's own architecture: serverless BM25 search over
MS MARCO passages (8.8M docs, ~700MB Anserini BM25 index).

Dry-run geometry (MS MARCO passage scale, document-partitioned over the
whole mesh per paper §3): 8,847,360 docs → 34,560 per partition on 256
chips; ~495M postings → ~3.93M blocks of 128 → 15,360 per partition;
vocab 2¹⁹. Two serve shapes: interactive (Q=1, the paper's <300 ms
operating point) and batched scatter-gather (Q=64).

``rules`` returns the reference's rules; ``cells`` raises until the cell
builders land (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from repro_torch.configs.cells import CELLS_PENDING
from repro_torch.parallel.sharding import ShardRules
from repro_torch.search.distributed import DistSearchConfig

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
    raise NotImplementedError(CELLS_PENDING)
