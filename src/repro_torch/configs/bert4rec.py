"""bert4rec [arXiv:1904.06690]: bidirectional 2-block transformer over
200-item sequences, embed_dim=64, 2 heads; next-item top-k over the tied
item embedding.

Item vocab 2²⁰−2 (+[PAD]/[MASK] rows → 2²⁰ table rows)."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import recsys_cells
from repro_torch.models.recsys import RecsysConfig
from repro_torch.parallel.sharding import recsys_rules

ARCH_ID = "bert4rec"
FAMILY = "recsys"


def full_config(**over) -> RecsysConfig:
    kw = dict(name=ARCH_ID, kind="bert4rec", embed_dim=64, seq_len=200,
              n_blocks=2, n_heads=2, n_items=(1 << 20) - 2,
              dtype=torch.float32)
    kw.update(over)
    return RecsysConfig(**kw)


def reduced_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID + "-reduced", kind="bert4rec",
                        embed_dim=8, seq_len=12, n_blocks=1, n_heads=2,
                        n_items=254, dtype=torch.float32)


def rules(**kw):
    return recsys_rules()


def cells(rules_, *, reduced: bool = False):
    return recsys_cells(ARCH_ID, None, rules_, reduced=reduced)
