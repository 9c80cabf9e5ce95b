"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba).
embed_dim=32, seq_len=20, 1 block, 8 heads, MLP 1024-512-256; 2²² items."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import recsys_cells
from repro_torch.models.recsys import RecsysConfig
from repro_torch.parallel.sharding import recsys_rules

ARCH_ID = "bst"
FAMILY = "recsys"


def full_config(**over) -> RecsysConfig:
    kw = dict(name=ARCH_ID, kind="bst", embed_dim=32, seq_len=20,
              n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256),
              n_items=1 << 22, dtype=torch.float32)
    kw.update(over)
    return RecsysConfig(**kw)


def reduced_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID + "-reduced", kind="bst", embed_dim=8,
                        seq_len=5, n_blocks=1, n_heads=2, mlp_dims=(16, 8),
                        n_items=256, dtype=torch.float32)


def rules(**kw):
    return recsys_rules()


def cells(rules_, *, reduced: bool = False):
    return recsys_cells(ARCH_ID, None, rules_, reduced=reduced)
