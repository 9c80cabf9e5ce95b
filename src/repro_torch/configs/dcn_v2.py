"""dcn-v2 [arXiv:2008.13535]: 13 dense + 26 sparse fields, embed_dim=16,
3 cross layers (x0 ⊙ (W xl + b) + xl), deep tower 1024-1024-512 (stacked)."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import recsys_cells
from repro_torch.models.recsys import RecsysConfig
from repro_torch.parallel.sharding import recsys_rules

ARCH_ID = "dcn-v2"
FAMILY = "recsys"


def full_config(**over) -> RecsysConfig:
    kw = dict(name=ARCH_ID, kind="dcn", n_sparse=26, n_dense=13,
              embed_dim=16, rows_per_field=1 << 20,
              mlp_dims=(1024, 1024, 512), n_cross_layers=3,
              dtype=torch.float32)
    kw.update(over)
    return RecsysConfig(**kw)


def reduced_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID + "-reduced", kind="dcn", n_sparse=6,
                        n_dense=4, embed_dim=8, rows_per_field=128,
                        mlp_dims=(32, 16), n_cross_layers=2,
                        dtype=torch.float32)


def rules(**kw):
    return recsys_rules()


def cells(rules_, *, reduced: bool = False):
    cfg = reduced_config() if reduced else full_config(unroll=True)
    return recsys_cells(ARCH_ID, cfg, rules_, reduced=reduced)
