"""fm [Rendle, ICDM'10]: factorization machine, 39 sparse fields,
embed_dim=10, pairwise ⟨vᵢ,vⱼ⟩xᵢxⱼ via the O(nk) sum-square trick.
Hashed 2²⁰ rows per field → 40.9M-row shared table."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import recsys_cells
from repro_torch.models.recsys import RecsysConfig
from repro_torch.parallel.sharding import recsys_rules

ARCH_ID = "fm"
FAMILY = "recsys"


def full_config(**over) -> RecsysConfig:
    kw = dict(name=ARCH_ID, kind="fm", n_sparse=39, embed_dim=10,
              rows_per_field=1 << 20, dtype=torch.float32)
    kw.update(over)
    return RecsysConfig(**kw)


def reduced_config() -> RecsysConfig:
    return RecsysConfig(name=ARCH_ID + "-reduced", kind="fm", n_sparse=6,
                        embed_dim=8, rows_per_field=128, dtype=torch.float32)


def rules(**kw):
    return recsys_rules()


def cells(rules_, *, reduced: bool = False):
    cfg = reduced_config() if reduced else full_config(unroll=True)
    return recsys_cells(ARCH_ID, cfg, rules_, reduced=reduced)
