"""h2o-danube-1.8b [arXiv:2401.16818]: 24L d2560 32H GQA kv=8, d_ff=6912,
vocab 32000, llama+mistral mix with sliding-window attention (window 4096).

The only dense arch with sub-quadratic attention: its decode cache is a
ring of ``window`` slots (memory O(window), not O(context))."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import lm_cells
from repro_torch.models.transformer import LMConfig
from repro_torch.parallel.sharding import lm_rules

ARCH_ID = "h2o-danube-1.8b"
FAMILY = "lm"


def full_config(**over) -> LMConfig:
    kw = dict(
        name=ARCH_ID, n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
        d_ff=6912, vocab=32000, window=4096,
        dtype=torch.bfloat16,
    )
    kw.update(over)
    return LMConfig(**kw)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, window=16,
        dtype=torch.float32,
    )


def rules(**kw):
    return lm_rules(fsdp=False)


def cells(rules_, *, reduced: bool = False):
    cfg = reduced_config() if reduced else full_config(unroll=True)
    return lm_cells(ARCH_ID, cfg, rules_, reduced=reduced)
