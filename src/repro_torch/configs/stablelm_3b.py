"""stablelm-3b [hf:stabilityai/stablelm-2; unverified]: 32L d2560 32H
(kv=32 = MHA), d_ff=6912 SwiGLU, vocab 50304, partial rotary (25%)."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import lm_cells
from repro_torch.models.transformer import LMConfig
from repro_torch.parallel.sharding import lm_rules

ARCH_ID = "stablelm-3b"
FAMILY = "lm"


def full_config(**over) -> LMConfig:
    kw = dict(
        name=ARCH_ID, n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab=50304, rope_pct=0.25,
        dtype=torch.bfloat16,
    )
    kw.update(over)
    return LMConfig(**kw)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, rope_pct=0.25,
        dtype=torch.float32,
    )


def rules(**kw):
    return lm_rules(fsdp=False)


def cells(rules_, *, reduced: bool = False):
    return lm_cells(ARCH_ID, None, rules_, reduced=reduced)
