"""starcoder2-3b [arXiv:2402.19173]: 30L d3072 24H GQA kv=2, d_ff=12288
(non-gated GELU FFN), vocab 49152, RoPE."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import lm_cells
from repro_torch.models.transformer import LMConfig
from repro_torch.parallel.sharding import lm_rules

ARCH_ID = "starcoder2-3b"
FAMILY = "lm"


def full_config(**over) -> LMConfig:
    kw = dict(
        name=ARCH_ID, n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab=49152, ffn_act="gelu", rope_theta=1e5,
        dtype=torch.bfloat16,
    )
    kw.update(over)
    return LMConfig(**kw)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, ffn_act="gelu",
        dtype=torch.float32,
    )


def rules(**kw):
    return lm_rules(fsdp=False)


def cells(rules_, *, reduced: bool = False):
    return lm_cells(ARCH_ID, None, rules_, reduced=reduced)
