"""olmoe-1b-7b [arXiv:2409.02060]: 16L d2048 16H (kv=16) MoE 64e top-8,
d_ff(expert)=1024, vocab 50304. ~6.9B total / ~1.3B active params.

Shipped dispatch: explicit expert parallelism (``moe_impl="ep"``), which
runs on the ambient mesh (``repro_torch.parallel.compat.use_mesh``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.cells import lm_cells
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.parallel.sharding import lm_rules

ARCH_ID = "olmoe-1b-7b"
FAMILY = "lm"

def full_config(**over) -> LMConfig:
    kw = dict(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_model=2048, d_ff=1024,
                      capacity_factor=1.25),
        moe_impl="ep",
        dtype=torch.bfloat16,
    )
    kw.update(over)
    return LMConfig(**kw)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32,
                      capacity_factor=2.0),
        dtype=torch.float32,
    )


def rules(**kw):
    return lm_rules(fsdp=True)


def cells(rules_, *, reduced: bool = False):
    cfg = reduced_config() if reduced else full_config(
        ep_batch_axes=tuple(rules_.batch), unroll=True)
    return lm_cells(ARCH_ID, cfg, rules_, reduced=reduced)
