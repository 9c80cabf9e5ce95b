"""deepseek-v2-236b [arXiv:2405.04434]: 60L d5120 128H, MLA kv_lora=512,
MoE 2 shared + 160 routed top-6, expert d_ff=1536, vocab 102400.
~236B total / ~21B active params.

Faithfulness notes: q_lora=1536, qk nope/rope = 128/64, v_dim=128 per the
paper. Deviation (the reference's): DeepSeek-V2's first layer is a dense
FFN (12288); here all 60 layers are MoE.

Dispatch: the explicit expert-parallel path (``moe_impl="ep"``) on the
ambient mesh. The reduced config takes the global dispatch and needs no
mesh.

``rules`` returns the reference's rules; ``cells`` raises until the cell
builders land (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.configs.cells import lm_cells
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig, MLAConfig
from repro_torch.parallel.sharding import lm_rules

ARCH_ID = "deepseek-v2-236b"
FAMILY = "lm"

def full_config(**over) -> LMConfig:
    kw = dict(
        name=ARCH_ID, n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288, vocab=102400,
        mla=MLAConfig(q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
                      v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_model=5120, d_ff=1536,
                      n_shared=2, capacity_factor=1.25),
        moe_impl="ep",
        dtype=torch.bfloat16,
    )
    kw.update(over)
    return LMConfig(**kw)


def reduced_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512,
        mla=MLAConfig(q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32, n_shared=1,
                      capacity_factor=2.0),
        moe_impl="gspmd",       # 1-device smoke: no mesh context required
        dtype=torch.float32,
    )


def rules(**kw):
    return lm_rules(fsdp=True)


def cells(rules_, *, reduced: bool = False):
    return lm_cells(ARCH_ID, None, rules_, reduced=reduced)
