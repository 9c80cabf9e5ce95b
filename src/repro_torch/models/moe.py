"""Mixture-of-Experts: only :class:`MoEConfig` is ported so far, so that
``LMConfig`` keeps its fields. The routed FFN waits for ROADMAP Queue 1
item 9 (``repro/models/moe.py``, ``moe_ep.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

NOT_PORTED = "MoE is not ported yet (ROADMAP Queue 1 item 9)"


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # DeepSeek shared experts
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


def moe_defs(cfg: MoEConfig, dtype) -> dict:
    raise NotImplementedError(NOT_PORTED)


def moe_ffn(p, x, cfg: MoEConfig):
    raise NotImplementedError(NOT_PORTED)
