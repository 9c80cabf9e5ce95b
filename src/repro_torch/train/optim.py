"""AdamW + global-norm clipping + warmup-cosine schedule — the port of
``repro/train/optim.py``.

Moments are kept in f32 whatever the parameters' dtype (bf16 params + f32
moments; no f32 master copy). The functions are plain maps over trees
(nested dicts) of tensors, under ``torch.no_grad()``, and return new trees.

``torch.optim.AdamW`` is not used: it divides by ``sqrt(v)/sqrt(bc2) + eps``
and applies the decay as a step of its own, so it rounds differently. Here
each leaf runs the reference's expression in its order —
``m/bc1 / (sqrt(v/bc2) + eps) + wd·p``, then ``p − lr·step`` — in f32,
cast back to the parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def unflatten(like, leaves: list):
    """``leaves`` (in sorted key order) into ``like``'s nested dicts."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


@torch.no_grad()
def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac·lr, in f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


@torch.no_grad()
def adamw_init(params: Any) -> dict:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros32, params),
        "v": tree_map(zeros32, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    g = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), grads), g


@torch.no_grad()
def adamw_update(grads: Any, opt_state: dict, params: Any,
                 cfg: OptConfig) -> tuple[Any, dict]:
    """Returns (new_params, new_opt_state)."""
    count = opt_state["count"] + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)

    def upd(p, g, m, v):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}
