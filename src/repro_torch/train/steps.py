"""Generic train/eval step builders shared by every architecture family —
the port of ``repro/train/steps.py``.

``make_train_step(loss_fn, opt_cfg)`` returns ``step(state, batch) ->
(state, metrics)`` with ``state = {"params": ..., "opt": adamw_state}``,
each a tree (nested dict) of tensors. The step differentiates ``loss_fn``
with ``torch.autograd.grad`` over the leaves of ``state["params"]``
(detached aliases that require grad: no copy), clips, and applies AdamW;
it returns a new state and leaves the one it was given as it was.

Optional gradient compression: the gradients are cast to bf16 and back
after the backward pass, as the reference does before its cross-replica
reduction (round to nearest, no stochastic rounding).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.train.optim import (OptConfig, unflatten, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)


def init_train_state(params: Any) -> dict:
    return {"params": params, "opt": adamw_init(params)}


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, all detached;
    the grads a tree like ``params`` (zeros where a leaf is unused)."""
    live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    metrics = tree_map(lambda m: m.detach() if isinstance(m, torch.Tensor) else m, metrics)
    return loss.detach(), metrics, unflatten(params, list(grads))


def make_train_step(loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                    opt_cfg: OptConfig, *,
                    compress_grads: bool = False) -> Callable:
    """loss_fn(params, batch) -> (loss, metrics)."""

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        _, metrics, grads = value_and_grad(loss_fn, state["params"], batch)
        with torch.no_grad():
            if compress_grads:
                grads = tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)
            if opt_cfg.clip_norm is not None:
                grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
            else:
                gnorm = global_norm(grads)
            params, opt = adamw_update(grads, state["opt"], state["params"], opt_cfg)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["step"] = opt["count"]
        return {"params": params, "opt": opt}, metrics

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    def step(params: Any, batch: Any) -> dict:
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step

