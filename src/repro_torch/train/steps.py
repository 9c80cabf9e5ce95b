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

``make_sharded_train_step`` is the same step over a mesh, where the
reference's ``jit`` with shardings lets GSPMD partition it. On a
:class:`~repro_torch.parallel.compat.RankMesh` each rank holds its blocks
of the state (:func:`~repro_torch.parallel.sharding.place_tree`) and of
the batch, and the step writes its collectives out: the parameters
all-gathered leaf by leaf, the loss and gradient on the rank's batch
shard, the gradients and the loss's metrics reduced over the batch axes
(``hierarchical_psum``: ``data``, then ``pod``) as a mean, the global-norm
clip over the whole reduced gradient, and AdamW on the rank's own blocks
of parameters and moments. Ranks along ``model`` repeat the same compute
(correctness first: no tensor-parallel matmuls). On a
:class:`~repro_torch.parallel.compat.StackedMesh` every partition lives on
one device, and the step is the host step: the same bits.
:func:`sharded_step_collectives` is what one such step moves per device —
the dry run's ``collectives`` — counted from the step's own gather and
reduction, run on meta blocks.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.parallel import compat
from repro_torch.parallel.compat import RankMesh, StackedMesh
from repro_torch.parallel.sharding import hierarchical_psum, map_specs, spec_leaves
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


STEP_METRICS = ("grad_norm", "step")     # what a step adds to its loss's metrics


def batch_axes(batch_specs: Any, mesh) -> tuple[str, ...]:
    """The mesh axes a batch's leading dimension shards over, ``data`` first,
    then ``pod``, then any other (the order of the gradient reduction)."""
    used: set[str] = set()
    for s in spec_leaves(batch_specs):
        if len(s) and s[0] is not None:
            used.update(mesh.axes(s[0]))
    first = [a for a in ("data", "pod") if a in used]
    return tuple(first + [a for a in mesh.axis_names if a in used and a not in first])


def _reduce(x: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over the batch axes: ``hierarchical_psum`` over
    ``data`` and ``pod``, a psum over any other."""
    rest = axes
    if "data" in axes:
        x = hierarchical_psum(x, inner="data", outer="pod" if "pod" in axes else None)
        rest = tuple(a for a in axes if a not in ("data", "pod"))
    for a in rest:
        x = compat.psum(x, a)
    return x


def _gather_params(mesh, blocks: Any, pspecs: Any) -> Any:
    """Each parameter leaf's ``(L, *block)`` → the global leaf, all-gathered
    over its spec's axes."""
    return map_specs(lambda x, s: mesh.unshard(x, s), blocks, pspecs)


def _batch_mean(grads: Any, metrics: dict, axes: tuple[str, ...], n: int) -> tuple[Any, dict]:
    """The gradients (one all-reduce a leaf and axis) and the loss's
    metrics (one for all of them) summed over the batch axes, over ``n``,
    under the ambient mesh."""
    grads = tree_map(lambda g: _reduce(g, axes) / n, grads)
    names = sorted(metrics)
    means = _reduce(torch.stack([metrics[k].float() for k in names], dim=-1), axes) / n
    return grads, dict(zip(names, means.unbind(-1)))


def make_sharded_train_step(loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
                            opt_cfg: OptConfig, mesh, state_specs: dict, batch_specs: Any, *,
                            compress_grads: bool = False) -> Callable:
    """``step(state, batch) -> (state, metrics)`` over ``mesh``: on a rank
    mesh ``state`` and ``batch`` are this rank's blocks under their specs
    and so is the new state; on a stacked mesh the host step."""
    if not isinstance(mesh, RankMesh):
        return make_train_step(loss_fn, opt_cfg, compress_grads=compress_grads)
    axes = batch_axes(batch_specs, mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    pspecs = state_specs["params"]
    # the loss runs on this rank alone: a shard_map inside it (expert-parallel
    # MoE) sees a mesh of one partition with the mesh's axis names
    alone = StackedMesh((1,) * len(mesh.axis_names), mesh.axis_names, device=mesh.device)

    def step(state: dict, batch: Any) -> tuple[dict, dict]:
        params = _gather_params(mesh, tree_map(lambda x: x[None], state["params"]), pspecs)
        with compat.use_mesh(alone):
            _, metrics, grads = value_and_grad(loss_fn, params, batch)
        with torch.no_grad(), compat.use_mesh(mesh):
            if compress_grads:
                grads = tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)
            grads, metrics = _batch_mean(grads, metrics, axes, n)
            if opt_cfg.clip_norm is not None:
                grads, gnorm = clip_by_global_norm(grads, opt_cfg.clip_norm)
            else:
                gnorm = global_norm(grads)
            mine = map_specs(lambda g, s: mesh.shard(g, s)[0], grads, pspecs)
            new_params, opt = adamw_update(mine, state["opt"], state["params"], opt_cfg)
        metrics["grad_norm"] = gnorm
        metrics["step"] = opt["count"]
        return {"params": new_params, "opt": opt}, metrics

    return step


def sharded_step_collectives(state: Any, state_specs: dict, batch_specs: Any, mesh, *,
                             n_metrics: int) -> dict:
    """What one :func:`make_sharded_train_step` step moves per device on a
    rank mesh of ``mesh``'s shape, for a state of ``state``'s shapes and
    dtypes (meta tensors do) and ``n_metrics`` loss metrics: the step's own
    gather and reduction (:func:`_gather_params`, :func:`_batch_mean`) run
    on meta blocks over that shape stacked on ``meta``, whose collectives
    count a rank's share. A dimension that does not split evenly takes its
    padded block, as GSPMD pads it. Returns the dry run's ``collectives``
    entry."""
    stacked = StackedMesh(tuple(mesh.shape.values()), mesh.axis_names, device="meta")
    L = stacked.size
    pspecs = state_specs["params"]
    blocks = map_specs(lambda p, s: torch.empty(L, *stacked.block_shape(p.shape, s, pad=True),
                                                dtype=p.dtype, device="meta"),
                       state["params"], pspecs)
    metrics = {i: torch.empty(L, device="meta") for i in range(n_metrics)}
    axes = batch_axes(batch_specs, stacked)
    with compat.count_collectives() as log, compat.use_mesh(stacked):
        params = _gather_params(stacked, blocks, pspecs)
        _batch_mean(tree_map(lambda p: p.expand(L, *p.shape), params), metrics, axes,
                    math.prod(stacked.shape[a] for a in axes))
    return log.record()


def make_eval_step(loss_fn: Callable) -> Callable:
    def step(params: Any, batch: Any) -> dict:
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return step

