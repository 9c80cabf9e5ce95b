"""Gathers and segment sums that add in one fixed order, forward and
backward — the training path's scatters.

``x[idx]`` differentiates into a scatter-add, and ``index_add_`` on the card
adds with float atomics: rows that share an index then sum in whatever
order the threads land, which changes from run to run. Here a
:class:`SegmentPlan` sorts the indices once, stably, and every sum of rows
that share an index runs over that sorted order with
``torch.segment_reduce`` (one thread a segment and a column, adding in
order from zero): the order in which the indices first appear, on every
device and every run.

* :func:`gather_rows` — ``table[idx]``; its backward is the segment sum of
  the incoming rows by ``idx``.
* :func:`segment_sum` — the rows of ``x`` summed by ``idx`` into
  ``n_segments`` rows (``jax.ops.segment_sum``); its backward is a gather.
* :func:`segment_max` — the same with max (exact in any order); its
  backward splits a segment's gradient equally among the rows that reach
  the max, as ``jax.ops.segment_max``'s does.

A plan's lengths come from a ``searchsorted`` over the sorted indices, not
``bincount``, which has no deterministic kernel on the card.
"""

from __future__ import annotations

import torch


class SegmentPlan:
    """``idx`` (E,) int in [0, n_segments) sorted once: ``order`` the stable
    argsort, ``lengths`` (n_segments,) the count of each index."""

    def __init__(self, idx: torch.Tensor, n_segments: int):
        self.idx = idx.reshape(-1).long()
        self.n_segments = int(n_segments)
        sorted_idx, self.order = torch.sort(self.idx, stable=True)
        bounds = torch.searchsorted(
            sorted_idx, torch.arange(self.n_segments + 1, device=self.idx.device))
        self.lengths = bounds[1:] - bounds[:-1]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(E, ...) → (n_segments, ...): each segment's rows added in order."""
        if x.shape[0] == 0:
            return x.new_zeros(self.n_segments, *x.shape[1:])
        return torch.segment_reduce(x.index_select(0, self.order), "sum",
                                    lengths=self.lengths, axis=0, unsafe=True)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, plan):
        ctx.plan = plan
        return table.index_select(0, plan.idx)

    @staticmethod
    def backward(ctx, grad):
        return ctx.plan.sum(grad), None


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan.sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.plan.idx), None


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        out = torch.segment_reduce(x.index_select(0, plan.order), "max",
                                   lengths=plan.lengths, axis=0, unsafe=True)
        ctx.plan = plan
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        # each segment's gradient split equally among the rows that reach its
        # max, as jax.ops.segment_max's (the counts are exact integers)
        x, out = ctx.saved_tensors
        plan = ctx.plan
        tie = (x == out.index_select(0, plan.idx)).to(grad.dtype)
        share = grad / torch.clamp(plan.sum(tie), min=1.0)
        return tie * share.index_select(0, plan.idx), None


def _plan(idx, n: int) -> SegmentPlan:
    if isinstance(idx, SegmentPlan):
        if idx.n_segments != n:
            raise ValueError(f"a plan of {idx.n_segments} segments for {n} rows")
        return idx
    return SegmentPlan(idx, n)


def gather_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """table (R, ...) and idx (...,) int (or a plan of R segments) →
    (..., *table.shape[1:]); the backward sums by ``idx`` in a fixed order."""
    if isinstance(idx, SegmentPlan):
        shape = idx.idx.shape
    else:
        idx = torch.as_tensor(idx, device=table.device)
        shape = idx.shape
        if not (torch.is_grad_enabled() and table.requires_grad):
            # no backward to plan for: the forward's gather alone
            return table.index_select(0, idx.reshape(-1).long()).reshape(
                *shape, *table.shape[1:])
    plan = _plan(idx, table.shape[0])
    return _Gather.apply(table, plan).reshape(*shape, *table.shape[1:])


def segment_sum(x: torch.Tensor, idx, n_segments: int) -> torch.Tensor:
    """x (E, ...) rows summed by idx (E,) (or a plan) into (n_segments, ...)."""
    return _SegmentSum.apply(x, _plan(idx, n_segments))


def segment_max(x: torch.Tensor, idx, n_segments: int) -> torch.Tensor:
    """x (E, ...) → (n_segments, ...) maxima, -inf for an empty segment (as
    ``jax.ops.segment_max``); ties share the gradient equally."""
    plan = _plan(idx, n_segments)
    if x.shape[0] == 0:
        return x.new_full((n_segments, *x.shape[1:]), float("-inf"))
    return _SegmentMax.apply(x, plan)
