"""GraphCast-style encoder–processor–decoder GNN (interaction networks) —
the port of ``repro/models/gnn.py``.

The ``graphcast`` architecture: 16 processor layers, d_hidden=512, sum
aggregation, 227 output vars [arXiv:2212.12794]. The icosahedral mesh
stage is replaced by the given edge lists; the processor is faithful.
Interaction-network layer l:

    e' = e + MLP_e([e, v_src, v_dst])            (edge update)
    v' = v + MLP_v([v, Σ_{e' into v} e'])        (node update, sum agg)

Padding convention: ``src/dst == n_nodes`` marks padded edges; they read
the zero dump row and their messages land in it, which is sliced off.

Where the reference scatters with ``jax.ops.segment_sum`` and gathers with
``vpad[src]``, the port keeps every sum in one order, so that a train step
gives the same bits on every run: each graph's ``src`` and ``dst`` are
sorted once, stably, into :class:`~repro_torch.models.gather.SegmentPlan`\\ s;
the aggregation is a segment sum over the edges in that order, and the
gathers' backward is the same segment sum (:mod:`repro_torch.models.gather`
— no float atomics). The max aggregator is exact in any order.

Parameters are the reference's tree, the processor's stacked on a leading
``layers`` axis; each layer runs under :func:`~repro_torch.models.common.remat`
per ``cfg.remat_policy``. ``gnn_forward_batched`` flattens G graphs into one
of G·(N+1) rows (each graph's nodes, then its dump row), which is what the
reference's ``vmap`` computes graph by graph.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import (ParamDef, count_params, mlp_stack, mlp_stack_defs,
                                       remat, tree_map, unstack_layers)
from repro_torch.models.gather import SegmentPlan, gather_rows, segment_max, segment_sum


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    d_feat: int                   # input node-feature dim
    d_out: int = 227              # graphcast n_vars
    n_layers: int = 16
    d_hidden: int = 512
    aggregator: str = "sum"       # sum | mean | max
    mesh_refinement: int = 6      # metadata (icosahedral stage not used)
    dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "nothing_saveable"   # | "dots_saveable" | "none"
    unroll: bool = False          # the reference's dry-run knob; no effect here

    def param_count(self) -> int:
        return count_params(gnn_param_defs(self))


def _stack(defs, n):
    return tree_map(lambda p: ParamDef((n,) + p.shape, ("layers",) + p.axes,
                                       init=p.init, scale=p.scale, dtype=p.dtype), defs)


def gnn_param_defs(cfg: GNNConfig) -> dict:
    h, dt = cfg.d_hidden, cfg.dtype
    layer = {
        "edge_mlp": mlp_stack_defs((3 * h, h, h), dt),
        "node_mlp": mlp_stack_defs((2 * h, h, h), dt),
    }
    return {
        "node_enc": mlp_stack_defs((cfg.d_feat, h, h), dt),
        "edge_enc": mlp_stack_defs((2 * h, h, h), dt),
        "layers": _stack(layer, cfg.n_layers),
        "node_dec": mlp_stack_defs((h, h, cfg.d_out), dt),
    }


def _segment(messages, plan: SegmentPlan, how: str):
    """Sum (mean, max) the messages into every segment of ``plan``."""
    rows = plan.n_segments
    if how == "sum":
        return segment_sum(messages, plan, rows)
    if how == "mean":
        s = segment_sum(messages, plan, rows)
        return s / torch.clamp(plan.lengths.to(s.dtype)[:, None], min=1.0)
    if how == "max":
        out = segment_max(messages, plan, rows)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(how)


def _aggregate(messages, dst, n_nodes: int, how: str):
    """Scatter edge messages to destination nodes. Padded edges must carry
    dst == n_nodes (dump row, sliced off)."""
    plan = dst if isinstance(dst, SegmentPlan) else SegmentPlan(dst, n_nodes + 1)
    return _segment(messages, plan, how)[:n_nodes]


class _Graph:
    """G graphs of N nodes as one of G·(N+1) rows: graph g's node i is row
    g·(N+1) + i, its dump row g·(N+1) + N. ``src``/``dst`` plans over them."""

    def __init__(self, src, dst, G: int, N: int):
        self.G, self.N = G, N
        off = (torch.arange(G, device=src.device) * (N + 1))[:, None]
        rows = G * (N + 1)
        self.src = SegmentPlan((src.reshape(G, -1).long() + off).reshape(-1), rows)
        self.dst = SegmentPlan((dst.reshape(G, -1).long() + off).reshape(-1), rows)

    def pad(self, v):
        """(G·N, h) → (G·(N+1), h): a zero dump row after each graph's nodes."""
        h = v.shape[-1]
        v = v.reshape(self.G, self.N, h)
        return torch.cat([v, v.new_zeros(self.G, 1, h)], dim=1).reshape(-1, h)

    def unpad(self, x):
        """(G·(N+1), h) → (G·N, h): the dump rows sliced off."""
        h = x.shape[-1]
        return x.reshape(self.G, self.N + 1, h)[:, :self.N].reshape(-1, h)


def _forward(params, feat, graph: _Graph, cfg: GNNConfig):
    """feat (G·N, F) → (G·N, d_out)."""
    v = mlp_stack(params["node_enc"], feat.to(cfg.dtype))              # (G·N,h)
    vpad = graph.pad(v)
    e = mlp_stack(params["edge_enc"],
                  torch.cat([gather_rows(vpad, graph.src), gather_rows(vpad, graph.dst)], -1))

    def layer(v, e, lp):
        vpad = graph.pad(v)
        msg_in = torch.cat([e, gather_rows(vpad, graph.src), gather_rows(vpad, graph.dst)], -1)
        e = e + mlp_stack(lp["edge_mlp"], msg_in)
        agg = graph.unpad(_segment(e, graph.dst, cfg.aggregator))
        v = v + mlp_stack(lp["node_mlp"], torch.cat([v, agg], -1))
        return v, e

    body = remat(layer, cfg.remat_policy) if cfg.remat else layer
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        v, e = body(v, e, lp)
    return mlp_stack(params["node_dec"], v)


def _on(params, x, dtype=None) -> torch.Tensor:
    dev = params["node_enc"]["w0"].device
    x = torch.as_tensor(x).to(dev)
    return x if dtype is None else x.to(dtype)


def gnn_forward(params, graph: dict, cfg: GNNConfig):
    """graph = {feat (N,F), src (E,), dst (E,)} — padded edges use id N —
    on the parameters' device. Returns per-node predictions (N, d_out)."""
    feat = _on(params, graph["feat"])
    N = feat.shape[0]
    g = _Graph(_on(params, graph["src"]), _on(params, graph["dst"]), 1, N)
    return _forward(params, feat, g, cfg)


def gnn_forward_batched(params, graphs: dict, cfg: GNNConfig):
    """Batched small graphs: feat (G,N,F), src/dst (G,E) → (G,N,d_out), as
    the reference's ``vmap``: one graph of G·(N+1) rows."""
    feat = _on(params, graphs["feat"])
    G, N, F = feat.shape
    g = _Graph(_on(params, graphs["src"]), _on(params, graphs["dst"]), G, N)
    return _forward(params, feat.reshape(G * N, F), g, cfg).reshape(G, N, -1)


def gnn_loss(params, batch: dict, cfg: GNNConfig):
    """MSE regression to (…,d_out) targets over masked nodes (graphcast's
    per-variable regression). batch: graph fields + target + node_mask."""
    if torch.as_tensor(batch["feat"]).dim() == 3:
        pred = gnn_forward_batched(params, batch, cfg)
    else:
        pred = gnn_forward(params, batch, cfg)
    target = _on(params, batch["target"], torch.float32)
    mask = _on(params, batch["node_mask"], torch.float32)
    err = (pred.float() - target) ** 2
    per_node = torch.mean(err, dim=-1)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(per_node * mask) / denom
    return loss, {"loss": loss, "rmse": torch.sqrt(loss)}
