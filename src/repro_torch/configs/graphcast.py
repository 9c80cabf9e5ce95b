"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN,
16 processor layers, d_hidden=512, sum aggregation, n_vars=227.

mesh_refinement=6 parameterizes GraphCast's icosahedral mesh construction;
the assigned shapes supply generic graph benchmarks instead, so the
encode-process-decode stack (the compute core) runs on the given edge lists.
Every cell of this model is a train step: the reference serves no GNN."""

from __future__ import annotations

import torch

from repro_torch.configs.cells import GNN_SHAPES, GNN_SHAPES_REDUCED, gnn_cells
from repro_torch.models.gnn import GNNConfig
from repro_torch.parallel.sharding import gnn_rules

ARCH_ID = "graphcast"
FAMILY = "gnn"


def full_config(d_feat: int = 100, **over) -> GNNConfig:
    kw = dict(name=ARCH_ID, d_feat=d_feat, d_out=227, n_layers=16,
              d_hidden=512, aggregator="sum", mesh_refinement=6,
              dtype=torch.float32)
    kw.update(over)
    return GNNConfig(**kw)


def reduced_config(d_feat: int = 12) -> GNNConfig:
    return GNNConfig(name=ARCH_ID + "-reduced", d_feat=d_feat, d_out=8,
                     n_layers=2, d_hidden=32, dtype=torch.float32)


def rules(**kw):
    return gnn_rules()


def cells(rules_, *, reduced: bool = False):
    # one config per shape (each graph regime has its own feature dim)
    shapes = GNN_SHAPES_REDUCED if reduced else GNN_SHAPES
    out = {}
    for sname, sh in shapes.items():
        cfg = (reduced_config(d_feat=sh["d_feat"]) if reduced
               else full_config(d_feat=sh["d_feat"], unroll=True))
        out[sname] = gnn_cells(ARCH_ID, cfg, rules_, reduced=reduced)[sname]
    return out
