"""Cells, in part — the port of ``repro/configs/cells.py``: the shape
tables of every family and the train state's abstract form and placement.

A *cell* is one (architecture × input shape): a step function with abstract
inputs and their specs, which the reference's dry-run lowers and compiles
for a 256- or 512-chip mesh. The builders (``lm_cells``, ``gnn_cells``,
``recsys_cells``) and the dry-run wait for ROADMAP Queue 1 item 10 and
raise; the shape tables are what the chip smoke and the tests size their
runs from.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import abstract_params, tree_map
from repro_torch.parallel.compat import P
from repro_torch.parallel.sharding import ShardRules, param_specs

CELLS_PENDING = ("the cell builders and the dry-run (configs/cells.py, launch/dryrun.py) "
                 "wait for ROADMAP Queue 1 item 10")


# -- train-state helpers -------------------------------------------------------


def abstract_train_state(defs) -> dict:
    """The train state's shapes and dtypes on the meta device: params in
    their dtypes, f32 moments, an int32 step count."""
    params = abstract_params(defs)
    f32 = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), params)
    return {"params": params,
            "opt": {"m": f32, "v": f32,
                    "count": torch.empty((), dtype=torch.int32, device="meta")}}


def train_state_specs(defs, rules: ShardRules) -> dict:
    ps = param_specs(defs, rules)
    return {"params": ps, "opt": {"m": ps, "v": ps, "count": P()}}


# ================================ LM family =====================================

LM_SHAPES = {
    "train_4k":    dict(kind="train",   seq=4_096,   batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768,  batch=32),
    "decode_32k":  dict(kind="decode",  seq=32_768,  batch=128),
    "long_500k":   dict(kind="decode",  seq=524_288, batch=1, long=True),
}

LM_SHAPES_REDUCED = {
    "train_4k":    dict(kind="train",   seq=32,  batch=4),
    "prefill_32k": dict(kind="prefill", seq=64,  batch=2),
    "decode_32k":  dict(kind="decode",  seq=64,  batch=2),
    "long_500k":   dict(kind="decode",  seq=128, batch=1, long=True),
}


def lm_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False, opt=None):
    raise NotImplementedError(CELLS_PENDING)


# ================================ GNN family ====================================

# minibatch_lg: 1024 seeds, fanout 15 then 10 → padded sampled subgraph.
_MB_NODES = 1024 + 1024 * 15 + 1024 * 15 * 10     # 169,984
_MB_EDGES = 1024 * 15 + 1024 * 15 * 10            # 168,960

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg":  dict(n_nodes=_MB_NODES, n_edges=_MB_EDGES, d_feat=602,
                          sampled=True),
    "ogb_products":  dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                          big=True),
    "molecule":      dict(n_nodes=30, n_edges=64, d_feat=32, batch=128),
}

GNN_SHAPES_REDUCED = {
    "full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=12),
    "minibatch_lg":  dict(n_nodes=8 + 8 * 3 + 8 * 6, n_edges=8 * 3 + 24 * 2,
                          d_feat=10, sampled=True),
    "ogb_products":  dict(n_nodes=64, n_edges=256, d_feat=8, big=True),
    "molecule":      dict(n_nodes=10, n_edges=20, d_feat=6, batch=4),
}


def gnn_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False, opt=None):
    raise NotImplementedError(CELLS_PENDING)


# =============================== recsys family ===================================

RECSYS_SHAPES = {
    "train_batch":    dict(kind="train", batch=65_536),
    "serve_p99":      dict(kind="serve", batch=512),
    "serve_bulk":     dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, cands=1_000_000),
}

RECSYS_SHAPES_REDUCED = {
    "train_batch":    dict(kind="train", batch=64),
    "serve_p99":      dict(kind="serve", batch=8),
    "serve_bulk":     dict(kind="serve", batch=128),
    "retrieval_cand": dict(kind="retrieval", batch=1, cands=512),
}

N_NEG = 1024         # bert4rec sampled-softmax negatives
N_MASK = 32          # masked positions scored per sequence


def recsys_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False, opt=None):
    raise NotImplementedError(CELLS_PENDING)
