"""Cell builders: one :class:`CellSpec` per (architecture × input shape) —
the port of ``repro/configs/cells.py``.

A *cell* is the unit of the dry run (:mod:`repro_torch.launch.dryrun`) and
the roofline table: a step function, its abstract inputs (tensors on the
``meta`` device: shapes and dtypes, no storage) and their partition specs.
The dry run binds a production mesh and traces the function on those
inputs; nothing is allocated for the full configs. The same cells run
materialized on the CPU (the tests) and on the card (``chip_smoke.py``).

Families: LM (train / prefill / decode / long-decode), GNN (train on four
graph regimes), recsys (train / serve / bulk / retrieval), plus the paper's
own search arch (:mod:`repro_torch.configs.anlessini`). The step functions
are the port's entry points behind the reference's adapters; where an
entry point takes ``device=`` the adapter passes the parameters' own, and
the LM's serving entries take the :class:`~repro_torch.models.transformer.LM`
module, which the adapter wraps around the parameter tree (no copy).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.models.common import abstract_params, tree_leaves, tree_map
from repro_torch.parallel.compat import P
from repro_torch.parallel.sharding import ShardRules, param_specs
from repro_torch.train.optim import OptConfig
from repro_torch.train.steps import make_train_step


def SDS(shape, dtype) -> torch.Tensor:
    """The reference's ShapeDtypeStruct: an empty tensor on ``meta``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode | serve | retrieval
    fn: Callable | None
    args: tuple                     # abstract argument trees
    in_specs: tuple                 # P trees, same structure
    donate: tuple[int, ...] = ()
    note: str = ""
    skip: bool = False              # inapplicable cell (reason in note)

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


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



def _lm_cache_abstract(cfg, batch: int, seq: int):
    from repro_torch.models.transformer import make_cache
    return make_cache(cfg, batch, seq, device="meta")


def _lm_cache_specs(cfg, rules: ShardRules, *, batch: int, shard_seq: bool):
    """KV-cache sharding for decode.

    The cache SEQ dim shards over `model` (flash-decoding style): uniformly
    divisible (32768 % 16 == 0) regardless of Hkv — head-sharding breaks for
    GQA archs with Hkv < mesh (starcoder2 Hkv=2). long-decode (batch=1):
    batch replicated, seq over (data, model)."""
    if shard_seq:                       # long_500k: batch=1
        bax, seq_ax = None, ("data", "model")
    else:
        b = rules.batch_spec()
        bax = b[0] if len(b) else None
        seq_ax = "model"
    if cfg.mla is not None:
        return {"ckv": P(None, bax, seq_ax, None),
                "krope": P(None, bax, seq_ax, None)}
    return {"k": P(None, bax, None, seq_ax, None),
            "v": P(None, bax, None, seq_ax, None)}


LONG_NOTE = ("N/A: pure full-attention arch — 512k-token KV cache "
             "is architecturally unservable (DESIGN.md "
             "§Arch-applicability); sub-quadratic attention "
             "required. Runs for SWA archs.")


def lm_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False,
             opt: OptConfig | None = None) -> dict[str, CellSpec]:
    from repro_torch.models.transformer import lm_param_defs

    shapes = LM_SHAPES_REDUCED if reduced else LM_SHAPES
    defs = lm_param_defs(cfg)
    pspecs = param_specs(defs, rules)
    opt = opt or OptConfig()
    cells: dict[str, CellSpec] = {}
    dense = cfg.moe is None and cfg.mla is None

    for sname, sh in shapes.items():
        B, S = sh["batch"], sh["seq"]
        kind = sh["kind"]
        if sh.get("long") and cfg.window is None:
            cells[sname] = CellSpec(arch, sname, kind, None, (), (), skip=True,
                                    note=LONG_NOTE)
            continue

        if kind == "train":
            loss = functools.partial(_lm_loss_adapter, cfg=cfg)
            fn = make_train_step(loss, opt)
            args = (abstract_train_state(defs),
                    {"tokens": SDS((B, S), torch.int32),
                     "labels": SDS((B, S), torch.int32)})
            specs = (train_state_specs(defs, rules),
                     {"tokens": rules.batch_spec(None),
                      "labels": rules.batch_spec(None)})
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs, donate=(0,))
        elif kind == "prefill":
            fn = functools.partial(_lm_prefill_adapter, cfg=cfg, max_len=S)
            args = (abstract_params(defs), SDS((B, S), torch.int32))
            specs = (pspecs, rules.batch_spec(None))
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs)
            if dense:
                cells[sname].build = _lm_sharded_build(cfg, kind, args, specs)
        elif kind == "decode":
            shard_seq = bool(sh.get("long"))
            cache = _lm_cache_abstract(cfg, B, S)
            fn = functools.partial(_lm_decode_adapter, cfg=cfg)
            args = (abstract_params(defs), cache,
                    SDS((B, 1), torch.int32), SDS((), torch.int32))
            specs = (pspecs,
                     _lm_cache_specs(cfg, rules, batch=B, shard_seq=shard_seq),
                     P() if shard_seq else rules.batch_spec(None), P())
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs, donate=(1,))
            if dense:
                cells[sname].build = _lm_sharded_build(cfg, kind, args, specs)
    return cells


def _lm_sharded_build(cfg, kind: str, args: tuple, specs: tuple) -> Callable:
    """A dense LM's prefill or decode cell's late binding: ``build(mesh) ->
    (fn, args, specs)``, ``fn`` the cell's sharded function over ``mesh``
    (:func:`repro_torch.models.transformer.sharded_cell_fn`) under the cell's
    own specs. ``cell.fn`` stays the plain adapter, the reference's
    function."""
    def build(mesh):
        from repro_torch.models.transformer import sharded_cell_fn
        return sharded_cell_fn(cfg, kind, mesh, specs), args, specs
    return build


def _lm_loss_adapter(params, batch, *, cfg):
    from repro_torch.models.transformer import lm_loss
    return lm_loss(params, batch, cfg)


def _lm_prefill_adapter(params, tokens, *, cfg, max_len):
    from repro_torch.models.transformer import LM, lm_prefill
    return lm_prefill(LM(params, cfg), tokens, cfg, max_len=max_len, device=_device(params))


def decode_position(pos, cache: dict) -> int:
    """The decode step's position as the host ``int`` that ``lm_decode``
    takes. A meta tensor holds no value: the dry run takes the cache's last
    slot, whose step attends the whole cache (the most work a step does)."""
    if isinstance(pos, torch.Tensor) and pos.device.type == "meta":
        slots = next(iter(cache.values())).shape[-2 if "k" in cache else 2]
        return slots - 1
    return int(pos)


def _lm_decode_adapter(params, cache, token, pos, *, cfg):
    from repro_torch.models.transformer import LM, lm_decode
    return lm_decode(LM(params, cfg), cache, token, decode_position(pos, cache), cfg,
                     device=_device(params))


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



def gnn_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False,
              opt: OptConfig | None = None) -> dict[str, CellSpec]:
    from repro_torch.models.gnn import gnn_param_defs

    shapes = GNN_SHAPES_REDUCED if reduced else GNN_SHAPES
    defs = gnn_param_defs(cfg)
    opt = opt or OptConfig()
    cells = {}

    def _pad(x: int, m: int = 256) -> int:
        return -(-x // m) * m

    for sname, sh in shapes.items():
        N, E, F = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
        if not reduced and not sh.get("batch"):
            # pad sharded dims to the production-mesh multiple (dump-edge /
            # dump-node convention: padding is semantically a no-op)
            E = _pad(E)
            if sh.get("big"):
                N = _pad(N)
        G = sh.get("batch")
        loss = functools.partial(_gnn_loss_adapter, cfg=cfg)
        fn = make_train_step(loss, opt)
        f32, i32 = torch.float32, torch.int32
        if G:                                    # batched small graphs
            batch = {
                "feat": SDS((G, N, F), f32),
                "src": SDS((G, E), i32),
                "dst": SDS((G, E), i32),
                "target": SDS((G, N, cfg.d_out), f32),
                "node_mask": SDS((G, N), f32),
            }
            bspec = {
                "feat": rules.batch_spec(None, None),
                "src": rules.batch_spec(None),
                "dst": rules.batch_spec(None),
                "target": rules.batch_spec(None, None),
                "node_mask": rules.batch_spec(None),
            }
        else:
            # edges shard over (data [, model]); features/targets of big
            # graphs shard rows over data; small graphs replicate.
            big = bool(sh.get("big"))
            edge_spec = P(("data", "model")) if big else P("data")
            row = P("data", None) if big else P(None, None)
            batch = {
                "feat": SDS((N, F), f32),
                "src": SDS((E,), i32),
                "dst": SDS((E,), i32),
                "target": SDS((N, cfg.d_out), f32),
                "node_mask": SDS((N,), f32),
            }
            bspec = {
                "feat": row, "src": edge_spec, "dst": edge_spec,
                "target": row,
                "node_mask": P("data") if big else P(None),
            }
        args = (abstract_train_state(defs), batch)
        specs = (train_state_specs(defs, rules), bspec)
        cells[sname] = CellSpec(arch, sname, "train", fn, args, specs, donate=(0,))
    return cells


def _gnn_loss_adapter(params, batch, *, cfg):
    from repro_torch.models.gnn import gnn_loss
    return gnn_loss(params, batch, cfg)


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



def _recsys_batch(cfg, B: int, *, train: bool, reduced: bool):
    """(abstract batch, batch spec tags) for one arch kind."""
    i32, f32 = torch.int32, torch.float32
    if cfg.kind == "fm":
        b = {"sparse": SDS((B, cfg.n_sparse), i32)}
        s = {"sparse": "b1"}
    elif cfg.kind == "dcn":
        b = {"dense": SDS((B, cfg.n_dense), f32),
             "sparse": SDS((B, cfg.n_sparse), i32)}
        s = {"dense": "b1", "sparse": "b1"}
    elif cfg.kind == "bst":
        b = {"seq": SDS((B, cfg.seq_len), i32), "target": SDS((B,), i32)}
        s = {"seq": "b1", "target": "b0"}
    elif cfg.kind == "bert4rec":
        b = {"seq": SDS((B, cfg.seq_len), i32)}
        s = {"seq": "b1"}
        if train:
            n_mask = min(N_MASK, cfg.seq_len)
            n_neg = min(N_NEG, cfg.n_items)
            b.update({"mask_pos": SDS((B, n_mask), i32),
                      "labels": SDS((B, n_mask), i32),
                      "neg_ids": SDS((n_neg,), i32)})
            s.update({"mask_pos": "b1", "labels": "b1", "neg_ids": "r"})
    else:
        raise ValueError(cfg.kind)
    if train and cfg.kind != "bert4rec":
        b["label"] = SDS((B,), f32)
        s["label"] = "b0"
    return b, s


def _resolve_batch_specs(tags: dict, rules: ShardRules):
    out = {}
    for k, t in tags.items():
        if t == "b0":
            out[k] = rules.batch_spec()
        elif t == "b1":
            out[k] = rules.batch_spec(None)
        else:
            out[k] = P(None)
    return out


def recsys_cells(arch: str, cfg, rules: ShardRules, *, reduced: bool = False,
                 opt: OptConfig | None = None) -> dict[str, CellSpec]:
    from repro_torch.models.recsys import recsys_param_defs

    shapes = RECSYS_SHAPES_REDUCED if reduced else RECSYS_SHAPES
    defs = recsys_param_defs(cfg)
    pspecs = param_specs(defs, rules)
    opt = opt or OptConfig()
    cells = {}
    for sname, sh in shapes.items():
        B = sh["batch"]
        kind = sh["kind"]
        if kind == "train":
            batch, tags = _recsys_batch(cfg, B, train=True, reduced=reduced)
            fn = make_train_step(functools.partial(_recsys_loss_adapter, cfg=cfg), opt)
            args = (abstract_train_state(defs), batch)
            specs = (train_state_specs(defs, rules), _resolve_batch_specs(tags, rules))
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs, donate=(0,))
        elif kind == "serve":
            batch, tags = _recsys_batch(cfg, B, train=False, reduced=reduced)
            fn = functools.partial(_recsys_serve_adapter, cfg=cfg)
            args = (abstract_params(defs), batch)
            specs = (pspecs, _resolve_batch_specs(tags, rules))
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs)
            cells[sname].build = _recsys_sharded_build(cfg, kind, args, specs)
        elif kind == "retrieval":
            batch, tags = _recsys_batch(cfg, B, train=False, reduced=reduced)
            cand = SDS((sh["cands"], cfg.embed_dim), torch.float32)
            fn = functools.partial(_recsys_retrieval_adapter, cfg=cfg)
            args = (abstract_params(defs), batch, cand)
            specs = (pspecs, _resolve_batch_specs_repl(tags), P("data", None))
            cells[sname] = CellSpec(arch, sname, kind, fn, args, specs)
            cells[sname].build = _recsys_sharded_build(cfg, kind, args, specs)
    return cells


def _recsys_sharded_build(cfg, kind: str, args: tuple, specs: tuple) -> Callable:
    """A serve or retrieval cell's late binding: ``build(mesh) -> (fn, args,
    specs)``, ``fn`` the cell's sharded function over ``mesh``
    (:func:`repro_torch.models.recsys.sharded_cell_fn`) under the cell's own
    specs; ``args`` and ``specs`` cut to the parts ``fn`` reads
    (:func:`repro_torch.models.recsys.sharded_reads`), as the reference's
    jit keeps only the arguments it uses. ``cell.fn`` stays the plain
    adapter, the reference's function."""
    def build(mesh):
        from repro_torch.models.recsys import sharded_cell_fn, sharded_reads
        k = min(100, cfg.n_items) if cfg.kind == "bert4rec" and kind == "serve" else 100
        fn = sharded_cell_fn(cfg, kind, mesh, specs, k=k)
        return (fn, (*sharded_reads(cfg, kind, *args[:2]), *args[2:]),
                (*sharded_reads(cfg, kind, *specs[:2]), *specs[2:]))
    return build


def _resolve_batch_specs_repl(tags: dict):
    return {k: P() if t == "b0" else P(None, None) if t == "b1" else P(None)
            for k, t in tags.items()}


def _recsys_loss_adapter(params, batch, *, cfg):
    from repro_torch.models.recsys import recsys_loss
    return recsys_loss(params, batch, cfg)


def _recsys_serve_adapter(params, batch, *, cfg):
    from repro_torch.models.recsys import bert4rec_serve_topk, recsys_forward
    if cfg.kind == "bert4rec":
        return bert4rec_serve_topk(params, batch["seq"], cfg, k=min(100, cfg.n_items),
                                   device=_device(params))
    return recsys_forward(params, batch, cfg, device=_device(params))


def _recsys_retrieval_adapter(params, batch, cand, *, cfg):
    """The reference's cell ranks ``cand @ u`` with ``lax.top_k``; the port
    takes the same function's fused kernel, K4 (``use_kernel=True``)."""
    from repro_torch.models.recsys import retrieval_topk
    return retrieval_topk(params, batch, cfg, cand, k=min(100, cand.shape[0]),
                          use_kernel=True, device=_device(params))
