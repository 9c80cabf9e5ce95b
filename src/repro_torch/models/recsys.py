"""Recsys architectures, serving: FM, DCN-v2, BST, BERT4Rec — the port of
``repro/models/recsys.py``.

Shared anatomy: huge embedding tables → feature-interaction op → small
MLP → logit. Parameters are the reference's tree (a nested ``dict`` of
tensors); the batch is a dict of arrays or tensors, moved to the
parameters' device.

* FM        — 2-way factorization machine, O(nk) sum-square trick [Rendle '10]
* DCN-v2    — cross layers (x0 ⊙ (W xl + b) + xl) + deep tower [2008.13535]
* BST       — behavior-sequence transformer: a block over the last item
              embeddings (+ target), then an MLP [1905.06874]
* BERT4Rec  — bidirectional transformer over item sequences, next-item
              top-k over the tied item embedding [1904.06690]

Retrieval (``retrieval_topk``) is each model's two-tower factorization: a
user vector dotted against a candidate matrix → top-k, on K4 with
``use_kernel=True`` (the reference's default is ``False``, as here).

Where the kernels sit:

* K6 (:mod:`repro_torch.kernels.embedding_bag`) carries the pooled sums:
  FM's first-order term ``Σ_f linear[ids_f]`` and the FM and DCN-v2 user
  towers (``Σ_f emb[ids_f]``; DCN divides by F after the sum, as
  ``jnp.mean`` does). This is the one departure from the reference, which
  gathers with ``jnp.take`` and sums with ``jnp.sum``: ROADMAP, "Same knobs,
  same defaults". FM's pairwise term keeps the reference's gathered rows
  for both Σv and Σv², so no row is read twice.
* K5 carries the BST and BERT4Rec encoders (:func:`attention`'s default).
* K2 (:mod:`repro_torch.kernels.topk`) takes every top-k, ties to the lowest
  id as ``lax.top_k``; ``torch.topk`` leaves tie order unspecified. With
  ``sharded_topk`` bert4rec ranks its vocabulary per shard of the ambient
  mesh's ``"model"`` axis (:mod:`repro_torch.parallel.compat`) and merges
  the k·M survivors, each step on K2.

Sharded serving (:func:`sharded_cell_fn`, the recsys ``serve`` and
``retrieval`` cells' ``build(mesh)``) runs the same forwards as bodies of
a ``compat.shard_map`` under the cells' specs: the tables row-sharded over
``"model"`` (rows by the exact masked gather + psum, pooled bags by
:func:`~repro_torch.models.embedding.sharded_bag_local`), the batch over the
batch axes, the towers and encoders on every partition's rows, bert4rec's
top-k per vocabulary shard and a K2 merge, a retrieval's candidates over
``"data"`` ranked on K4 per partition and merged by K2. The unsharded
functions above are unchanged.

Every serving entry point takes ``device=None`` (the card; it raises
without one) or ``device="cpu"``; the parameters must already live there,
and it runs under ``torch.inference_mode()``.

The losses (``ctr_loss``, ``masked_item_loss``, ``masked_item_loss_sampled``,
``recsys_loss``) run the same forwards as the reference trains them: plain
gathers (:func:`~repro_torch.models.gather.gather_rows`, whose backward sums
in a fixed order) where serving takes K6, and the chunked plain attention
where serving takes K5; no kernel has a backward. They run on the
parameters' device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.partition import merge_topk
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.attention import attention
from repro_torch.models.common import (ParamDef, count_params, dense, layer_norm, mlp_stack,
                                       mlp_stack_defs, tree_leaves)
from repro_torch.models.embedding import embedding_lookup, sharded_bag_local, sharded_lookup_local
from repro_torch.models.gather import gather_rows
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # fm | dcn | bst | bert4rec
    n_sparse: int = 26              # sparse fields (fm/dcn)
    n_dense: int = 0                # dense features (dcn)
    rows_per_field: int = 1_000_000
    embed_dim: int = 16
    n_items: int = 1_000_000        # item vocab (bst/bert4rec)
    seq_len: int = 20               # behavior-sequence length
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple[int, ...] = (1024, 512, 256)
    n_cross_layers: int = 3
    dtype: Any = torch.float32
    unroll: bool = False            # the reference's dry-run knob; no effect here
    sharded_topk: bool = False      # shard_map local-topk serve (perf)

    def param_count(self) -> int:
        return count_params(recsys_param_defs(self))


# -- parameter defs ---------------------------------------------------------------


def _field_table(cfg: RecsysConfig, dim: int) -> ParamDef:
    """All sparse fields share one hashed (F·R, dim) table."""
    return ParamDef((cfg.n_sparse * cfg.rows_per_field, dim),
                    ("rows", None), init="embed", dtype=cfg.dtype)


def _tx_block_defs(d: int, n_heads: int, dt) -> dict:
    return {
        "wq": ParamDef((d, d), ("embed", "heads"), dtype=dt),
        "wk": ParamDef((d, d), ("embed", "heads"), dtype=dt),
        "wv": ParamDef((d, d), ("embed", "heads"), dtype=dt),
        "wo": ParamDef((d, d), ("heads", "embed"), dtype=dt),
        "ln1_g": ParamDef((d,), (None,), init="ones", dtype=dt),
        "ln1_b": ParamDef((d,), (None,), init="zeros", dtype=dt),
        "ln2_g": ParamDef((d,), (None,), init="ones", dtype=dt),
        "ln2_b": ParamDef((d,), (None,), init="zeros", dtype=dt),
        "ffn": mlp_stack_defs((d, 4 * d, d), dt),
    }


def recsys_param_defs(cfg: RecsysConfig) -> dict:
    dt = cfg.dtype
    if cfg.kind == "fm":
        return {
            "emb": _field_table(cfg, cfg.embed_dim),
            "linear": _field_table(cfg, 1),
            "bias": ParamDef((1,), (None,), init="zeros", dtype=dt),
        }
    if cfg.kind == "dcn":
        d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        out = {
            "emb": _field_table(cfg, cfg.embed_dim),
            "head": ParamDef((cfg.mlp_dims[-1], 1), (None, None), dtype=dt),
            "head_b": ParamDef((1,), (None,), init="zeros", dtype=dt),
            "mlp": mlp_stack_defs((d0,) + tuple(cfg.mlp_dims), dt),
        }
        for i in range(cfg.n_cross_layers):
            out[f"cross_w{i}"] = ParamDef((d0, d0), (None, "mlp"), dtype=dt)
            out[f"cross_b{i}"] = ParamDef((d0,), (None,), init="zeros", dtype=dt)
        return out
    if cfg.kind == "bst":
        d = cfg.embed_dim
        blocks = {f"b{i}": _tx_block_defs(d, cfg.n_heads, dt) for i in range(cfg.n_blocks)}
        feat_dim = (cfg.seq_len + 1) * d
        return {
            "item_emb": ParamDef((cfg.n_items, d), ("rows", None), init="embed", dtype=dt),
            "pos_emb": ParamDef((cfg.seq_len + 1, d), (None, None), init="embed", dtype=dt),
            **blocks,
            "mlp": mlp_stack_defs((feat_dim,) + tuple(cfg.mlp_dims) + (1,), dt),
        }
    if cfg.kind == "bert4rec":
        d = cfg.embed_dim
        blocks = {f"b{i}": _tx_block_defs(d, cfg.n_heads, dt) for i in range(cfg.n_blocks)}
        return {
            # +2 rows: [PAD]=0 is row n_items, [MASK] is row n_items+1
            "item_emb": ParamDef((cfg.n_items + 2, d), ("rows", None), init="embed", dtype=dt),
            "pos_emb": ParamDef((cfg.seq_len, d), (None, None), init="embed", dtype=dt),
            **blocks,
            "out_b": ParamDef((cfg.n_items + 2,), ("rows",), init="zeros", dtype=dt),
        }
    raise ValueError(cfg.kind)


# -- the device rule --------------------------------------------------------------


def _device(params: dict, device) -> torch.device:
    """The entry points' ``device=``: ``None`` means the card (and raises
    without one). The parameters must already live there."""
    dev = resolve_device(device)
    have = tree_leaves(params)[0].device
    if have.type != dev.type:
        raise ValueError(f"the parameters live on {have}, the call asked for {dev}")
    return have


def _on(dev: torch.device, x) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


# -- forward passes ---------------------------------------------------------------


def _flat_ids(cfg: RecsysConfig, sparse_ids: torch.Tensor) -> torch.Tensor:
    """(B,F) per-field ids → int32 global rows in the shared (F·R, ·) table."""
    base = torch.arange(cfg.n_sparse, dtype=torch.int32, device=sparse_ids.device)
    return (sparse_ids.to(torch.int32) + base[None, :] * cfg.rows_per_field).to(torch.int32)


def _ones(ids: torch.Tensor) -> torch.Tensor:
    return torch.ones(ids.shape, dtype=torch.float32, device=ids.device)


def _lookup(table, ids, train: bool):
    """The rows of ``table`` at ``ids``: a gather with a fixed-order
    backward when training, ``index_select`` when serving."""
    return gather_rows(table, ids) if train else embedding_lookup(table, ids)


def _fm(params, batch, cfg: RecsysConfig, dev, train: bool):
    ids = _flat_ids(cfg, _on(dev, batch["sparse"]))
    v = _lookup(params["emb"], ids, train)                    # (B,F,D)
    if train:                                                 # the reference's take + sum
        lin = torch.sum(gather_rows(params["linear"], ids)[..., 0], dim=1)
    else:
        lin = kops.embedding_bag(params["linear"], ids, _ones(ids))[:, 0]
    return params["bias"][0] + lin.to(cfg.dtype) + _fm_pair(v)


def _fm_pair(v: torch.Tensor) -> torch.Tensor:
    """FM's 2-way term of (..., F, D) rows via the O(nk) identity:
    ½[(Σ_f v)² − Σ_f v²] summed over dims → (...)."""
    s = torch.sum(v, dim=-2)                                  # (...,D)
    return 0.5 * torch.sum(s * s - torch.sum(v * v, dim=-2), dim=-1)


@torch.inference_mode()
def fm_forward(params, batch, cfg: RecsysConfig, *, device=None):
    """batch = {sparse (B,F) int}. Returns logits (B,). The first-order
    term is one K6 launch over the (F·R, 1) linear table."""
    return _fm(params, batch, cfg, _device(params, device), False)


@torch.inference_mode()
def dcn_forward(params, batch, cfg: RecsysConfig, *, device=None):
    """batch = {dense (B,n_dense) f32, sparse (B,F) int}. Returns logits (B,)."""
    return _dcn(params, batch, cfg, _device(params, device), False)


def _dcn(params, batch, cfg: RecsysConfig, dev, train: bool):
    ids = _flat_ids(cfg, _on(dev, batch["sparse"]))
    v = _lookup(params["emb"], ids, train)                    # (B,F,D)
    x0 = torch.cat([_on(dev, batch["dense"]).to(cfg.dtype), v.reshape(v.shape[0], -1)], -1)
    return _dcn_tower(params, x0, cfg)


def _dcn_tower(params, x0, cfg: RecsysConfig):
    """The cross layers, the deep tower and the head over (B, d0) rows."""
    x = x0
    for i in range(cfg.n_cross_layers):
        xw = dense(x, params[f"cross_w{i}"]) + params[f"cross_b{i}"]
        x = x0 * xw + x                                       # DCN-v2 cross
    h = mlp_stack(params["mlp"], x)
    return (dense(h, params["head"]) + params["head_b"])[..., 0]


def _tx_block(p, x, n_heads: int, impl=None):
    """Post-LN encoder block (BST/BERT4Rec style), bidirectional, on K5
    (``impl=None``) or the chunked plain path (``"chunked"``)."""
    B, S, d = x.shape
    dh = d // n_heads
    q = dense(x, p["wq"]).reshape(B, S, n_heads, dh).transpose(1, 2)
    k = dense(x, p["wk"]).reshape(B, S, n_heads, dh).transpose(1, 2)
    v = dense(x, p["wv"]).reshape(B, S, n_heads, dh).transpose(1, 2)
    o = attention(q, k, v, **({} if impl is None else {"impl": impl}))   # bidirectional
    o = o.transpose(1, 2).reshape(B, S, d)
    x = layer_norm(x + dense(o, p["wo"]), p["ln1_g"], p["ln1_b"])
    h = mlp_stack(p["ffn"], x)
    return layer_norm(x + h, p["ln2_g"], p["ln2_b"])


def _encode(params, seq: torch.Tensor, cfg: RecsysConfig, train: bool = False) -> torch.Tensor:
    """Item embeddings + positions through the blocks: (B,S) → (B,S,D)."""
    return _encoder(params, _lookup(params["item_emb"], seq, train), cfg, train)


def _encoder(params, x: torch.Tensor, cfg: RecsysConfig, train: bool = False) -> torch.Tensor:
    """Positions added to the item rows (B,S,D), then the blocks."""
    x = x + params["pos_emb"][None, : x.shape[1]]
    for i in range(cfg.n_blocks):
        x = _tx_block(params[f"b{i}"], x, cfg.n_heads, "chunked" if train else None)
    return x


def _bst(params, batch, cfg: RecsysConfig, dev, train: bool):
    seq = torch.cat([_on(dev, batch["seq"]), _on(dev, batch["target"])[:, None]], dim=1)
    x = _encode(params, seq, cfg, train)
    return mlp_stack(params["mlp"], x.reshape(x.shape[0], -1))[..., 0]


def _bert4rec(params, batch, cfg: RecsysConfig, dev, train: bool):
    x = _encode(params, _on(dev, batch["seq"]), cfg, train)
    return x @ params["item_emb"].T + params["out_b"]


@torch.inference_mode()
def bst_forward(params, batch, cfg: RecsysConfig, *, device=None):
    """batch = {seq (B,S) int item history, target (B,) int}.

    Transformer over [history ; target] with position embeddings, then the
    flattened sequence through the MLP tower → CTR logit (B,)."""
    return _bst(params, batch, cfg, _device(params, device), False)


@torch.inference_mode()
def bert4rec_forward(params, batch, cfg: RecsysConfig, *, device=None):
    """batch = {seq (B,S) int with [MASK]=n_items+1, [PAD]=n_items}.

    Returns logits (B,S,n_items+2) via the tied item embedding."""
    return _bert4rec(params, batch, cfg, _device(params, device), False)


_FORWARDS = {"fm": _fm, "dcn": _dcn, "bst": _bst, "bert4rec": _bert4rec}


def recsys_forward(params, batch, cfg: RecsysConfig, *, device=None):
    fn = {"fm": fm_forward, "dcn": dcn_forward, "bst": bst_forward,
          "bert4rec": bert4rec_forward}[cfg.kind]
    return fn(params, batch, cfg, device=device)


# -- losses ---------------------------------------------------------------------------


def _train_forward(params, batch, cfg: RecsysConfig):
    """The training forward: plain gathers and attention, on the
    parameters' device, differentiable."""
    return _FORWARDS[cfg.kind](params, batch, cfg, tree_leaves(params)[0].device, True)


def ctr_loss(params, batch, cfg: RecsysConfig):
    """Binary logloss for fm/dcn/bst. batch['label'] (B,) in {0,1}."""
    logits = _train_forward(params, batch, cfg).float()
    y = _on(logits.device, batch["label"]).float()
    ll = torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    loss = torch.mean(ll)
    auc_proxy = torch.mean(((logits > 0) == (y > 0.5)).float())
    return loss, {"loss": loss, "acc": auc_proxy}


def _masked_nll(logits32, labels) -> torch.Tensor:
    """Mean over the valid labels (≥ 0) of logsumexp − the gold logit."""
    valid = labels >= 0
    lab = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, lab[..., None])[..., 0]
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def masked_item_loss(params, batch, cfg: RecsysConfig):
    """BERT4Rec masked-item CE. batch = {seq, labels (B,S) int, -1=unmasked}."""
    logits = _train_forward(params, batch, cfg).float()
    loss = _masked_nll(logits, _on(logits.device, batch["labels"]).long())
    return loss, {"loss": loss}


def masked_item_loss_sampled(params, batch, cfg: RecsysConfig):
    """Sampled-softmax masked-item loss — the production path for 10⁶-item
    vocabs.

    batch = {seq (B,S), mask_pos (B,P) int, labels (B,P) int (-1 pad),
             neg_ids (N,) int} — negatives shared across the batch (uniform
    sampling, no log-uniform correction, as the reference)."""
    dev = tree_leaves(params)[0].device
    x = _encode(params, _on(dev, batch["seq"]), cfg, True)          # (B,S,D)
    B, S, D = x.shape
    mask_pos = _on(dev, batch["mask_pos"]).long()
    rows = mask_pos + S * torch.arange(B, device=dev)[:, None]
    xm = gather_rows(x.reshape(B * S, D), rows)                      # (B,P,D)
    labels = _on(dev, batch["labels"]).long()
    valid = labels >= 0
    lab = torch.clamp(labels, min=0)
    neg_ids = _on(dev, batch["neg_ids"]).long()
    pos_emb = gather_rows(params["item_emb"], lab)                   # (B,P,D)
    pos_b = gather_rows(params["out_b"], lab)
    neg_emb = gather_rows(params["item_emb"], neg_ids)               # (N,D)
    neg_b = gather_rows(params["out_b"], neg_ids)
    logit_pos = torch.sum(xm * pos_emb, dim=-1) + pos_b              # (B,P)
    logit_neg = torch.einsum("bpd,nd->bpn", xm, neg_emb) + neg_b     # (B,P,N)
    all_logits = torch.cat([logit_pos[..., None], logit_neg], dim=-1)
    lse = torch.logsumexp(all_logits.float(), dim=-1)
    nll = torch.where(valid, lse - logit_pos.float(), 0.0)
    loss = nll.sum() / torch.clamp(valid.sum(), min=1)
    return loss, {"loss": loss}


def recsys_loss(params, batch, cfg: RecsysConfig):
    if cfg.kind == "bert4rec":
        if "mask_pos" in batch:
            return masked_item_loss_sampled(params, batch, cfg)
        return masked_item_loss(params, batch, cfg)
    return ctr_loss(params, batch, cfg)


_bert4rec_hidden = _encode                                    # the reference's name

BERT4REC_CHUNK = 2048          # sequences bert4rec_serve_topk encodes and ranks at a time


@torch.inference_mode()
def bert4rec_serve_topk(params, seq, cfg: RecsysConfig, *, k: int = 100,
                        chunk: int = BERT4REC_CHUNK, device=None):
    """Next-item top-k over the full vocab, ``chunk`` sequences at a time so
    that the (chunk, V) score tile stays bounded; the batch is padded with
    [PAD] to a multiple of ``chunk``, as the reference's scan needs. Returns
    (vals, ids int32), each (B, k); the top-k is K2's. ``cfg.sharded_topk``
    ranks per vocabulary shard of the ambient mesh instead."""
    dev = _device(params, device)
    seq = _on(dev, seq)
    B = seq.shape[0]
    chunk = min(chunk, B)
    pad = (-B) % chunk
    if pad:
        seq = F.pad(seq, (0, 0, 0, pad), value=cfg.n_items)
    vals, ids = [], []
    for s in seq.split(chunk):
        x = _bert4rec_hidden(params, s, cfg)[:, -1]          # (chunk, D)
        if cfg.sharded_topk:
            v, i = _sharded_vocab_topk(x, params["item_emb"], params["out_b"], k)
        else:
            logits = x @ params["item_emb"].T + params["out_b"]
            v, i = kops.topk(logits.float(), k)
        vals.append(v)
        ids.append(i)
    return torch.cat(vals)[:B], torch.cat(ids)[:B]


def _sharded_vocab_topk(x, emb, bias, k: int, *, axis: str = "model"):
    """Per-vocab-shard scoring + local top-k + k·M merge — on a rank mesh the
    full (chunk, V) logits never meet on one device. Requires an ambient
    mesh with `axis`; emb rows sharded over `axis`. The shards' survivors
    leave the shard_map all-gathered over `axis` (its out-spec), and one K2
    merge of the (chunk, k·M) row follows."""

    def local(xl, el, bl):
        j = compat.axis_index(axis)                        # (L,)
        L, v_loc, d = el.shape
        # x is replicated: its one copy meets every shard held here in one
        # GEMM, (chunk, L·V_loc), whose row b holds the L shards' logits in turn
        logits = xl[0] @ el.reshape(L * v_loc, d).T + bl.reshape(-1)
        lv, li = kops.topk(logits.float().reshape(-1, v_loc), k)       # rows (b, shard)
        lv = lv.view(-1, L, k).transpose(0, 1)                       # (L, chunk, k)
        li = li.view(-1, L, k).transpose(0, 1) + (j * v_loc).to(torch.int32).view(L, 1, 1)
        return lv, li

    gv, gi = compat.shard_map(local, None,
                              in_specs=(P(), P(axis, None), P(axis)),
                              out_specs=(P(None, axis), P(None, axis)))(x, emb, bias)
    return merge_topk(gv, gi, k)


# -- retrieval tower ----------------------------------------------------------------


@torch.inference_mode()
def user_vector(params, batch, cfg: RecsysConfig, *, device=None) -> torch.Tensor:
    """User-side tower → (B, D) for candidate dot-scoring. FM and DCN-v2
    pool their fields' rows with one K6 launch."""
    dev = _device(params, device)
    if cfg.kind in ("fm", "dcn"):
        ids = _flat_ids(cfg, _on(dev, batch["sparse"]))
        u = kops.embedding_bag(params["emb"], ids, _ones(ids)).to(cfg.dtype)
        if cfg.kind == "dcn":                                 # the mean: sum, then / F
            u = u / torch.tensor(float(cfg.n_sparse), dtype=u.dtype, device=dev)
        return u
    if cfg.kind == "bst":
        return torch.mean(_encode(params, _on(dev, batch["seq"]), cfg), dim=1)
    if cfg.kind == "bert4rec":
        return _encode(params, _on(dev, batch["seq"]), cfg)[:, -1]   # last position
    raise ValueError(cfg.kind)


@torch.inference_mode()
def retrieval_topk(params, batch, cfg: RecsysConfig, cand, k: int = 100, *,
                   use_kernel: bool = False, device=None):
    """Score 1 query (batch of 1) against cand (N, D) → top-k (vals, ids
    int32): K4 with ``use_kernel=True``, else a matmul and K2's top-k."""
    u = user_vector(params, batch, cfg, device=device)[0].float()   # (D,)
    cand = _on(u.device, cand).float()
    if use_kernel:
        return kops.dot_topk(u, cand, k)
    return kops.topk(cand @ u, k)


# -- sharded serving: the serve and retrieval cells over a mesh ---------------------

ROW_TABLES = ("emb", "linear", "item_emb", "out_b")   # the leaves whose rows shard over model


def _replicated(params: dict) -> dict:
    """Inside a body: every leaf but the row-sharded tables, as its first
    copy. The specs replicate them, so the partitions held carry one value,
    and the towers and encoders run once over all the rows held."""
    return {key: _replicated(v) if isinstance(v, dict) else v[0]
            for key, v in params.items() if key not in ROW_TABLES}


def _rows_local(params, seq: torch.Tensor) -> torch.Tensor:
    """(L, b, S) item ids → (L·b, S, D) item rows: the masked gather of each
    shard's rows and the psum over ``model`` (exact)."""
    return sharded_lookup_local(params["item_emb"], seq).flatten(0, 1)


def _fm_local(params, batch, cfg: RecsysConfig):
    ids = _flat_ids(cfg, batch["sparse"])                     # (L,b,F)
    v = sharded_lookup_local(params["emb"], ids)              # (L,b,F,D)
    lin = sharded_bag_local(params["linear"], ids)[..., 0]    # (L,b), one K6 launch
    return params["bias"][:, :1] + lin.to(cfg.dtype) + _fm_pair(v)


def _dcn_local(params, batch, cfg: RecsysConfig):
    ids = _flat_ids(cfg, batch["sparse"])
    L, b = ids.shape[:2]
    v = sharded_lookup_local(params["emb"], ids)
    x0 = torch.cat([batch["dense"].to(cfg.dtype), v.reshape(L, b, -1)], -1)
    return _dcn_tower(_replicated(params), x0.flatten(0, 1), cfg).view(L, b)


def _bst_local(params, batch, cfg: RecsysConfig):
    seq = torch.cat([batch["seq"], batch["target"][..., None]], dim=-1)
    L, b = seq.shape[:2]
    rep = _replicated(params)
    x = _encoder(rep, _rows_local(params, seq), cfg)
    return mlp_stack(rep["mlp"], x.reshape(L * b, -1))[..., 0].view(L, b)


def bert4rec_chunk(rows_held: int, vocab: int, chunk: int = BERT4REC_CHUNK) -> int:
    """Sequences a sharded body scores at a time when its partitions hold
    ``rows_held`` vocabulary rows in all: the (sequences, rows) tile stays
    at most ``chunk`` × ``vocab`` scores, as the unsharded one."""
    return max(1, chunk * vocab // max(rows_held, 1))


def _bert4rec_local(params, batch, cfg: RecsysConfig, k: int):
    """Each shard's next-item top-k over its vocabulary rows, chunk by
    chunk of its block of sequences (padded with [PAD] to the chunk, which
    is never larger than the block): (L, b, k) values and global ids. The
    scoring of :func:`_sharded_vocab_topk`, whose query rows are replicated
    (one GEMM meets every shard held); here each partition holds its own
    block of the batch, so each scores its rows against its shard."""
    seq = batch["seq"]
    L, b = seq.shape[:2]
    el, bl = params["item_emb"], params["out_b"]              # (L,V_l,D), (L,V_l)
    v_loc = el.shape[1]
    k_loc = min(k, v_loc)
    first = (compat.axis_index("model") * v_loc).to(torch.int32).view(L, 1, 1)
    rep = _replicated(params)
    chunk = min(b, bert4rec_chunk(L * v_loc, cfg.n_items + 2))
    pad = (-b) % chunk
    if pad:
        seq = F.pad(seq, (0, 0, 0, pad), value=cfg.n_items)
    vals, ids = [], []
    for s in seq.split(chunk, dim=1):
        x = _encoder(rep, _rows_local(params, s), cfg)[:, -1].view(L, chunk, -1)
        logits = x @ el.transpose(1, 2) + bl[:, None, :]      # (L,chunk,V_l)
        v, i = kops.topk(logits.float().reshape(L * chunk, v_loc), k_loc)
        vals.append(v.view(L, chunk, k_loc))
        ids.append(i.view(L, chunk, k_loc) + first)
    return torch.cat(vals, 1)[:, :b], torch.cat(ids, 1)[:, :b]


def _user_local(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """``user_vector`` inside a body: (L, b, D). FM and DCN-v2 pool their
    fields' rows with :func:`sharded_bag_local` (one K6 launch)."""
    if cfg.kind in ("fm", "dcn"):
        u = sharded_bag_local(params["emb"], _flat_ids(cfg, batch["sparse"])).to(cfg.dtype)
        if cfg.kind == "dcn":                                 # the mean: sum, then / F
            u = u / torch.tensor(float(cfg.n_sparse), dtype=u.dtype, device=u.device)
        return u
    L, b = batch["seq"].shape[:2]
    x = _encoder(_replicated(params), _rows_local(params, batch["seq"]), cfg)
    u = torch.mean(x, dim=1) if cfg.kind == "bst" else x[:, -1]
    return u.view(L, b, -1)


def _retrieval_local(params, batch, cand, cfg: RecsysConfig, k: int):
    """The query's user vector (replicated), then each partition's top-k
    of its block of candidates on K4, its ids made global by the block's
    first row: (L, 1, k_local) values and ids."""
    u = _user_local(params, batch, cfg)[:, 0].float()         # (L,D)
    L, n = cand.shape[:2]
    k_loc = min(k, n)
    first = (compat.axis_index("data") * n).to(torch.int32)
    vals, ids = [], []
    for p in range(L):
        v, i = kops.dot_topk(u[p], cand[p].float(), k_loc)
        vals.append(v)
        ids.append(i + first[p])
    return torch.stack(vals)[:, None], torch.stack(ids)[:, None]


_SERVE_BODIES = {"fm": _fm_local, "dcn": _dcn_local, "bst": _bst_local}


def sharded_reads(cfg: RecsysConfig, kind: str, params: dict, batch: dict) -> tuple[dict, dict]:
    """The parts of a cell's parameter and batch trees (values or specs)
    that its sharded function reads: all for ``serve``; for ``retrieval``
    the user tower's alone (the reference's jit drops the rest, its
    ``keep_unused`` being off)."""
    if kind != "retrieval":
        return params, batch
    if cfg.kind in ("fm", "dcn"):
        keys, feats = ["emb"], ["sparse"]
    else:
        keys, feats = ["item_emb", "pos_emb"] + [f"b{i}" for i in range(cfg.n_blocks)], ["seq"]
    return {k: params[k] for k in keys}, {k: batch[k] for k in feats}


def sharded_cell_fn(cfg: RecsysConfig, kind: str, mesh, specs: tuple, *, k: int = 100):
    """A recsys ``serve`` or ``retrieval`` cell's function over ``mesh``: its
    body in a ``compat.shard_map`` under the cell's ``specs`` (tables
    row-sharded over ``model``, the batch over the batch axes, a
    retrieval's candidates over ``data``). Takes the cell's arguments, with
    the parameters already on the mesh's device, and returns what the
    plain cell returns (it reads only :func:`sharded_reads`' parts):

    * ``serve``: logits (B,), each batch block's forward on its
      partitions; bert4rec's (vals, ids) (B, k): each vocabulary shard's
      top-k of its rows, gathered over ``model`` by the out-spec, then one
      K2 merge of the (B, k·M) rows;
    * ``retrieval``: (vals, ids) (k,) of the one query: each ``data``
      block's top-k on K4, gathered over ``data`` by the out-spec, then
      one K2 merge. Lowest ids win ties: the blocks are in id order.

    A dimension that does not split evenly over its axes is refused
    (``ValueError``), as the reference's jit refuses it; a meta mesh traces
    it at its padded block (:meth:`~repro_torch.parallel.compat.StackedMesh.shard`)
    and the output is cut back to the batch."""
    pspecs, bspecs = sharded_reads(cfg, kind, specs[0], specs[1])
    if kind == "retrieval":
        body = functools.partial(_retrieval_local, cfg=cfg, k=k)
        out = (P(None, "data"), P(None, "data"))
    elif cfg.kind == "bert4rec":
        body = functools.partial(_bert4rec_local, cfg=cfg, k=k)
        lead = bspecs["seq"][0]
        out = (P(lead, "model"), P(lead, "model"))
    else:
        body = functools.partial(_SERVE_BODIES[cfg.kind], cfg=cfg)
        out = P(next(iter(bspecs.values()))[0])
    mapped = compat.shard_map(body, mesh, in_specs=(pspecs, bspecs, *specs[2:]), out_specs=out)

    @torch.inference_mode()
    def run(params, batch, *cand):
        have = tree_leaves(params)[0].device
        if have.type != mesh.device.type:
            raise ValueError(f"the parameters live on {have}, the mesh on {mesh.device}")
        params, batch = sharded_reads(cfg, kind, params, batch)
        if kind == "retrieval":
            gv, gi = mapped(params, batch, *cand)
            v, i = merge_topk(gv, gi, min(k, cand[0].shape[0]))
            return v[0], i[0]
        B = next(iter(batch.values())).shape[0]
        if cfg.kind == "bert4rec":
            gv, gi = mapped(params, batch)
            return merge_topk(gv[:B], gi[:B], k)
        return mapped(params, batch)[:B]

    return run
