"""Embedding lookup and EmbeddingBag — the port of ``repro/models/embedding.py``.

* ``embedding_lookup`` — ``index_select`` of whole rows (the reference's
  ``jnp.take``).
* ``sharded_lookup_shardmap`` — the mod-sharded lookup written explicitly
  with shard_map + psum over a mesh (:mod:`repro_torch.parallel.compat`: one
  table shard per rank, or all stacked on one card): each shard gathers the
  rows it owns, zeros elsewhere, and the sum over the ``"model"`` axis
  rebuilds the lookup exactly (one shard contributes each row).
* ``sharded_bag_local`` — K6's pooled sum over row-sharded tables inside a
  shard_map body: each shard's rows summed by one K6 launch for all the
  shards held, then a ``psum`` of the (…, D) partial sums over ``"model"``
  (a sum in another order than the unsharded K6's).
* ``embedding_bag`` — ``torch.nn.EmbeddingBag`` semantics in the offsets
  form: the ragged bags are laid out as padded ``(n_bags, L_max)`` ids and
  weights (pad id -1) and summed by K6
  (:func:`repro_torch.kernels.embedding_bag.embedding_bag`: the hand kernel on
  a CUDA tensor, its twin on a CPU tensor). The reference gathers, scales
  and ``segment_sum``\\ s instead; its order on the CPU is the bag's, slot by
  slot, which is K6's.

The tables are the "index in S3" of the paper's state/compute split for
recsys: hydrated into device memory by the serving runtime, row-partitioned
like the paper's §3 document partitions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag as _k6
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P


def embedding_lookup(table: torch.Tensor, idx) -> torch.Tensor:
    """table (R, D), idx (...,) int in [0, R) → (..., D)."""
    idx = torch.as_tensor(idx, device=table.device)
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, table.shape[1])


def sharded_lookup_local(table_shard: torch.Tensor, idx: torch.Tensor,
                         axis_name: str = "model") -> torch.Tensor:
    """Inside shard_map: each shard owns rows [lo, lo+R_local); masked local
    gather + psum reconstructs the full lookup. ``table_shard`` (L, R_local,
    D) and ``idx`` (L, ...) carry the mesh's leading partition dimension."""
    L, R_local = table_shard.shape[:2]
    shard = compat.axis_index(axis_name).view(L, *[1] * (idx.dim() - 1))
    local = idx - shard * R_local
    ok = (local >= 0) & (local < R_local)
    safe = torch.clamp(local, 0, R_local - 1).reshape(L, -1)
    rows = table_shard[torch.arange(L, device=idx.device)[:, None], safe]
    rows = rows.view(*idx.shape, table_shard.shape[2])
    vals = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return compat.psum(vals, axis_name)


def sharded_bag_local(table_shard: torch.Tensor, idx: torch.Tensor,
                      axis_name: str = "model") -> torch.Tensor:
    """Inside shard_map: K6's pooled sum ``Σ_f table[idx[..., f]]`` over
    row-sharded tables. Each shard sums the rows it owns (an id it does
    not own becomes K6's pad id -1), all shards' blocks in one K6 launch
    (the (L, R_local, D) blocks flattened, each shard's ids offset by its
    place in them), then ``psum`` over ``axis_name`` adds the (..., D)
    partial sums in shard order. ``table_shard`` (L, R_local, D), ``idx``
    (L, ..., F) global ids → (L, ..., D) f32.

    The sum's order is not the unsharded K6's (each bag's slots in turn):
    a shard's slots, then the shards. Two orders of F terms differ by at
    most 2·(F-1)·2⁻²⁴·Σ_f|row_f| in each dimension."""
    L, R_local, D = table_shard.shape
    if L * R_local >= 2 ** 31:
        raise ValueError(f"{L} blocks of {R_local} rows exceed K6's int32 ids")
    lead = idx.shape[:-1]
    shard = compat.axis_index(axis_name).view(L, *[1] * (idx.dim() - 1))
    local = idx.long() - shard * R_local
    ok = (local >= 0) & (local < R_local)
    base = torch.arange(L, device=idx.device).view(L, *[1] * (idx.dim() - 1)) * R_local
    flat = torch.where(ok, local + base, -1).to(torch.int32).reshape(-1, idx.shape[-1])
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    partial = _k6(table_shard.reshape(L * R_local, D), flat, ones)
    return compat.psum(partial.view(*lead, D), axis_name)


def sharded_lookup_shardmap(mesh, table, idx, *, axis_name: str = "model",
                            batch_axis: "str | None" = "data") -> torch.Tensor:
    """Explicit mod-sharded lookup: table rows on `axis_name`, batch on
    `batch_axis`; output batch-sharded, feature-replicated (returned whole,
    on the mesh's device)."""
    bspec = P(batch_axis) if batch_axis else P()
    fn = compat.shard_map(
        lambda t, i: sharded_lookup_local(t, i, axis_name),
        mesh,
        in_specs=(P(axis_name, None), bspec),
        out_specs=bspec,
    )
    return fn(table, idx)


def embedding_bag(table: torch.Tensor, indices, offsets, n_bags: int, *,
                  weights=None, mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag`` semantics (offsets form, fixed ``n_bags``).

    indices (L,) int; offsets (n_bags,) int, non-decreasing — bag b covers
    ``indices[offsets[b]:offsets[b+1]]``, the last bag runs to the end, and
    positions before ``offsets[0]`` belong to no bag; weights (L,) optional.
    ``"mean"`` divides each sum by ``max(count, 1)``. Sums are f32 (K6) and
    come back in the table's dtype, where the reference sums a bf16 table in
    bf16."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    dev = table.device
    indices = torch.as_tensor(indices, device=dev)
    offsets = torch.as_tensor(offsets, device=dev).long()
    L = indices.shape[0]
    pos = torch.arange(L, device=dev)
    bag = torch.searchsorted(offsets, pos, right=True) - 1
    live = (bag >= 0) & (bag < n_bags)
    bag, pos = bag[live], pos[live]
    slot = pos - offsets[bag]
    count = torch.bincount(bag, minlength=n_bags)[:n_bags]
    width = int(count.max()) if bag.numel() else 0
    idx = torch.full((n_bags, width), -1, dtype=torch.int32, device=dev)
    w = torch.zeros((n_bags, width), dtype=torch.float32, device=dev)
    idx[bag, slot] = indices[pos].to(torch.int32)
    w[bag, slot] = (torch.as_tensor(weights, device=dev)[pos].float()
                    if weights is not None else 1.0)
    out = _k6(table, idx, w)
    if mode == "mean":
        out = out / torch.clamp(count, min=1).float()[:, None]
    return out.to(table.dtype)
