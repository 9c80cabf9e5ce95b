"""Expert-parallel MoE via ``shard_map`` — the port of
``repro/models/moe_ep.py``, on :mod:`repro_torch.parallel.compat`.

The global ``moe_ffn`` (:mod:`repro_torch.models.moe`) dispatches every
expert in one place. This module writes the distributed algorithm
explicitly:

* tokens are sharded over the batch axes (``data`` [, ``pod``]) and
  replicated over ``model``;
* experts are sharded over ``model`` (E_loc = E / M per shard);
* each (data, model) partition routes *its* token shard, keeps only the
  assignments that land on *its* local experts, runs the local expert FFNs
  at fixed capacity, and the routed outputs are psum'd over ``model``.

Activations are replicated over the model axis, so no all_to_all is
needed: dispatch and combine collapse into the one psum.

The body sees compat's leading partition dimension L (1 on a rank mesh, all
partitions on a stacked one) and runs :mod:`~repro_torch.models.moe`'s
helpers over it: the router's top-k is one K2 call over every partition's
tokens, and each partition's combine sums its kept slots in ascending
expert order. compat has no ``pmean``: the aux statistics take ``psum``
over the batch axes divided by their size.

On a :class:`~repro_torch.parallel.compat.StackedMesh` the expert weights'
shard is a view while ``data`` is 1; with ``data > 1`` every expert is
copied once per data coordinate, so the card runs EP at ``data = 1``.

Numerics match ``moe_ffn_dense_oracle`` whenever capacity is ample (tests
enforce on stacked and rank meshes).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models.moe import (MoEConfig, _balance, _dispatch, _route, _routed, _shared,
                                    expert_capacity)
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P


def _ep_local(router, wg, wi, wo, shared, x, *, cfg: MoEConfig, ep_axis: str,
              batch_axes: tuple[str, ...]):
    """Per-partition body. x (L, B_loc, S, d); wg/wi/wo (L, E_loc, ·, ·)."""
    L, Bl, S, d = x.shape
    xt = x.reshape(L, Bl * S, d)
    T = xt.shape[1]
    E = cfg.n_experts
    E_loc = wg.shape[1]
    j = compat.axis_index(ep_axis)

    probs, gate, expert = _route(xt, router, cfg)

    # aux load-balance on GLOBAL stats (the mean over the token shards)
    me, ce = _balance(probs, expert)
    mesh = compat.ambient_mesh()
    for ax in batch_axes:
        me = compat.psum(me, ax) / mesh.shape[ax]
        ce = compat.psum(ce, ax) / mesh.shape[ax]
    aux = E * torch.sum(me * ce, dim=-1)                   # (L,)

    # local-expert dispatch: this shard owns experts [j·E_loc, (j+1)·E_loc)
    y = _routed(xt, wg, wi, wo, gate, expert, j * E_loc, expert_capacity(T, cfg))
    y = compat.psum(y, ep_axis)                            # combine experts

    if shared is not None:
        y = y + _shared(xt, *shared)
    return y.reshape(L, Bl, S, d), aux


def _ep_tables(router, x, *, cfg: MoEConfig, ep_axis: str, E_loc: int):
    """The body's routing and dispatch alone: (keep (L, T, K), slots
    (L, E_loc, C)) — for holding EP's tables against the global ones."""
    L, Bl, S, d = x.shape
    xt = x.reshape(L, Bl * S, d)
    _, _, expert = _route(xt, router, cfg)
    keep, _, slots = _dispatch(expert, compat.axis_index(ep_axis) * E_loc, E_loc,
                               expert_capacity(xt.shape[1], cfg))
    return compat.psum(keep.long(), ep_axis) > 0, slots


def _specs(p, ep_axis: str, batch_axes: tuple[str, ...]):
    bax = batch_axes[0] if len(batch_axes) == 1 else tuple(batch_axes)
    return P(bax, None, None), P(ep_axis, None, None)


def ep_moe_ffn(p, x, cfg: MoEConfig, *, ep_axis: str = "model",
               batch_axes: tuple[str, ...] = ("data",), mesh=None):
    """x (B, S, d) → (y, aux). Runs on ``mesh`` or, when None, the ambient
    mesh (:func:`repro_torch.parallel.compat.use_mesh`), whose axes include
    ``ep_axis`` and ``batch_axes``, with E % mesh[ep_axis] == 0."""
    if x.dim() == 2:                                       # (T, d) → (T, 1, d)
        y, aux = ep_moe_ffn(p, x[:, None, :], cfg, ep_axis=ep_axis,
                            batch_axes=batch_axes, mesh=mesh)
        return y[:, 0, :], aux

    bspec, pspec_e = _specs(p, ep_axis, batch_axes)
    shared = None
    shared_specs = None
    if "shared_wg" in p:
        shared = (p["shared_wg"], p["shared_wi"], p["shared_wo"])
        shared_specs = (P(), P(), P())

    fn = compat.shard_map(
        functools.partial(_ep_local, cfg=cfg, ep_axis=ep_axis, batch_axes=tuple(batch_axes)),
        mesh,
        in_specs=(P(), pspec_e, pspec_e, pspec_e, shared_specs, bspec),
        out_specs=(bspec, P()),
    )
    return fn(p["router"], p["wg"], p["wi"], p["wo"], shared, x)


def ep_tables(p, x, cfg: MoEConfig, *, ep_axis: str = "model",
              batch_axes: tuple[str, ...] = ("data",), mesh=None):
    """:func:`ep_moe_ffn`'s routing and dispatch alone, gathered over the
    mesh: the kept assignments (B·S, K) and, at ``data`` = 1, the slot
    tables (E, C), which must equal the global dispatch's
    (:func:`repro_torch.models.moe._tables`)."""
    bspec, _ = _specs(p, ep_axis, batch_axes)
    m = mesh if mesh is not None else compat.ambient_mesh()
    E_loc = cfg.n_experts // m.shape[ep_axis]
    fn = compat.shard_map(
        functools.partial(_ep_tables, cfg=cfg, ep_axis=ep_axis, E_loc=E_loc), mesh,
        in_specs=(P(), bspec), out_specs=(P(bspec[0], None), P(ep_axis, None)))
    return fn(p["router"], x)
