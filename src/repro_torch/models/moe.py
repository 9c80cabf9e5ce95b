"""Mixture-of-Experts FFN: top-k routing, capacity dispatch, EP-shardable —
the port of ``repro/models/moe.py``.

Dispatch is the scatter-by-rank scheme (GShard/Switch semantics with token
dropping on overflow) — memory scales with tokens·topk·cf·d, never with a
(tokens, E, capacity) one-hot:

    logits → top-k (experts, weights)
    rank r of each assignment within its expert (a stable sort by expert)
    keep if r < capacity; scatter token index into (E, C) slot table
    gather x → (E, C, d); per-expert GEMMs; combine

The router's top-k is :func:`repro_torch.kernels.topk.topk` — K2 on the
card, its twin on the CPU — whose ties go to the lowest expert id, as in
``lax.top_k``. The ranks, the slot table with its dump column and the drops
are integer work, exact. The per-expert products are ``torch.bmm``.

The dispatch's and the combine's row gathers are
:func:`~repro_torch.models.gather.gather_rows`: the same rows forward (an
``index_select``), and a backward that sums the rows sharing a source in a
fixed order, so a train step through the MoE gives the same bits every run.

The combine is where this differs in form from the reference, which
scatter-adds every slot's weighted output into ``y``. ``index_add_`` on the
card adds with float atomics, and a token sits in up to K slots, so its
sum's order would change from run to run. Here each token sums its kept
slots in ascending expert order, in ``ye``'s dtype, one rounding per add,
from zero: the reference's sequential scatter order, the same on every run.

Supports DeepSeek-style shared experts (always-on dense experts added to the
routed output) and an auxiliary load-balance loss (Switch §2.2).

The helpers take a leading partition dimension L (1 here; the partitions a
process holds under :mod:`repro_torch.models.moe_ep`'s ``shard_map``), so
that the global and the expert-parallel paths run the same code.

``moe_ffn_dense_oracle`` computes every expert for every token (dropless) —
the small-scale correctness oracle: with ample capacity the two must agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.topk import topk
from repro_torch.models.common import ParamDef, dense
from repro_torch.models.gather import gather_rows


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    n_shared: int = 0              # DeepSeek shared experts
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32


def moe_defs(cfg: MoEConfig, dtype) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    defs = {
        "router": ParamDef((d, E), ("embed", None), dtype=torch.float32),
        "wg": ParamDef((E, d, f), ("experts", "embed", "mlp"), dtype=dtype),
        "wi": ParamDef((E, d, f), ("experts", "embed", "mlp"), dtype=dtype),
        "wo": ParamDef((E, f, d), ("experts", "mlp", "embed"), dtype=dtype),
    }
    if cfg.n_shared:
        S = cfg.n_shared
        defs["shared_wg"] = ParamDef((S, d, f), (None, "embed", "mlp"), dtype=dtype)
        defs["shared_wi"] = ParamDef((S, d, f), (None, "embed", "mlp"), dtype=dtype)
        defs["shared_wo"] = ParamDef((S, f, d), (None, "mlp", "embed"), dtype=dtype)
    return defs


def _expert_ffn(wg, wi, wo, x):
    """x (E, C, d) → (E, C, d); SwiGLU per expert."""
    h = F.silu(torch.bmm(x, wg))
    h = h * torch.bmm(x, wi)
    return torch.bmm(h, wo)


def expert_capacity(T: int, cfg: MoEConfig) -> int:
    """Slots an expert has for T tokens: max(1, ⌈T·K/E·cf⌉)."""
    return max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def _route(xt, router, cfg: MoEConfig):
    """xt (L, T, d), router (d, E) or (L, d, E) → probs (L, T, E), the
    renormalised top-k gates (L, T, K) and experts (L, T, K) int64.

    K2 ranks a detached f32 copy of the probabilities, as only its ids are
    needed; the gates are gathered from ``probs`` at those ids, so they
    carry the router's gradient (K2 has no backward). In f32 the gathered
    values are K2's own, bit for bit."""
    rd = cfg.router_dtype
    probs = torch.softmax(dense(xt.to(rd), router.to(rd)), dim=-1)
    L, T, E = probs.shape
    _, ids = topk(probs.detach().reshape(L * T, E).float(), cfg.top_k)
    ids = ids.reshape(L, T, -1).long()
    gate = probs.gather(-1, ids)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, ids


def _balance(probs, expert):
    """The aux loss's statistics: mean router probability and top-1 share
    per expert, (L, E) each."""
    E = probs.shape[-1]
    me = probs.float().mean(dim=1)
    ce = F.one_hot(expert[..., 0], E).float().mean(dim=1)
    return me, ce


def _dispatch(expert, lo, E_loc: int, C: int):
    """Slot tables of the experts [lo, lo + E_loc) of each partition.

    expert (L, T, K) global ids, lo (L,). Returns keep (L, T, K) bool (the
    assignment is this partition's and its rank within its expert is below
    C), slot (L, T, K) the kept assignment's flat slot e·C + c (E_loc·C, the
    dump, where not kept) and slots (L, E_loc, C) the token in each slot (T
    where empty)."""
    L, T, K = expert.shape
    flat = expert.reshape(L, T * K)
    local = flat - lo[:, None]
    mine = (local >= 0) & (local < E_loc)
    le = local.clamp(0, E_loc - 1)
    # rank = the assignment's place among its expert's assignments in
    # (token, k) order: a stable sort by expert, each place less its
    # expert's first (the reference's exclusive one-hot cumsum, without an
    # (T·K, E) scan); others' assignments sort last, as expert E_loc
    key = torch.where(mine, le, E_loc)
    order = key.argsort(dim=1, stable=True)
    counts = torch.zeros(L, E_loc + 1, dtype=torch.long, device=expert.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    starts = counts.cumsum(dim=1) - counts
    place = torch.arange(T * K, device=expert.device).expand(L, -1)
    rank = torch.empty_like(key).scatter_(1, order, place - starts.gather(1, key.gather(1, order)))
    keep = mine & (rank < C)
    tok = torch.arange(T, device=expert.device).repeat_interleave(K).expand(L, -1)
    slot_e = torch.where(keep, le, 0)
    slot_c = torch.where(keep, rank, C)                    # overflow → dump column
    part = torch.arange(L, device=expert.device)[:, None].expand(L, T * K)
    table = torch.full((L, E_loc, C + 1), T, dtype=torch.long, device=expert.device)
    table[part, slot_e, slot_c] = torch.where(keep, tok, T)
    slot = torch.where(keep, slot_e * C + slot_c, E_loc * C)
    return keep.reshape(L, T, K), slot.reshape(L, T, K), table[:, :, :C]


def _routed(xt, wg, wi, wo, gate, expert, lo, C: int):
    """The routed experts' output (L, T, d) for the experts [lo, lo + E_loc)
    of each partition: dispatch, the per-expert SwiGLU, and the combine in
    ascending expert order (see the module's docstring)."""
    L, T, d = xt.shape
    E_loc = wg.shape[1]
    keep, slot, slots = _dispatch(expert, lo, E_loc, C)
    part = torch.arange(L, device=xt.device)
    # the row gathers go through gather_rows: the same rows forward, and a
    # backward that sums each row's gradients in a fixed order (no atomics)
    xpad = torch.cat([xt, xt.new_zeros(L, 1, d)], dim=1)
    xe = gather_rows(xpad.reshape(L * (T + 1), d),
                     slots + (part * (T + 1))[:, None, None])   # (L, E_loc, C, d)
    ye = _expert_ffn(wg.reshape(L * E_loc, *wg.shape[2:]), wi.reshape(L * E_loc, *wi.shape[2:]),
                     wo.reshape(L * E_loc, *wo.shape[2:]), xe.reshape(L * E_loc, C, d))
    ye = torch.cat([ye.reshape(L, E_loc * C, d), ye.new_zeros(L, 1, d)], dim=1)
    g = torch.where(keep, gate, 0.0).to(ye.dtype)
    # each token's slots in ascending expert order (a dropped assignment
    # reads the zero dump row at gate 0: it adds +0.0, which leaves a sum
    # begun at +0.0 as it was)
    order = slot.argsort(dim=-1, stable=True)
    n_rows = E_loc * C + 1
    rows = gather_rows(ye.reshape(L * n_rows, d),
                       slot.gather(2, order) + (part * n_rows)[:, None, None])
    rows = rows * g.gather(2, order)[..., None]
    y = ye.new_zeros(L, T, d)
    for k in range(expert.shape[-1]):
        y = y + rows[:, :, k]
    return y


def _shared(xt, swg, swi, swo):
    """The shared experts on every token, summed: xt (L, T, d), weights
    (L, S, ·, ·) → (L, T, d)."""
    L, T, d = xt.shape
    S = swg.shape[1]
    sh = _expert_ffn(swg.reshape(L * S, *swg.shape[2:]), swi.reshape(L * S, *swi.shape[2:]),
                     swo.reshape(L * S, *swo.shape[2:]),
                     xt[:, None].expand(L, S, T, d).reshape(L * S, T, d))
    return sh.reshape(L, S, T, d).sum(dim=1)


def moe_ffn(p, x, cfg: MoEConfig, *, capacity: int | None = None):
    """x (..., d) → (y (..., d), aux_loss scalar)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(1, -1, d)                               # (1, T, d)
    T = xt.shape[1]
    E = cfg.n_experts

    probs, gate, expert = _route(xt, p["router"], cfg)
    me, ce = _balance(probs, expert)
    aux = E * torch.sum(me[0] * ce[0])

    C = capacity if capacity is not None else expert_capacity(T, cfg)
    lo = torch.zeros(1, dtype=torch.long, device=x.device)
    y = _routed(xt, p["wg"][None], p["wi"][None], p["wo"][None], gate, expert, lo, C)
    if cfg.n_shared:
        y = y + _shared(xt, p["shared_wg"][None], p["shared_wi"][None], p["shared_wo"][None])
    return y.reshape(orig_shape), aux


def _tables(p, x, cfg: MoEConfig, *, capacity: int | None = None):
    """:func:`moe_ffn`'s routing and dispatch alone: (expert (T, K), keep
    (T, K), slots (E, C)) — what the expert-parallel path must reproduce."""
    d = x.shape[-1]
    xt = x.reshape(1, -1, d)
    _, _, expert = _route(xt, p["router"], cfg)
    C = capacity if capacity is not None else expert_capacity(xt.shape[1], cfg)
    keep, _, slots = _dispatch(expert, torch.zeros(1, dtype=torch.long, device=x.device),
                               cfg.n_experts, C)
    return expert[0], keep[0], slots[0]


def moe_ffn_dense_oracle(p, x, cfg: MoEConfig):
    """Dropless oracle: every expert on every token, weighted by gates."""
    orig_shape = x.shape
    xt = x.reshape(1, -1, orig_shape[-1])
    T, d = xt.shape[1:]
    E = cfg.n_experts
    _, gate, expert = _route(xt, p["router"], cfg)
    w = torch.zeros(T, E, dtype=torch.float32, device=x.device)
    w.scatter_(1, expert[0], gate[0].float())                # (T, E)
    ye = _expert_ffn(p["wg"], p["wi"], p["wo"], xt.expand(E, T, d))
    y = torch.einsum("etd,te->td", ye, w.to(ye.dtype))
    if cfg.n_shared:
        y = y + _shared(xt, p["shared_wg"][None], p["shared_wi"][None], p["shared_wo"][None])[0]
    return y.reshape(orig_shape)
