"""Model substrate: parameter declarations and the building blocks — the
port of ``repro/models/common.py``.

A model declares its parameters once as a tree (nested ``dict``) of
:class:`ParamDef` (shape, logical axes, initializer, dtype). From it come
``count_params`` (no allocation) and ``init_params`` (tensors from an
explicit ``torch.Generator``), ``abstract_params`` (tensors on the
``meta`` device: shapes and dtypes, no storage) and ``param_axes``, which
:mod:`repro_torch.parallel.sharding` maps onto a mesh's axes.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so parity tests carry the reference's own initial values across
(:func:`repro_torch.models.weights.params_from_numpy`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # None → 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted key order (the order of
    ``jax.tree_util`` over dicts)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key]) for key in sorted(tree)}
    return fn(tree)


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def _tree_map_defs(fn, defs):
    return tree_map(fn, defs)


def abstract_params(defs) -> Any:
    """Each ParamDef as an empty tensor of its shape and dtype on the
    ``meta`` device — the reference's ShapeDtypeStructs; nothing is
    allocated."""
    return _tree_map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), defs)


def param_axes(defs) -> Any:
    return _tree_map_defs(lambda d: d.axes, defs)


def unstack_layers(tree: dict, n: int) -> list:
    """A tree stacked on a leading ``layers`` axis → n trees of views, one a
    layer (the reference's ``lax.scan`` over that axis). One ``unbind`` a
    leaf, so the backward stacks each leaf's gradients once."""
    cols = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda c, i=i: c[i], cols) for i in range(n)]


def count_params(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def _init_one(d: ParamDef, generator: torch.Generator, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
    if d.init == "embed":
        scale = d.scale if d.scale is not None else 0.02
    x = torch.randn(d.shape, generator=generator, device=generator.device,
                    dtype=torch.float32) * scale
    return x.to(device=device, dtype=d.dtype)


def init_params(defs, generator: torch.Generator, device) -> Any:
    """Materialise every ParamDef on ``device``: zeros, ones, or normal
    draws from ``generator`` (on its own device) scaled by 1/sqrt(fan_in),
    or 0.02 for embeddings. Leaves are drawn in sorted key order.
    ``device=None`` means the card, and raises without one."""
    device = resolve_device(device)
    return tree_map(lambda d: _init_one(d, generator, device), defs)


# -- building blocks -------------------------------------------------------------


def rms_norm(x, gamma, *, eps: float = 1e-6):
    """Normalise in f32, cast back to x's dtype, then scale by gamma — the
    reference's cast order."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def layer_norm(x, gamma, beta, *, eps: float = 1e-5):
    """Statistics in f32 — the mean and the population variance, as
    ``jnp.var`` — cast back to x's dtype, then scale and shift."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma + beta


def dense(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b
    return y


def gelu_mlp_defs(d_model: int, d_ff: int, dtype) -> dict:
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "bi": ParamDef((d_ff,), ("mlp",), init="zeros", dtype=dtype),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
        "bo": ParamDef((d_model,), ("embed",), init="zeros", dtype=dtype),
    }


def gelu_mlp(p, x):
    """``jax.nn.gelu`` is the tanh approximation by default."""
    return dense(F.gelu(dense(x, p["wi"], p["bi"]), approximate="tanh"), p["wo"], p["bo"])


def swiglu_mlp_defs(d_model: int, d_ff: int, dtype) -> dict:
    return {
        "wg": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def swiglu_mlp(p, x):
    return dense(F.silu(dense(x, p["wg"])) * dense(x, p["wi"]), p["wo"])


def mlp_stack_defs(dims: tuple[int, ...], dtype) -> dict:
    """Plain ReLU MLP tower (recsys). dims = (in, h1, ..., out). The
    reference's ``final_axis``, ``act`` and ``final_act`` options have no
    caller and are not taken."""
    out = {}
    for i in range(len(dims) - 1):
        ax_in = "embed" if i == 0 else None
        out[f"w{i}"] = ParamDef((dims[i], dims[i + 1]), (ax_in, None), dtype=dtype)
        out[f"b{i}"] = ParamDef((dims[i + 1],), (None,), init="zeros", dtype=dtype)
    return out


def mlp_stack(p, x):
    """ReLU between the layers, none after the last."""
    n = len([k for k in p if k.startswith("w")])
    for i in range(n):
        x = dense(x, p[f"w{i}"], p[f"b{i}"])
        if i < n - 1:
            x = F.relu(x)
    return x


# -- rematerialisation -------------------------------------------------------------

_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_SAVED_DOTS = {
    "dots_saveable": _DOTS,
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
}
REMAT_POLICIES = ("nothing_saveable", *_SAVED_DOTS)


def _save_ops(names: tuple[str, ...]):
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
    ops = {getattr(torch.ops.aten, name).default for name in names}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return lambda: create_selective_checkpoint_contexts(policy)


def remat(body, policy: "str | None"):
    """``body`` recomputed in the backward pass, as ``jax.checkpoint`` with
    the reference's policies, through ``torch.utils.checkpoint``
    (non-reentrant): ``"nothing_saveable"`` keeps only the inputs;
    ``"dots_saveable"`` also every matmul's output (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``); ``"dots_with_no_batch_dims_saveable"`` those
    without batch dimensions (``mm``, ``addmm``). ``None`` or ``"none"``:
    ``body`` itself. Recomputing runs the same operations on the same
    inputs, so the gradients are those without remat, bit for bit."""
    if policy in (None, "none"):
        return body
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; known: {REMAT_POLICIES + ('none',)}")
    from torch.utils.checkpoint import checkpoint
    kw = {} if policy == "nothing_saveable" else {"context_fn": _save_ops(_SAVED_DOTS[policy])}

    def run(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)

    return run
