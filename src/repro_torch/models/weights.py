"""Weights across packages: the JAX package's parameter trees, given as
numpy arrays, into the port's models — the LM's into
:class:`~repro_torch.models.transformer.LM`, the recsys models' into the
same nested dict of tensors — and its train states
(``{"params", "opt": {"m", "v", "count"}}``) into the port's
(:func:`train_state_from_numpy`), for the LM, recsys and GNN trees alike.

The reference stacks every LM layer's parameters on a leading ``layers``
axis (its ``lax.scan``); :class:`LM` slices that axis into its
``ModuleList``. Keys and shapes must match the defs exactly."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models.common import ParamDef, tree_map
from repro_torch.models.recsys import RecsysConfig, recsys_param_defs
from repro_torch.models.transformer import LM, LMConfig, lm_param_defs


def _convert(tree, defs, where: str, device) -> dict:
    if isinstance(defs, ParamDef):
        if isinstance(tree, dict):
            raise ValueError(f"{where}: a subtree where a parameter belongs")
        arr = np.asarray(tree)
        if tuple(arr.shape) != defs.shape:
            raise ValueError(f"{where}: shape {tuple(arr.shape)}, expected {defs.shape}")
        return torch.tensor(arr.astype(np.float32), device=device, dtype=defs.dtype)
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{where or 'params'}: keys {got}, expected {sorted(defs)}")
    return {key: _convert(tree[key], defs[key], f"{where}/{key}", device) for key in defs}


def params_from_numpy(tree: dict, cfg: LMConfig, device=None) -> LM:
    """``tree``: the reference's ``init_params(lm_param_defs(cfg), key)``
    (or a checkpoint of it) with numpy leaves → the port's module on
    ``device`` (``None``: the card), each leaf in ``cfg.dtype``."""
    return LM(_convert(tree, lm_param_defs(cfg), "", resolve_device(device)), cfg)


def recsys_params_from_numpy(tree: dict, cfg: RecsysConfig, device=None) -> dict:
    """``tree``: the reference's ``init_params(recsys_param_defs(cfg), key)``
    with numpy leaves → the port's tree of tensors on ``device`` (``None``:
    the card), each leaf in ``cfg.dtype``."""
    return _convert(tree, recsys_param_defs(cfg), "", resolve_device(device))


def tree_from_numpy(tree: dict, defs, device=None) -> dict:
    """Any parameter tree with numpy leaves (LM, recsys, GNN: the defs say
    which) → the same tree of tensors on ``device`` (``None``: the card),
    each leaf in its ParamDef's dtype; keys and shapes must match."""
    return _convert(tree, defs, "", resolve_device(device))


def train_state_from_numpy(state: dict, defs, device=None) -> dict:
    """The reference's train state — ``{"params": ..., "opt": {"m", "v",
    "count"}}`` with numpy leaves, from ``init_train_state`` and any number
    of its steps, or a checkpoint of it — → the port's: params in their
    ParamDefs' dtypes, f32 moments, an int32 count, all on ``device``."""
    dev = resolve_device(device)
    f32 = tree_map(lambda d: dataclasses.replace(d, dtype=torch.float32), defs)
    opt = state["opt"]
    return {"params": _convert(state["params"], defs, "params", dev),
            "opt": {"m": _convert(opt["m"], f32, "opt/m", dev),
                    "v": _convert(opt["v"], f32, "opt/v", dev),
                    "count": torch.tensor(int(np.asarray(opt["count"])), dtype=torch.int32,
                                          device=dev)}}
