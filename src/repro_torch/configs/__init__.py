"""Architecture registry of the port: the LMs (dense, MoE and MLA + MoE),
the GNN, the recsys models and the paper's own search geometry, under the
reference's ids. Each module exposes ``FAMILY``, ``full_config()``,
``reduced_config()``, ``rules()`` and ``cells(rules, reduced)``; the ten
assigned architectures are :data:`ASSIGNED`, and :func:`build_cells` /
:func:`all_cells` give their cells (:mod:`repro_torch.configs.cells`)."""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    # LM family (the reference's order, which all_cells keeps)
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    # GNN
    "graphcast": "repro_torch.configs.graphcast",
    # recsys
    "fm": "repro_torch.configs.fm",
    "bst": "repro_torch.configs.bst",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "bert4rec": "repro_torch.configs.bert4rec",
    # the paper's own
    "anlessini": "repro_torch.configs.anlessini",
}


ASSIGNED = [a for a in ARCH_MODULES if a != "anlessini"]


def get_arch(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


def family(name: str) -> list[str]:
    """The ids of one family (``"lm"``, ``"gnn"``, ``"recsys"``), sorted."""
    return sorted(a for a in ARCH_MODULES if get_arch(a).FAMILY == name)


def build_cells(name: str, *, multi_pod: bool = False, reduced: bool = False):
    """dict[shape_name, CellSpec] for one arch under the given mesh kind."""
    mod = get_arch(name)
    rules = mod.rules()
    if multi_pod:
        rules = rules.with_pod()
    return mod.cells(rules, reduced=reduced)


def all_cells(*, multi_pod: bool = False, reduced: bool = False,
              include_paper_arch: bool = True):
    """``{"arch/shape": CellSpec}`` over :data:`ASSIGNED` (and anlessini)."""
    out = {}
    names = list(ASSIGNED) + (["anlessini"] if include_paper_arch else [])
    for name in names:
        for sname, cell in build_cells(name, multi_pod=multi_pod, reduced=reduced).items():
            out[f"{name}/{sname}"] = cell
    return out
