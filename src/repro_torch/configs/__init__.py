"""Architecture registry of the port: the dense LMs and the recsys models
whose serving paths are ported, and the paper's own search geometry, under
the reference's ids. Each module exposes ``FAMILY``, ``full_config()`` and
``reduced_config()``; ``rules``/``cells`` wait for ROADMAP Queue 1 item 10."""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    # LM family
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    # recsys
    "fm": "repro_torch.configs.fm",
    "bst": "repro_torch.configs.bst",
    "dcn-v2": "repro_torch.configs.dcn_v2",
    "bert4rec": "repro_torch.configs.bert4rec",
    # the paper's own
    "anlessini": "repro_torch.configs.anlessini",
}


def get_arch(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])


def family(name: str) -> list[str]:
    """The ids of one family (``"lm"``, ``"recsys"``), sorted."""
    return sorted(a for a in ARCH_MODULES if get_arch(a).FAMILY == name)
