"""Architecture registry of the port: the dense LMs whose serving path is
ported. Each module exposes ``full_config()`` and ``reduced_config()``;
``rules``/``cells`` wait for ROADMAP Queue 1 item 10."""

from __future__ import annotations

import importlib

ARCH_MODULES = {
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
}


def get_arch(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[name])
