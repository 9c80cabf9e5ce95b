"""Logical-axis → mesh-axis sharding rules (DP / TP / EP / SP + pod axis) —
the port of ``repro/parallel/sharding.py``.

Models declare parameters with *logical* axes
(:mod:`repro_torch.models.common`); configs pick a :class:`ShardRules`
mapping those names onto mesh axes. Conventions as the reference's:

* mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
  multi-pod (:mod:`repro_torch.launch.mesh`); ``pod`` is an outer
  data-parallel axis;
* ``rules.mapping`` maps logical axis → mesh axis (or tuple of axes, or
  None for replicated); ``rules.batch`` lists the mesh axes the batch
  dimension shards over;
* FSDP: "embed" → "data" also shards the weight-stationary dimension over
  the data axis.

A placement is a :class:`NamedSharding`: a mesh of
:mod:`repro_torch.parallel.compat` and a :class:`P`. On one card every
partition of a stacked mesh lives on that card, so a placement reads as its
mesh's device (``.device``); sharded training over ranks waits for ROADMAP
Queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.models.common import tree_map
from repro_torch.parallel import compat
from repro_torch.parallel.compat import Mesh, P


@dataclasses.dataclass(frozen=True)
class ShardRules:
    """Logical→mesh mapping + batch axes."""

    mapping: Mapping[str, Any]          # logical name -> mesh axis | tuple | None
    batch: tuple[str, ...] = ("data",)

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        return self.mapping.get(logical, None)

    def spec(self, axes: Sequence[str | None]) -> P:
        """PartitionSpec for one param's logical axes (a mesh axis after its
        first occurrence is dropped: a mesh axis can shard only one dim)."""
        used: set[str] = set()
        out = []
        for ax in axes:
            m = self.resolve(ax)
            if m is None:
                out.append(None)
                continue
            ms = (m,) if isinstance(m, str) else tuple(m)
            ms = tuple(a for a in ms if a not in used)
            used.update(ms)
            if not ms:
                out.append(None)
            elif len(ms) == 1:
                out.append(ms[0])
            else:
                out.append(ms)
        return P(*out)

    def batch_spec(self, *trailing: Any) -> P:
        """PartitionSpec with the batch dim sharded over rules.batch."""
        lead = self.batch[0] if len(self.batch) == 1 else tuple(self.batch)
        return P(lead, *trailing)

    def with_pod(self) -> "ShardRules":
        """Extend rules for the multi-pod mesh: pod joins the batch axes."""
        if "pod" in self.batch:
            return self
        return dataclasses.replace(self, batch=("pod",) + tuple(self.batch))


# Canonical rule sets ---------------------------------------------------------

def lm_rules(*, fsdp: bool = False) -> ShardRules:
    """Transformer TP: heads/mlp/vocab/experts on `model`; optional FSDP
    (embed dim over `data`)."""
    return ShardRules(mapping={
        "embed": "data" if fsdp else None,
        "heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "rows": "model",
        "kv_lora": None,
        "layers": None,
    })


def recsys_rules() -> ShardRules:
    """Row-sharded embedding tables; dense towers replicated; batch over data."""
    return ShardRules(mapping={
        "rows": "model",
        "embed": None,
        "mlp": None,
        "heads": None,
        "vocab": "model",
        "layers": None,
    })


def gnn_rules(*, shard_nodes: bool = False) -> ShardRules:
    """Edges shard over `data`; weights replicated (they are tiny); node
    states replicated or node-sharded (ogb_products)."""
    return ShardRules(mapping={
        "embed": None,
        "mlp": "model",
        "nodes": "data" if shard_nodes else None,
        "edges": "data",
        "layers": None,
    })


# Param / pytree placements ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A value's placement: ``spec`` over ``mesh``'s axes. Its tensors live
    on the mesh's device."""

    mesh: Mesh
    spec: P

    @property
    def device(self):
        return self.mesh.device


def param_specs(defs: Any, rules: ShardRules) -> Any:
    """Tree of P matching a ParamDef tree."""
    return tree_map(lambda d: rules.spec(d.axes), defs)


def param_shardings(defs: Any, mesh: Mesh, rules: ShardRules) -> Any:
    return tree_map(lambda d: NamedSharding(mesh, rules.spec(d.axes)), defs)


def named(mesh: Mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def tree_named(mesh: Mesh, specs: Any) -> Any:
    """A tree of P (a P is a tuple: it is a leaf here) → NamedShardings."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


# Collective helpers -----------------------------------------------------------

def hierarchical_psum(x, *, inner: str = "data", outer: str | None = None):
    """Gradient reduction, pod-aware: psum over the fast in-pod axis first,
    then the slow cross-pod axis (inside a ``shard_map`` body)."""
    y = compat.psum(x, inner)
    if outer is not None:
        y = compat.psum(y, outer)
    return y

