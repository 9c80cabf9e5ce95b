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
:mod:`repro_torch.parallel.compat` and a :class:`P`. It places a global
tensor (:meth:`NamedSharding.place`): on a
:class:`~repro_torch.parallel.compat.RankMesh` this rank keeps its block;
on a :class:`~repro_torch.parallel.compat.StackedMesh` every partition
lives on the mesh's one device, so the tensor stays whole there. Both
refuse a shape that does not split evenly over the spec's axes.
:func:`place_tree` and :func:`gather_tree` place a state by its specs and
gather it back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from repro_torch.models.common import tree_map
from repro_torch.parallel import compat
from repro_torch.parallel.compat import Mesh, P, RankMesh


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

    def place(self, x) -> torch.Tensor:
        """A global value → what this process holds of it: its block on a
        rank mesh, the whole value on a stacked mesh's device."""
        x = self.mesh.tensor(x)
        if isinstance(self.mesh, RankMesh):
            return self.mesh.shard(x, self.spec)[0]
        self.mesh.block_shape(x.shape, self.spec)        # refuses an uneven split
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """What this process holds → the global value (an all-gather over
        the spec's axes on a rank mesh; as it is on a stacked mesh)."""
        if isinstance(self.mesh, RankMesh):
            return self.mesh.unshard(x[None], self.spec)
        return x


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


def spec_leaves(specs: Any) -> list:
    """The P leaves of a tree of specs (dicts in sorted key order, tuples
    and lists in order; a P is a leaf, and so is a None)."""
    if isinstance(specs, P) or specs is None:
        return [specs]
    if isinstance(specs, dict):
        return [leaf for key in sorted(specs) for leaf in spec_leaves(specs[key])]
    return [leaf for s in specs for leaf in spec_leaves(s)]


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree of tensors and its tree of P."""
    if isinstance(specs, P):
        return fn(tree, specs)
    return {key: map_specs(fn, tree[key], specs[key]) for key in sorted(specs)}


def place_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """A global state → what this process holds of it, leaf by leaf."""
    return map_specs(lambda x, s: NamedSharding(mesh, s).place(x), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """What this process holds of a state → the global state."""
    return map_specs(lambda x, s: NamedSharding(mesh, s).gather(x), tree, specs)


# Collective helpers -----------------------------------------------------------

def hierarchical_psum(x, *, inner: str = "data", outer: "str | None" = None):
    """Gradient reduction, pod-aware: psum over the fast in-pod axis first,
    then the slow cross-pod axis (inside a ``shard_map`` body)."""
    y = compat.psum(x, inner)
    if outer is not None:
        y = compat.psum(y, outer)
    return y

