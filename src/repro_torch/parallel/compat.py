"""``shard_map``, its collectives and the ambient mesh over torch — the port
of ``repro/parallel/compat.py``.

JAX runs a ``shard_map`` body once per device of a mesh, and the body's
collectives (``all_gather``, ``psum``, ``axis_index``) name the mesh's axes.
Here one interface has two realizations:

* :class:`RankMesh` — one partition per process of a ``torch.distributed``
  world, over ``init_device_mesh(device.type, shape, mesh_dim_names=names)``:
  gloo on CPUs, NCCL across cards. The caller initializes the default
  process group first, from a store it passes (``init_device_mesh`` would
  otherwise fall back to ``env://``). Collectives go to the mesh's group of
  each axis.
* :class:`StackedMesh` — the same axis names and sizes with every partition
  on one device. NCCL cannot put two ranks of one communicator on one card,
  so this is how a single GPU runs a mesh program: the body runs once over
  all partitions, and a collective is a reshape in the order the rank
  mesh's collective gives.

Inside a body every value carries a leading partition dimension L: the
partitions this process holds, row-major over the mesh's axes — 1 on a
rank mesh, all of them on a stacked mesh. A body written against that
dimension runs unchanged on both meshes and gives the same bits, as long as
every partition's rows pass through the same operations (a gather is exact;
``psum`` sums in coordinate order on a stacked mesh and in the backend's
order on a rank mesh).

Specs are :class:`P` (``PartitionSpec``): one entry per dimension, ``None``
(replicated), an axis name or a tuple of names (row-major over them). Inputs
are global arrays; outputs come back global on every process, so a rank
mesh gathers a sharded output.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Callable

import torch

from repro_torch.kernels.backend import resolve_device

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("data", "model"), None)``,
    ``P()`` (replicated over every axis, any rank)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)


class Mesh:
    """Axis names and sizes (``shape``, ordered like ``jax.sharding.Mesh``)
    and the device the partitions' tensors live on."""

    def __init__(self, shape: tuple[int, ...], names: tuple[str, ...],
                 device: torch.device) -> None:
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} do not pair up")
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in shape)))
        self.device = device

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name, a tuple of names or None) as a tuple of names."""
        out = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in out if a not in self.shape]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the mesh has {self.axis_names}")
        return out

    def _spec(self, spec, ndim: int) -> list[tuple[str, ...]]:
        if len(spec) > ndim:
            raise ValueError(f"spec {spec} names {len(spec)} dims of a rank-{ndim} value")
        entries = [self.axes(e) for e in spec] + [()] * (ndim - len(spec))
        used = [a for e in entries for a in e]
        if len(used) != len(set(used)):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        return entries

    def tensor(self, x) -> torch.Tensor:
        """An input on this mesh's device (numpy arrays converted)."""
        return torch.as_tensor(x).to(self.device)


class StackedMesh(Mesh):
    """Every partition of a ``shape`` mesh on one device (the card unless
    ``device="cpu"``); L = the mesh's size."""

    def __init__(self, shape: tuple[int, ...], names: tuple[str, ...] = ("data", "model"),
                 device=None) -> None:
        super().__init__(shape, names, resolve_device(device))
        flat = torch.arange(self.size, device=self.device)
        coords = []
        for s in reversed(list(self.shape.values())):
            coords.append(flat % s)
            flat = flat // s
        self._coords = dict(zip(self.axis_names, reversed(coords)))

    def axis_index(self, axis: str) -> torch.Tensor:
        """(L,) int64: each partition's coordinate along ``axis``."""
        (axis,) = self.axes(axis)
        return self._coords[axis]

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*self.shape.values(), *x.shape[1:])

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """(L, ..., n) → (L, ..., S·n): every partition's last dimension
        concatenated over ``axes`` (row-major over a tuple), as JAX's tiled
        ``all_gather(x, axes, axis=-1)``."""
        axes = self.axes(axes)
        k = len(self.shape)
        y = self._grid(x)
        pos = [self.axis_names.index(a) for a in axes]
        y = y.movedim(pos, list(range(y.dim() - 1 - len(pos), y.dim() - 1)))
        y = y.reshape(*y.shape[:y.dim() - 1 - len(pos)], -1)
        for p in sorted(pos):
            y = y.unsqueeze(p)
        y = y.expand(*self.shape.values(), *y.shape[k:])
        return y.reshape(self.size, *y.shape[k:])

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum over ``axes``, in coordinate order, on every partition."""
        y = self._grid(x)
        for a in self.axes(axes):
            i = self.axis_names.index(a)
            acc = y.select(i, 0)
            for c in range(1, self.shape[a]):
                acc = acc + y.select(i, c)
            y = acc.unsqueeze(i).expand(y.shape)
        return y.reshape(x.shape)

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        """A global value → (L, *local): partition p's block of it."""
        entries = self._spec(spec, x.dim())
        used = {a for e in entries for a in e}
        if not used:        # replicated: one view, no copy
            return x.unsqueeze(0).expand(self.size, *x.shape)
        shape, at = [], {}
        for n, e in zip(x.shape, entries):
            s = math.prod(self.shape[a] for a in e)
            if n % s:
                raise ValueError(f"a dimension of {n} does not split over {e} ({s})")
            for a in e:
                at[a] = len(shape)
                shape.append(self.shape[a])
            shape.append(n // s)
        y = x.reshape(shape)
        front = [a for a in self.axis_names if a in used]
        y = y.permute([at[a] for a in front]
                      + [d for d in range(y.dim()) if d not in at.values()])
        for i, a in enumerate(self.axis_names):
            if a not in used:
                y = y.unsqueeze(i)
        y = y.expand(*self.shape.values(), *y.shape[len(self.shape):])
        return y.reshape(self.size, *y.shape[len(self.shape):])

    def unshard(self, y: torch.Tensor, spec) -> torch.Tensor:
        """(L, *local) → the global value: blocks concatenated over the
        spec's axes, partition 0's copy along every other axis."""
        entries = self._spec(spec, y.dim() - 1)
        used = [a for e in entries for a in e]
        g = self._grid(y)
        for i in reversed(range(len(self.axis_names))):
            if self.axis_names[i] not in used:
                g = g.select(i, 0)
        front = [a for a in self.axis_names if a in used]
        k = len(front)
        perm, shape = [], []
        for d, e in enumerate(entries):
            perm += [front.index(a) for a in e] + [k + d]
            shape.append(math.prod(self.shape[a] for a in e) * y.shape[1 + d])
        return g.permute(perm).reshape(shape)


class RankMesh(Mesh):
    """One partition per process of the initialized default process group,
    whose world is the mesh (ranks row-major over ``shape``), on ``device``:
    this process's card when None (raising without one), the CPU only when
    asked (``device="cpu"``, gloo)."""

    def __init__(self, shape: tuple[int, ...], names: tuple[str, ...] = ("data", "model"),
                 device=None) -> None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        device = resolve_device(device)
        if not dist.is_initialized():
            raise RuntimeError("a rank mesh needs the default process group: call "
                               "torch.distributed.init_process_group(backend, store=..., "
                               "rank=..., world_size=...) first")
        if math.prod(shape) != dist.get_world_size():
            raise ValueError(f"mesh {shape} does not cover the world of "
                             f"{dist.get_world_size()} ranks")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        super().__init__(shape, names, device)
        self._dist = dist
        self.device_mesh = init_device_mesh(device.type, tuple(shape),
                                            mesh_dim_names=tuple(names))
        self._coord = {a: self.device_mesh.get_local_rank(a) for a in self.axis_names}

    def axis_index(self, axis: str) -> torch.Tensor:
        (axis,) = self.axes(axis)
        return torch.tensor([self._coord[axis]], device=self.device)

    def _gather(self, x: torch.Tensor, axes: tuple[str, ...], dim: int) -> torch.Tensor:
        # the whole mesh in mesh order is the world in rank order: one
        # collective; else the axes one at a time, the fastest first
        if axes == self.axis_names:
            groups = [(None, self.size)]
        else:
            groups = [(self.device_mesh.get_group(a), self.shape[a]) for a in reversed(axes)]
        for group, n in groups:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(n)]
            self._dist.all_gather(parts, x, group=group)
            x = torch.cat(parts, dim=dim)
        return x

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = self.axes(axes)
        return self._gather(x, axes, -1) if axes else x

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        x = x.clone()
        for a in self.axes(axes):
            self._dist.all_reduce(x, group=self.device_mesh.get_group(a))
        return x

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        for d, e in enumerate(self._spec(spec, x.dim())):
            if e:
                s = math.prod(self.shape[a] for a in e)
                if x.shape[d] % s:
                    raise ValueError(f"a dimension of {x.shape[d]} does not split over {e}")
                idx = 0
                for a in e:
                    idx = idx * self.shape[a] + self._coord[a]
                n = x.shape[d] // s
                x = x.narrow(d, idx * n, n)
        return x.unsqueeze(0)

    def unshard(self, y: torch.Tensor, spec) -> torch.Tensor:
        y = y[0]
        for d, e in enumerate(self._spec(spec, y.dim())):
            if e:
                y = self._gather(y, e, d)
        return y


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...] = ("data", "model"), *,
              device=None) -> Mesh:
    """The mesh over what this process can reach, as ``jax.make_mesh`` over
    the devices: a :class:`RankMesh` when a default process group is
    initialized, else a :class:`StackedMesh`; either on ``device`` (the
    card unless "cpu")."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return RankMesh(shape, names, device=device)
    return StackedMesh(shape, names, device=device)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh, which ``shard_map(mesh=None)``
    and the collectives below read."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh() -> "Mesh | None":
    """The ambient mesh (:func:`use_mesh`), else None."""
    return _AMBIENT.get()


def _current() -> Mesh:
    mesh = _AMBIENT.get()
    if mesh is None:
        raise ValueError("no ambient mesh — wrap the call in "
                         "repro_torch.parallel.compat.use_mesh(mesh) or pass mesh=")
    return mesh


def _tree_map(fn: Callable, tree: Any, specs: Any) -> Any:
    if specs is None and tree is None:          # an empty subtree, as in JAX
        return None
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(specs, dict):
        return {k: _tree_map(fn, tree[k], s) for k, s in specs.items()}
    if len(tree) != len(specs):
        raise ValueError(f"{len(tree)} values for {len(specs)} specs")
    return type(specs)(_tree_map(fn, t, s) for t, s in zip(tree, specs))


def shard_map(body: Callable, mesh: "Mesh | None", in_specs: Any, out_specs: Any):
    """``body`` run over every partition of ``mesh`` (None: the ambient mesh,
    read at call time), its inputs split by ``in_specs`` and its outputs
    joined by ``out_specs``. The body sees the leading partition dimension
    and runs with its mesh ambient, so the collectives below reach it."""

    def run(*args):
        m = mesh if mesh is not None else _current()
        local = _tree_map(lambda x, s: m.shard(m.tensor(x), s), args, tuple(in_specs))
        with use_mesh(m):
            out = body(*local)
        return _tree_map(m.unshard, out, out_specs)

    return run


def axis_index(axis: str) -> torch.Tensor:
    """Inside a body: (L,) coordinates along ``axis``."""
    return _current().axis_index(axis)


def all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """Inside a body: ``x``'s last dimension concatenated over ``axes``."""
    return _current().all_gather(x, axes)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Inside a body: the sum of ``x`` over ``axes``."""
    return _current().psum(x, axes)


def flat_axis_index(axes: tuple[str, ...], mesh: "Mesh | None" = None) -> torch.Tensor:
    """(L,) row-major flattened index over several mesh axes."""
    m = mesh if mesh is not None else _current()
    pid = torch.zeros((), dtype=torch.int64, device=m.device)
    for ax in axes:
        pid = pid * m.shape[ax] + m.axis_index(ax)
    return pid
