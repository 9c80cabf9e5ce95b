"""Mesh construction — the port of ``repro/launch/mesh.py``, over
:mod:`repro_torch.parallel.compat`.

Functions, not module constants, so that importing this module touches no
device. The production topology is the reference's: ``(data=16,
model=16)`` single-pod, ``(pod=2, data=16, model=16)`` multi-pod, ``pod``
an outer data-parallel axis. On one card :func:`make_production_mesh` is a
:class:`~repro_torch.parallel.compat.StackedMesh` of that shape: every
partition on the card, as the mesh search path runs it. Training on it
waits for ROADMAP Queue 1 item 10 (``launch.train --mesh prod``).
"""

from __future__ import annotations

from repro_torch.parallel import compat
from repro_torch.parallel.compat import Mesh, RankMesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.StackedMesh(shape, axes, device=device)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *, device=None) -> Mesh:
    """A small mesh over what this process reaches (a rank mesh when a
    process group is up, else stacked on ``device``): tests and examples."""
    return compat.make_mesh(tuple(shape), tuple(axes), device=device)


def mesh_devices(mesh: Mesh) -> int:
    """The devices the mesh's partitions live on: one a rank on a rank
    mesh, the one device of a stacked mesh."""
    return mesh.size if isinstance(mesh, RankMesh) else 1
