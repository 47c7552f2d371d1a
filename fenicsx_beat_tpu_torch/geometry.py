"""Slab geometries with fiber microstructure (numpy only).

Slab subset of ``fenicsx_beat_tpu/geometry.py``: structured 3D slab meshes
with resolution ``dx`` and constant fiber/sheet/normal fields.  The
``comm`` argument is accepted for signature parity and unused.  The LV and
BiV generators and the disk cache are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .mesh import CellType, Mesh, MeshTags, create_box

__all__ = [
    "Geometry",
    "get_3D_slab_microstructure",
    "get_3D_slab_mesh",
    "get_3D_slab_geometry",
]


class Geometry(NamedTuple):
    mesh: Mesh
    ffun: MeshTags | None = None
    markers: dict[str, tuple[int, int]] | None = None
    f0: np.ndarray | None = None
    s0: np.ndarray | None = None
    n0: np.ndarray | None = None


def get_3D_slab_microstructure(mesh: Mesh, transverse: bool = False):
    """Constant fiber/sheet/normal directions (reference ``geometry.py:47-75``)."""
    if transverse:
        f0 = np.array((0.0, 0.0, 1.0))
        s0 = np.array((1.0, 0.0, 0.0))
        n0 = np.array((0.0, 1.0, 0.0))
    else:
        f0 = np.array((1.0, 0.0, 0.0))
        s0 = np.array((0.0, 1.0, 0.0))
        n0 = np.array((0.0, 0.0, 1.0))
    return f0, s0, n0


def get_3D_slab_mesh(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
) -> Mesh:
    nx = int(np.rint(Lx / dx))
    ny = int(np.rint(Ly / dx))
    nz = int(np.rint(Lz / dx))
    return create_box(
        comm,
        points=((0.0, 0.0, 0.0), (Lx, Ly, Lz)),
        n=(nx, ny, nz),
        cell_type=cell_type,
        dtype=dtype,
    )


def get_3D_slab_geometry(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    Lz: float = 1.0,
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
    transverse: bool = False,
) -> Geometry:
    """Reference ``geometry.py:142-180``."""
    mesh = get_3D_slab_mesh(comm, dx, Lx, Ly, Lz, cell_type, dtype)
    f0, s0, n0 = get_3D_slab_microstructure(mesh, transverse)
    return Geometry(mesh=mesh, f0=f0, s0=s0, n0=n0)
