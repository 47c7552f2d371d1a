"""Slab and left-ventricle geometries with fiber microstructure (numpy only).

Subset of ``fenicsx_beat_tpu/geometry.py``: structured 2D and 3D slab
meshes with resolution ``dx`` and constant fiber/sheet(/normal) fields, and the
idealized LV ellipsoid with ENDO/EPI/BASE facet tags and a rule-based
helical fiber field.  The ``comm`` argument is accepted for signature
parity and unused.  The BiV generator and the disk cache are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import itertools

import numpy as np

from .mesh import CellType, Mesh, MeshTags, create_box, create_rectangle, meshtags

__all__ = [
    "Geometry",
    "get_2D_slab_microstructure",
    "get_3D_slab_microstructure",
    "get_2D_slab_mesh",
    "get_3D_slab_mesh",
    "get_2D_slab_geometry",
    "get_3D_slab_geometry",
    "get_lv_ellipsoid_geometry",
]


class Geometry(NamedTuple):
    mesh: Mesh
    ffun: MeshTags | None = None
    markers: dict[str, tuple[int, int]] | None = None
    f0: np.ndarray | None = None
    s0: np.ndarray | None = None
    n0: np.ndarray | None = None


def get_2D_slab_microstructure(mesh: Mesh, transverse: bool = False):
    """Constant fiber/sheet directions (reference ``geometry.py:18-44``)."""
    if transverse:
        f0 = np.array((0.0, 1.0))
        s0 = np.array((1.0, 0.0))
    else:
        f0 = np.array((1.0, 0.0))
        s0 = np.array((0.0, 1.0))
    return f0, s0


def get_2D_slab_mesh(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    cell_type: CellType = CellType.triangle,
    dtype=np.float64,
) -> Mesh:
    """The rectangle [0, Lx] x [0, Ly] at resolution ``dx``, two triangles a square."""
    nx = int(np.rint(Lx / dx))
    ny = int(np.rint(Ly / dx))
    return create_rectangle(comm, points=((0.0, 0.0), (Lx, Ly)), n=(nx, ny), cell_type=cell_type, dtype=dtype)


def get_2D_slab_geometry(
    comm=None,
    dx: float = 0.1,
    Lx: float = 1.0,
    Ly: float = 1.0,
    cell_type: CellType = CellType.triangle,
    dtype=np.float64,
    transverse: bool = False,
) -> Geometry:
    """Reference ``geometry.py:183-218``."""
    mesh = get_2D_slab_mesh(comm, dx, Lx, Ly, cell_type, dtype)
    f0, s0 = get_2D_slab_microstructure(mesh, transverse)
    return Geometry(mesh=mesh, f0=f0, s0=s0)


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


def get_lv_ellipsoid_geometry(
    comm=None,
    r_short_endo: float = 2.5,
    r_short_epi: float = 3.5,
    r_long_endo: float = 9.0,
    r_long_epi: float = 9.7,
    base: float = 0.0,
    psize_ref: float = 0.3,
    fiber_angle_endo: float = 60.0,
    fiber_angle_epi: float = -60.0,
    dtype=np.float64,
    cache: bool = True,
) -> Geometry:
    """Idealized truncated-ellipsoid left ventricle with rule-based fibers.

    A structured (transmural, longitudinal, circumferential) grid mapped
    onto the shell between the endo and epi ellipsoids, split into Kuhn
    tetrahedra (opposite box faces share the diagonal pattern, so welding
    the theta seam and the apex stays conforming), with ENDO/EPI/BASE facet
    tags and a linearly rotating helical fiber field (``fiber_angle_endo``
    -> ``fiber_angle_epi`` across the wall, degrees).  The long axis is x,
    apex at x = -r_long; the base plane sits at x = ``base``.

    Mesh, tags and fields are those of the JAX package's generator with
    ``cache=False``.  The disk cache is not ported: ``cache`` is accepted
    for signature parity and the geometry is built anew on every call.
    """
    mu_base_endo = -np.arccos(np.clip(base / r_long_endo, -1.0, 1.0))
    mu_base_epi = -np.arccos(np.clip(base / r_long_epi, -1.0, 1.0))

    # resolution from target element size
    wall = r_short_epi - r_short_endo
    arc = r_long_endo * (np.pi - abs(mu_base_endo))
    circ = 2 * np.pi * r_short_endo
    nt = max(2, int(np.rint(wall / psize_ref)))
    nmu = max(8, int(np.rint(arc / psize_ref)))
    nth = max(12, int(np.rint(circ / psize_ref)))

    ts = np.linspace(0.0, 1.0, nt + 1)
    ths = np.linspace(0.0, 2 * np.pi, nth + 1)[:-1]  # periodic, no duplicate

    def rs(t):
        return r_short_endo + t * (r_short_epi - r_short_endo)

    def rl(t):
        return r_long_endo + t * (r_long_epi - r_long_endo)

    def mu_base(t):
        return mu_base_endo + t * (mu_base_epi - mu_base_endo)

    # node ids: apex nodes (one per t-layer) + regular grid (i_mu >= 1);
    # grid index (i_t, i_mu, i_th), i_mu = 0 is the collapsed apex ring
    n_reg = (nt + 1) * nmu * nth

    def gid(i_t, i_mu, i_th):
        """Global node id with apex collapse and theta wrap (vectorized)."""
        i_t = np.asarray(i_t)
        i_mu = np.asarray(i_mu)
        i_th = np.asarray(i_th) % nth
        reg = (nt + 1) + (i_t * nmu + (i_mu - 1)) * nth + i_th
        return np.where(i_mu == 0, i_t, reg)

    coords = np.zeros(((nt + 1) + n_reg, 3), dtype=dtype)
    node_t = np.zeros((nt + 1) + n_reg, dtype=dtype)  # transmural coordinate
    node_mu = np.zeros_like(node_t)
    node_th = np.zeros_like(node_t)
    for i_t, t in enumerate(ts):
        coords[i_t] = (-rl(t), 0.0, 0.0)
        node_t[i_t] = t
        node_mu[i_t] = -np.pi
        mu_t = np.linspace(-np.pi, mu_base(t), nmu + 1)[1:]  # i_mu = 1..nmu
        MU, TH = np.meshgrid(mu_t, ths, indexing="ij")  # [nmu, nth]
        X = rl(t) * np.cos(MU)
        Y = rs(t) * np.sin(MU) * np.cos(TH)
        Z = rs(t) * np.sin(MU) * np.sin(TH)
        base_idx = (nt + 1) + i_t * nmu * nth
        coords[base_idx : base_idx + nmu * nth] = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        node_t[base_idx : base_idx + nmu * nth] = t
        node_mu[base_idx : base_idx + nmu * nth] = MU.ravel()
        node_th[base_idx : base_idx + nmu * nth] = TH.ravel()

    # Kuhn 6-tet decomposition of each (i_t, i_mu, i_th) box
    it_, imu_, ith_ = np.meshgrid(np.arange(nt), np.arange(nmu), np.arange(nth), indexing="ij")
    bases = np.stack([it_.ravel(), imu_.ravel(), ith_.ravel()], axis=1)  # [ncubes, 3]
    e = np.eye(3, dtype=np.int64)
    tets = []
    for perm in itertools.permutations(range(3)):
        a = bases
        b = bases + e[perm[0]]
        c = bases + e[perm[0]] + e[perm[1]]
        d = bases + 1
        tets.append(np.stack([gid(*a.T), gid(*b.T), gid(*c.T), gid(*d.T)], axis=1))
    cells = np.concatenate(tets, axis=0)

    # drop degenerate tets (apex collapse produces repeated vertices)
    distinct = (
        (cells[:, 0] != cells[:, 1])
        & (cells[:, 0] != cells[:, 2])
        & (cells[:, 0] != cells[:, 3])
        & (cells[:, 1] != cells[:, 2])
        & (cells[:, 1] != cells[:, 3])
        & (cells[:, 2] != cells[:, 3])
    )
    cells = cells[distinct]
    X = coords[cells]
    vol6 = np.linalg.det(X[:, 1:] - X[:, :1])
    cells = cells[np.abs(vol6) > 1e-14]

    mesh = Mesh(coords=coords, cells=cells.astype(np.int32), cell_type=CellType.tetrahedron)

    # facet markers: ENDO (t=0), EPI (t=1), BASE (mu = mu_base(t))
    markers = {"BASE": (5, 2), "ENDO": (6, 2), "EPI": (7, 2)}
    fdim = 2
    facets = mesh.entities(fdim)
    ext = mesh.exterior_facets()
    fverts = facets[ext]
    t_f = node_t[fverts]
    mu_f = node_mu[fverts]
    tol = 1e-9
    is_endo = (t_f < tol).all(axis=1)
    is_epi = (t_f > 1.0 - tol).all(axis=1)
    is_base = (np.abs(mu_f - mu_base(t_f)) < 1e-9).all(axis=1)
    idx, val = [], []
    for sel, (m, _) in [(is_base, markers["BASE"]), (is_endo, markers["ENDO"]), (is_epi, markers["EPI"])]:
        idx.append(ext[sel])
        val.append(np.full(int(sel.sum()), m, dtype=np.int32))
    ffun = meshtags(mesh, fdim, np.concatenate(idx), np.concatenate(val))

    # rule-based helical fibers per node: f = cos(a) e_theta + sin(a) e_mu
    a = np.deg2rad(fiber_angle_endo + (fiber_angle_epi - fiber_angle_endo) * node_t)
    mu, th, t = node_mu, node_th, node_t
    e_mu = np.stack(
        [-rl(t) * np.sin(mu), rs(t) * np.cos(mu) * np.cos(th), rs(t) * np.cos(mu) * np.sin(th)],
        axis=1,
    )
    e_th = np.stack(
        [np.zeros_like(mu), -rs(t) * np.sin(mu) * np.sin(th), rs(t) * np.sin(mu) * np.cos(th)],
        axis=1,
    )

    def _norm(v):
        n = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.where(n > 1e-12, n, 1.0)

    e_mu, e_th = _norm(e_mu), _norm(e_th)
    f0 = np.cos(a)[:, None] * e_th + np.sin(a)[:, None] * e_mu
    # apex nodes: e_th degenerate; fall back to the long axis
    apex = np.linalg.norm(e_th, axis=1) < 0.5
    f0[apex] = (1.0, 0.0, 0.0)
    f0 = _norm(f0)
    # sheet normal = transmural direction, sheet = n x f
    n0 = _norm(np.cross(e_mu, e_th))
    n0[apex] = (0.0, 0.0, 1.0)
    s0 = _norm(np.cross(n0, f0))

    return Geometry(mesh=mesh, ffun=ffun, markers=markers, f0=f0, s0=s0, n0=n0)
