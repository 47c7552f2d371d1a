"""Host-side simplex mesh layer (numpy only).

Copy of ``fenicsx_beat_tpu/mesh.py``: a mesh is a pair of plain numpy
arrays (vertex coordinates + cell connectivity) with lazily-computed
topology (edges, facets, boundary), built once on host.  Node ordering of
the structured generators is lexicographic with the x-index slowest, which
gives the P1 operator a single global stencil offset set.

The one difference from the JAX package: entity enumeration sorts one
int64 key per row with numpy where the JAX package calls its native
``unique_rows``.  The port's copy of the kit (:mod:`.native`) has that
function too, but the keys are faster: 0.52 s against the kit's 1.05 s
for the edges of the psize 0.1 LV (7.9M rows) on the host of an NVIDIA
H100 80GB HBM3 at 700 W (``benchmarks/setup_kit.py``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np

__all__ = [
    "CellType",
    "Mesh",
    "MeshTags",
    "meshtags",
    "locate_entities",
    "locate_entities_boundary",
    "create_interval",
    "create_unit_interval",
    "create_rectangle",
    "create_unit_square",
    "create_box",
    "create_unit_cube",
    "compute_midpoints",
]


class CellType(Enum):
    point = 0
    interval = 1
    triangle = 2
    tetrahedron = 3


_TDIM = {
    CellType.point: 0,
    CellType.interval: 1,
    CellType.triangle: 2,
    CellType.tetrahedron: 3,
}


def _pad3(x: np.ndarray) -> np.ndarray:
    """Pad coordinates to shape (3, N) as expected by marker callables."""
    out = np.zeros((3, x.shape[0]), dtype=x.dtype)
    out[: x.shape[1], :] = x.T
    return out


@dataclass
class _Topology:
    """Lazily filled entity tables: dim -> (entities [ne, dim+1] vertex ids)."""

    entities: dict[int, np.ndarray] = field(default_factory=dict)
    facet_cells: np.ndarray | None = None  # [n_facets, 2], -1 if boundary
    cell_facets: np.ndarray | None = None  # [n_cells, n_facets_per_cell]


@dataclass
class Mesh:
    coords: np.ndarray  # [n_vertices, gdim] float64
    cells: np.ndarray  # [n_cells, tdim+1] int32
    cell_type: CellType
    _topology: _Topology = field(default_factory=_Topology, repr=False)

    @property
    def tdim(self) -> int:
        return _TDIM[self.cell_type]

    @property
    def gdim(self) -> int:
        return self.coords.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    # dolfinx-compat surface used in demos/tests
    @property
    def topology(self):
        return self

    @property
    def dim(self) -> int:
        return self.tdim

    @property
    def geometry(self):
        return self

    @property
    def x(self) -> np.ndarray:
        return self.coords

    # ------------------------------------------------------------------
    def entities(self, dim: int) -> np.ndarray:
        """Vertex connectivity of all entities of dimension ``dim``.

        Entities are canonically sorted vertex tuples, enumerated in
        lexicographic order (deterministic across runs).
        """
        if dim == self.tdim:
            return self.cells
        if dim == 0:
            return np.arange(self.num_vertices, dtype=np.int32)[:, None]
        if dim in self._topology.entities:
            return self._topology.entities[dim]
        if dim == self.tdim - 1:
            # facet enumeration falls out of the fused facet-map pass
            # (identical lexicographic ids); avoids a second unique sweep
            self._facet_maps()
            return self._topology.entities[dim]
        nv = self.cells.shape[1]
        combos = list(itertools.combinations(range(nv), dim + 1))
        sub = np.concatenate([self.cells[:, list(c)] for c in combos], axis=0)
        sub = np.sort(sub, axis=1).astype(np.int32)
        ents = _unique_rows(sub, self.num_vertices)
        self._topology.entities[dim] = ents
        return ents

    def num_entities(self, dim: int) -> int:
        return self.entities(dim).shape[0]

    def _facet_maps(self) -> tuple[np.ndarray, np.ndarray]:
        """(facet_cells [nf,2] (-1 padded), cell_facets [nc, tdim+1]).

        One structured argsort over all (cell, local-facet) vertex tuples
        yields the facet enumeration (lexicographic — identical ids to
        ``entities(fdim)``), the cell->facet map, AND the facet->cell
        adjacency in a single pass.  The previous formulation (separate
        unique + 4 row-searchsorted passes + a Python loop over every
        cell) was the dominant cost of unstructured mesh construction:
        25 s of the 30 s LV build at 2.5M cells."""
        if self._topology.facet_cells is not None:
            return self._topology.facet_cells, self._topology.cell_facets  # type: ignore[return-value]
        fdim = self.tdim - 1
        nv = self.cells.shape[1]
        combos = list(itertools.combinations(range(nv), fdim + 1))
        nslots, nc = len(combos), self.num_cells
        # slot-major stack: flat index li*nc + ci (the encounter order the
        # facet_cells tie-breaks below are defined in)
        local_all = np.concatenate(
            [np.sort(self.cells[:, list(c)], axis=1) for c in combos], axis=0
        )
        k = local_all.shape[1]
        bits = max(1, int(self.num_vertices - 1).bit_length())
        if k * bits <= 63:
            # pack the (sorted) vertex tuple into one int64 key — a plain
            # integer argsort is ~8x faster than void-struct comparisons
            # (first column most significant preserves lexicographic order)
            key = local_all[:, 0].astype(np.int64)
            for j in range(1, k):
                key = (key << bits) | local_all[:, j].astype(np.int64)
            order = np.argsort(key, kind="stable")
            sv = key[order]
        else:  # pragma: no cover - >2^21-vertex facet tuples
            a = np.ascontiguousarray(local_all)
            av = a.view([("", a.dtype)] * a.shape[1]).ravel()
            order = np.argsort(av, kind="stable")  # lexicographic, stable
            sv = av[order]
        first = np.ones(sv.size, dtype=bool)
        first[1:] = sv[1:] != sv[:-1]
        if fdim == 0:
            # 1D meshes: facet ids ARE vertex ids (the entities(0)
            # contract), including vertices unused by any cell
            fid_sorted = local_all[order, 0].astype(np.int64)
            nf = self.num_vertices
        else:
            fid_sorted = np.cumsum(first, dtype=np.int64) - 1
            nf = int(fid_sorted[-1]) + 1 if sv.size else 0
            # facet vertex table in lexicographic id order == entities(fdim)
            facets = local_all[order[first]]
            self._topology.entities.setdefault(fdim, facets)
        # cell -> facet ids
        fids = np.empty(sv.size, dtype=np.int64)
        fids[order] = fid_sorted
        cell_facets = fids.reshape(nslots, nc).T.astype(np.int32).copy()
        # facet -> cells: within a facet group `order` is stable by flat
        # index = encounter order; col 0 = first encounter, col 1 = last
        # (matching the previous loop, which overwrote col 1 on every
        # repeat — welded apex facets can touch > 2 cells)
        owner = (order % nc).astype(np.int64)
        facet_cells = np.full((nf, 2), -1, dtype=np.int64)
        facet_cells[fid_sorted[first], 0] = owner[first]
        last = np.ones(sv.size, dtype=bool)
        last[:-1] = first[1:]
        second = last & ~first
        facet_cells[fid_sorted[second], 1] = owner[second]
        self._topology.facet_cells = facet_cells
        self._topology.cell_facets = cell_facets
        return facet_cells, cell_facets

    def exterior_facets(self) -> np.ndarray:
        """Indices of facets adjacent to exactly one cell."""
        facet_cells, _ = self._facet_maps()
        return np.nonzero(facet_cells[:, 1] < 0)[0].astype(np.int32)

    def boundary_vertices(self) -> np.ndarray:
        fdim = self.tdim - 1
        facets = self.entities(fdim)
        ext = self.exterior_facets()
        return np.unique(facets[ext].ravel())

    def facet_to_cell(self, facet_indices: np.ndarray) -> np.ndarray:
        """Owning (first adjacent) cell of each facet."""
        facet_cells, _ = self._facet_maps()
        return facet_cells[facet_indices, 0]

    # dolfinx-compat no-ops used by demos
    def create_connectivity(self, d0: int, d1: int) -> None:
        pass

    def basix_cell(self):
        return self.cell_type


def _row_keys(rows: np.ndarray, base: int) -> np.ndarray | None:
    """One int64 per row of nonnegative ints below ``base``, in the rows'
    lexicographic order (None when ``base ** ncols`` overflows int64)."""
    if base ** rows.shape[1] >= 2**63:
        return None
    keys = np.zeros(rows.shape[0], dtype=np.int64)
    for k in range(rows.shape[1]):
        keys = keys * base + rows[:, k]
    return keys


def _unique_rows(rows: np.ndarray, base: int) -> np.ndarray:
    """Lexicographically sorted unique rows of nonnegative ints below
    ``base``: one sort of int64 row keys (``np.unique(axis=0)`` when the
    keys would overflow)."""
    keys = _row_keys(rows, base)
    if keys is None:
        return np.unique(rows, axis=0)
    _, first = np.unique(keys, return_index=True)
    return rows[first]


def _row_searchsorted(sorted_rows: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of each query row in sorted_rows (rows of vertex ids; they
    must exist), through one int64 key a row where it fits."""
    base = int(max(sorted_rows.max(initial=0), query.max(initial=0))) + 1
    ka = _row_keys(sorted_rows, base)
    if ka is not None:
        return np.searchsorted(ka, _row_keys(query, base))
    # encode rows as tuples via void view for fast searchsorted
    a = np.ascontiguousarray(sorted_rows)
    b = np.ascontiguousarray(query.astype(sorted_rows.dtype))
    av = a.view([("", a.dtype)] * a.shape[1]).ravel()
    bv = b.view([("", b.dtype)] * b.shape[1]).ravel()
    idx = np.searchsorted(av, bv)
    return idx


# ---------------------------------------------------------------------------
# MeshTags


@dataclass
class MeshTags:
    mesh: Mesh
    dim: int
    indices: np.ndarray
    values: np.ndarray

    def find(self, value: int) -> np.ndarray:
        return self.indices[self.values == value]


def meshtags(mesh: Mesh, dim: int, indices: np.ndarray, values) -> MeshTags:
    indices = np.asarray(indices, dtype=np.int32)
    values = np.broadcast_to(np.asarray(values), indices.shape).copy()
    order = np.argsort(indices, kind="stable")
    return MeshTags(mesh=mesh, dim=dim, indices=indices[order], values=values[order])


def locate_entities(mesh: Mesh, dim: int, marker: Callable) -> np.ndarray:
    """Entities of dimension ``dim`` whose vertices ALL satisfy ``marker``.

    ``marker`` receives coordinates shaped (3, N) (dolfinx convention).
    """
    ok = np.asarray(marker(_pad3(mesh.coords)), dtype=bool)
    ents = mesh.entities(dim)
    if dim == 0:
        return np.nonzero(ok)[0].astype(np.int32)
    hit = ok[ents].all(axis=1)
    return np.nonzero(hit)[0].astype(np.int32)


def locate_entities_boundary(mesh: Mesh, dim: int, marker: Callable) -> np.ndarray:
    """Boundary entities of dimension ``dim`` whose vertices satisfy marker."""
    ok = np.asarray(marker(_pad3(mesh.coords)), dtype=bool)
    bverts = np.zeros(mesh.num_vertices, dtype=bool)
    bverts[mesh.boundary_vertices()] = True
    ok = ok & bverts
    if dim == mesh.tdim - 1:
        ents = mesh.entities(dim)
        ext = mesh.exterior_facets()
        hit = ok[ents[ext]].all(axis=1)
        return ext[hit]
    ents = mesh.entities(dim)
    if dim == 0:
        return np.nonzero(ok)[0].astype(np.int32)
    hit = ok[ents].all(axis=1)
    return np.nonzero(hit)[0].astype(np.int32)


def compute_midpoints(mesh: Mesh, dim: int, indices: np.ndarray) -> np.ndarray:
    ents = mesh.entities(dim)
    if dim == 0:
        return mesh.coords[indices]
    return mesh.coords[ents[indices]].mean(axis=1)


# ---------------------------------------------------------------------------
# Structured generators (reference: dolfinx create_interval/rectangle/box used
# at geometry.py:112-139 and in tests)


def create_interval(comm=None, n: int = 1, points=(0.0, 1.0), dtype=np.float64) -> Mesh:
    # allow comm-less positional calls: (n,) or (n, points)
    if isinstance(comm, (int, np.integer)) and not isinstance(n, (int, np.integer)):
        comm, n, points = None, comm, n
    elif isinstance(comm, (int, np.integer)):
        comm, n = None, comm
    a, b = float(points[0]), float(points[1])
    x = np.linspace(a, b, n + 1, dtype=dtype)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1).astype(np.int32)
    return Mesh(coords=x, cells=cells, cell_type=CellType.interval)


def create_unit_interval(comm=None, n: int = 1, dtype=np.float64) -> Mesh:
    if comm is not None and isinstance(comm, (int, np.integer)):
        comm, n = None, comm
    return create_interval(None, n, (0.0, 1.0), dtype=dtype)


def create_rectangle(
    comm=None,
    points=((0.0, 0.0), (1.0, 1.0)),
    n=(1, 1),
    cell_type: CellType = CellType.triangle,
    dtype=np.float64,
) -> Mesh:
    (x0, y0), (x1, y1) = np.asarray(points[0], dtype=float), np.asarray(points[1], dtype=float)
    nx, ny = int(n[0]), int(n[1])
    xs = np.linspace(x0, x1, nx + 1, dtype=dtype)
    ys = np.linspace(y0, y1, ny + 1, dtype=dtype)
    X, Y = np.meshgrid(xs, ys, indexing="ij")  # index = ix*(ny+1) + iy
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (ix * (ny + 1) + iy).ravel()
    v10 = ((ix + 1) * (ny + 1) + iy).ravel()
    v01 = (ix * (ny + 1) + iy + 1).ravel()
    v11 = ((ix + 1) * (ny + 1) + iy + 1).ravel()
    # two triangles per quad, diagonal v00-v11
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.concatenate([t1, t2], axis=0).astype(np.int32)
    return Mesh(coords=coords, cells=cells, cell_type=CellType.triangle)


def create_unit_square(
    comm=None, nx: int = 1, ny: int = 1, cell_type: CellType = CellType.triangle, dtype=np.float64
) -> Mesh:
    if comm is not None and isinstance(comm, (int, np.integer)):
        comm, nx, ny = None, comm, nx
    return create_rectangle(None, ((0.0, 0.0), (1.0, 1.0)), (nx, ny), cell_type, dtype)


# Kuhn decomposition of the unit cube into 6 tetrahedra: for each permutation
# of the axes, the path 000 -> e_p0 -> e_p0+e_p1 -> 111.
_KUHN_PERMS = list(itertools.permutations(range(3)))


def create_box(
    comm=None,
    points=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    n=(1, 1, 1),
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
) -> Mesh:
    p0 = np.asarray(points[0], dtype=float)
    p1 = np.asarray(points[1], dtype=float)
    nx, ny, nz = int(n[0]), int(n[1]), int(n[2])
    xs = np.linspace(p0[0], p1[0], nx + 1, dtype=dtype)
    ys = np.linspace(p0[1], p1[1], ny + 1, dtype=dtype)
    zs = np.linspace(p0[2], p1[2], nz + 1, dtype=dtype)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")  # ix slowest
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    base = np.stack([ix, iy, iz], axis=1)  # [ncubes, 3]
    e = np.eye(3, dtype=np.int64)
    tets = []
    for perm in _KUHN_PERMS:
        a = base
        b = base + e[perm[0]]
        c = base + e[perm[0]] + e[perm[1]]
        d = base + 1
        tet = np.stack(
            [
                vid(a[:, 0], a[:, 1], a[:, 2]),
                vid(b[:, 0], b[:, 1], b[:, 2]),
                vid(c[:, 0], c[:, 1], c[:, 2]),
                vid(d[:, 0], d[:, 1], d[:, 2]),
            ],
            axis=1,
        )
        tets.append(tet)
    cells = np.concatenate(tets, axis=0).astype(np.int32)
    return Mesh(coords=coords, cells=cells, cell_type=CellType.tetrahedron)


def create_unit_cube(
    comm=None,
    nx: int = 1,
    ny: int = 1,
    nz: int = 1,
    cell_type: CellType = CellType.tetrahedron,
    dtype=np.float64,
) -> Mesh:
    if comm is not None and isinstance(comm, (int, np.integer)):
        comm, nx, ny, nz = None, comm, nx, ny
    return create_box(None, ((0.0,) * 3, (1.0,) * 3), (nx, ny, nz), cell_type, dtype)
