"""Finite-element layer: elements, spaces, functions, cell geometry,
stencil and ELL assembly, cell and facet quadrature, scalar forms,
Dirichlet dofs, point evaluation and transfer between spaces.

Host-side (numpy) port of ``fenicsx_beat_tpu/fem.py``: continuous
Lagrange of any degree, discontinuous Lagrange of any degree (0
included), Quadrature spaces, blocked (vector) spaces over any of them,
and embedded meshes in the cell geometry.  The dof numbering is the JAX
package's: vertices, then each edge's interior dofs in ``mesh.entities(1)``
order, then face and cell interiors; ``dof_owner_cell`` is the last cell
holding a dof.  Every array here is built once on the host; the solvers
move the results to their device.

Two products run on the device: :meth:`CellQuadData.assemble_load` (a
general stimulus expression's load: the expression at the quadrature
points, then the cell-to-dof sum as one CSR product through a 0/1 map
built once on the host, so the sum has a fixed order and no float
atomics) and :meth:`Function.interpolate` from another function (one
product with the transfer matrix of :func:`build_transfer_matrix`, a
rectangular :class:`~.ops.cuda_ell.CSRMatrix` kept per device).  Each is
one launch of B8 (``ops/cuda_ell.csr_spmv``) on a CUDA tensor and its twin
on a CPU tensor.

Assembly above P1 uses the affine reference tensors: on a simplex with
a cellwise-constant conductivity every element matrix is a cell constant
times a matrix tabulated once, ``Me = |K| M_hat`` and ``Ke = |K| sum_ts
(G M G^T)_ts S_hat_ts`` with ``G`` the cell's inverse Jacobian, which
equals the JAX package's exact quadrature to rounding at a fraction of
its host time.  The triplets pack into one CSR pattern without a global
sort (:func:`_cell_blocks_to_csr`), and P1 keeps the closed form and the
COO pipeline of the JAX package's numpy branch.  Where the JAX package
calls its native C++ kit, the port takes the kit's numpy branch: the slot
loop of ``assemble_mass_stiffness_stencil`` and the bounding-box-prefiltered
barycentric sweep of ``_locate_cells``.

The operator disk cache (the JAX package's ``fem.py:869-894, 1080-1165``):
a ``cache_key`` opts an assembly into it (:mod:`.cache`, kind
``operators``); the slot is a sha256 fingerprint of the key, the space
(degree, dofs, cells), the dtype and the bytes of the mesh's coordinates
and cells and of the conductivity, so the content decides a hit and a hit
returns the arrays of a fresh assembly bit for bit.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import cache
from .convert import stencil_from_numpy
from .mesh import Mesh, _row_searchsorted
from .ops.quadrature import simplex_rule
from .ops.sparse import ELLMatrix, _build_ell, coo_to_ell_group, ell_to_stencil

__all__ = [
    "Element",
    "FunctionSpace",
    "functionspace",
    "Function",
    "Constant",
    "CellGeometry",
    "cell_geometry",
    "interpolation_points",
    "assemble_mass_stiffness_stencil",
    "assemble_mass_stiffness_coo",
    "assemble_mass_stiffness",
    "assemble_mass_stiffness_auto",
    "CellQuadData",
    "cell_quadrature",
    "facet_quadrature",
    "ScalarForm",
    "assemble_scalar",
    "integral",
    "function_integral",
    "locate_dofs_topological",
    "DirichletBC",
    "dirichletbc",
    "evaluate_function",
    "point_evaluation_tables",
    "build_transfer_matrix",
    "transfer_operator",
]


# ---------------------------------------------------------------------------
# Elements


def _bary(pts: np.ndarray) -> np.ndarray:
    """Barycentric coords [np, tdim+1] of reference-simplex points [np, tdim]."""
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, pts], axis=1)


def _edge_combos(tdim: int) -> list[tuple[int, int]]:
    return list(itertools.combinations(range(tdim + 1), 2))


def _face_combos(tdim: int) -> list[tuple[int, int, int]]:
    return list(itertools.combinations(range(tdim + 1), 3))


def _interior_multiindices(nverts: int, p: int) -> list[tuple[int, ...]]:
    """Barycentric multi-indices with every component >= 1 summing to p,
    in lexicographic order: the canonical order of entity-interior lattice
    dofs shared between cells."""
    out = []
    for combo in itertools.product(range(1, p), repeat=nverts - 1):
        last = p - sum(combo)
        if last >= 1:
            out.append(combo + (last,))
    return sorted(out)


def _lattice_multiindices(tdim: int, p: int) -> np.ndarray:
    """Equispaced-lattice barycentric multi-indices [nd, tdim+1] of the
    degree-``p`` simplex Lagrange element, in the canonical dof order:
    vertices, then per-edge interior (k = multiplicity at the edge's
    second vertex), then per-face interior, then cell interior."""
    nv = tdim + 1
    rows: list[tuple[int, ...]] = []
    for i in range(nv):  # vertices
        a = [0] * nv
        a[i] = p
        rows.append(tuple(a))
    for i, j in _edge_combos(tdim):  # edges
        for k in range(1, p):
            a = [0] * nv
            a[i] = p - k
            a[j] = k
            rows.append(tuple(a))
    if tdim >= 2:
        for combo in _face_combos(tdim) if tdim == 3 else [tuple(range(nv))]:
            if tdim == 2 and p < 3:
                continue
            for m in _interior_multiindices(3, p):
                a = [0] * nv
                for pos, mult in zip(combo, m):
                    a[pos] = mult
                rows.append(tuple(a))
    if tdim == 3 and p >= 4:
        for m in _interior_multiindices(4, p):
            rows.append(tuple(m))
    return np.asarray(rows, dtype=np.int64)


def _silvester_factors(lam_i: np.ndarray, a: int, p: int):
    """P(lam) = prod_{k<a} (p lam - k) / a!  and its lam-derivative, at points."""
    if a == 0:
        return np.ones_like(lam_i), np.zeros_like(lam_i)
    terms = [p * lam_i - k for k in range(a)]
    P = np.ones_like(lam_i)
    for t in terms:
        P = P * t
    dP = np.zeros_like(lam_i)
    for k in range(a):
        prod = np.ones_like(lam_i)
        for k2 in range(a):
            if k2 != k:
                prod = prod * terms[k2]
        dP = dP + p * prod
    fact = math.factorial(a)
    return P / fact, dP / fact


@dataclass(frozen=True)
class Element:
    family: str  # "P" | "DG" | "Quadrature"
    degree: int

    @property
    def discontinuous(self) -> bool:
        return self.family in ("DG", "Quadrature")

    @property
    def family_name(self) -> str:
        return {"P": "Lagrange", "DG": "Discontinuous Lagrange", "Quadrature": "Quadrature"}[self.family]

    def ndofs_per_cell(self, tdim: int) -> int:
        if self.family == "Quadrature":
            return simplex_rule(tdim, self.degree)[0].shape[0]
        if self.degree == 0:
            return 1
        if self.degree == 1:
            return tdim + 1
        if self.degree == 2:
            return (tdim + 1) + len(_edge_combos(tdim))
        return math.comb(self.degree + tdim, tdim)

    def dof_ref_points(self, tdim: int) -> np.ndarray:
        """Interpolation points in the reference cell, one per local dof."""
        verts = np.concatenate([np.zeros((1, tdim)), np.eye(tdim)], axis=0)
        if self.family == "Quadrature":
            return simplex_rule(tdim, self.degree)[0]
        if self.degree == 0:
            return verts.mean(axis=0, keepdims=True)
        if self.degree == 1:
            return verts
        if self.degree == 2:
            mids = np.stack([(verts[i] + verts[j]) / 2 for i, j in _edge_combos(tdim)])
            return np.concatenate([verts, mids], axis=0)
        alphas = _lattice_multiindices(tdim, self.degree)
        return (alphas[:, 1:] / self.degree).astype(np.float64)

    def tabulate(self, tdim: int, pts: np.ndarray) -> np.ndarray:
        """Basis values [np, ndofs_per_cell] at reference points [np, tdim]."""
        if self.family == "Quadrature":
            raise TypeError("Quadrature elements have no pointwise basis")
        lam = _bary(pts)
        if self.degree == 0:
            return np.ones((pts.shape[0], 1))
        if self.degree == 1:
            return lam
        if self.degree == 2:
            vert = lam * (2 * lam - 1)
            edge = np.stack([4 * lam[:, i] * lam[:, j] for i, j in _edge_combos(tdim)], axis=1)
            return np.concatenate([vert, edge], axis=1)
        # any degree: Silvester's closed form on the equispaced lattice
        p = self.degree
        alphas = _lattice_multiindices(tdim, p)
        phi = np.ones((pts.shape[0], alphas.shape[0]))
        for d, alpha in enumerate(alphas):
            for i, a in enumerate(alpha):
                if a:
                    P, _ = _silvester_factors(lam[:, i], int(a), p)
                    phi[:, d] *= P
        return phi

    def tabulate_grad(self, tdim: int, pts: np.ndarray) -> np.ndarray:
        """Reference gradients [np, ndofs_per_cell, tdim]."""
        npts = pts.shape[0]
        lam = _bary(pts)
        # d(lam)/d(xi): lam0 -> -1 each direction; lam_i -> e_i
        dlam = np.concatenate([-np.ones((1, tdim)), np.eye(tdim)], axis=0)  # [tdim+1, tdim]
        if self.degree == 1:
            return np.broadcast_to(dlam, (npts, tdim + 1, tdim)).copy()
        if self.degree == 2:
            parts = []
            for i in range(tdim + 1):
                parts.append((4 * lam[:, i : i + 1] - 1) * dlam[i][None, :])
            for i, j in _edge_combos(tdim):
                parts.append(4 * (lam[:, i : i + 1] * dlam[j][None, :] + lam[:, j : j + 1] * dlam[i][None, :]))
            return np.stack(parts, axis=1)
        if self.degree == 0:
            return np.zeros((npts, 1, tdim))
        # any degree: product rule over the per-coordinate Silvester
        # factors, then the chain rule lambda -> xi
        p = self.degree
        alphas = _lattice_multiindices(tdim, p)
        nd = alphas.shape[0]
        grad_lam = np.zeros((npts, nd, tdim + 1))
        for d, alpha in enumerate(alphas):
            Ps, dPs = [], []
            for i, a in enumerate(alpha):
                P, dP = _silvester_factors(lam[:, i], int(a), p)
                Ps.append(P)
                dPs.append(dP)
            for i in range(tdim + 1):
                g = dPs[i].copy()
                for j in range(tdim + 1):
                    if j != i:
                        g *= Ps[j]
                grad_lam[:, d, i] = g
        return np.einsum("pdi,it->pdt", grad_lam, dlam)


_FAMILY_ALIASES = {
    "P": "P",
    "CG": "P",
    "Lagrange": "P",
    "DG": "DG",
    "dP": "DG",
    "Discontinuous Lagrange": "DG",
    "Q": "Quadrature",
    "Quad": "Quadrature",
    "Quadrature": "Quadrature",
}


# ---------------------------------------------------------------------------
# Function space


@dataclass
class FunctionSpace:
    """A space on ``mesh``: ``cell_dofs`` [nc, ndpc] int32, ``ndofs``,
    ``dof_coords`` [ndofs, gdim].  Blocked (vector) spaces use the dolfinx
    interleaved layout, global dof = scalar dof * ``block_size`` +
    component, over ``scalar_base``.  ``dof_owner_cell`` [ndofs] int32 is
    the largest index of a cell holding the dof (the cell every transfer
    evaluates a dof in), made at its first use."""

    mesh: Mesh
    element: Element
    cell_dofs: np.ndarray
    ndofs: int
    dof_coords: np.ndarray
    block_size: int = 1
    scalar_base: "FunctionSpace | None" = None
    _owner: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def ndofs_per_cell(self) -> int:
        return self.cell_dofs.shape[1]

    @property
    def value_shape(self) -> tuple:
        return () if self.block_size == 1 else (self.block_size,)

    @property
    def scalar_space(self) -> "FunctionSpace":
        """The scalar component space (self when already scalar)."""
        return self.scalar_base if self.scalar_base is not None else self

    @property
    def dof_owner_cell(self) -> np.ndarray:
        if self._owner is None:
            if self.scalar_base is not None:
                self._owner = np.repeat(self.scalar_base.dof_owner_cell, self.block_size)
            else:
                nc, ndpc = self.cell_dofs.shape
                owner = np.full(self.ndofs, -1, dtype=np.int64)
                np.maximum.at(owner, self.cell_dofs.ravel(), np.repeat(np.arange(nc), ndpc))
                self._owner = owner.astype(np.int32)
        return self._owner

    # dolfinx-style names
    @property
    def dofmap(self):
        return self

    @property
    def index_map(self):
        return self

    @property
    def size_local(self) -> int:
        return self.ndofs

    @property
    def num_ghosts(self) -> int:
        return 0

    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self.dof_coords


def _space_from_element(mesh: Mesh, element: Element) -> FunctionSpace:
    tdim = mesh.tdim
    ndpc = element.ndofs_per_cell(tdim)
    nc = mesh.num_cells

    if element.family == "P" and element.degree == 1:
        cell_dofs = mesh.cells
        ndofs = mesh.num_vertices
        dof_coords = mesh.coords
    elif element.family == "P" and element.degree == 2:
        edges = mesh.entities(1)
        order = np.lexsort(edges.T[::-1])
        sorted_edges = edges[order]
        edge_ids = np.empty((nc, len(_edge_combos(tdim))), dtype=np.int64)
        for li, (i, j) in enumerate(_edge_combos(tdim)):
            local = np.sort(mesh.cells[:, [i, j]], axis=1)
            edge_ids[:, li] = order[_row_searchsorted(sorted_edges, local)]
        cell_dofs = np.concatenate([mesh.cells.astype(np.int64), mesh.num_vertices + edge_ids], axis=1)
        ndofs = mesh.num_vertices + edges.shape[0]
        mids = mesh.coords[edges].mean(axis=1)
        dof_coords = np.concatenate([mesh.coords, mids], axis=0)
    elif element.discontinuous:
        cell_dofs = np.arange(nc * ndpc, dtype=np.int32).reshape(nc, ndpc)
        ndofs = nc * ndpc
        refpts = element.dof_ref_points(tdim)
        geom = cell_geometry(mesh)
        x0 = mesh.coords[mesh.cells[:, 0]]  # x = x0 + refpts @ E, per cell
        dof_coords = (x0[:, None, :] + np.einsum("qd,cdg->cqg", refpts, geom.edges)).reshape(ndofs, mesh.gdim)
    elif element.family == "P":
        cell_dofs, ndofs, dof_coords = _generic_lagrange_dofmap(mesh, element.degree)
    else:
        raise NotImplementedError(f"{element}")
    return FunctionSpace(
        mesh=mesh,
        element=element,
        cell_dofs=np.ascontiguousarray(cell_dofs, dtype=np.int32),
        ndofs=int(ndofs),
        dof_coords=dof_coords,
    )


def _face_interior_lookup(p: int) -> np.ndarray:
    """Table mapping a face-interior multiplicity pair (a0, a1), with
    a2 = p - a0 - a1 implied, to its canonical slot (the lexicographic
    order of ``_interior_multiindices(3, p)``)."""
    table = np.full((p + 1, p + 1), -1, dtype=np.int64)
    for idx, m in enumerate(_interior_multiindices(3, p)):
        table[m[0], m[1]] = idx
    return table


def _edge_slot_columns(mesh: Mesh, verts: np.ndarray, p: int, combos) -> list[np.ndarray]:
    """Global edge-interior dofs of the local edges ``combos`` of the
    vertex tuples ``verts`` [n, k]: ``p - 1`` dofs per edge, numbered by
    multiplicity at the edge's larger global vertex, so the two cells of
    an edge agree whatever their local orientation."""
    edges = mesh.entities(1)
    order = np.lexsort(edges.T[::-1])
    sorted_edges = edges[order]
    nvert = mesh.num_vertices
    columns = []
    for i, j in combos:
        gi, gj = verts[:, i], verts[:, j]
        eid = order[_row_searchsorted(sorted_edges, np.stack([np.minimum(gi, gj), np.maximum(gi, gj)], axis=1))]
        flip = gi > gj
        for k in range(1, p):  # lattice dof: multiplicity k at local vertex j
            columns.append(nvert + eid * (p - 1) + np.where(flip, p - k - 1, k - 1))
    return columns


def _face_slot_columns(mesh: Mesh, fverts: np.ndarray, p: int, face_offset: int) -> list[np.ndarray]:
    """Global face-interior dofs of the faces ``fverts`` [n, 3] (global
    vertices in local order), in ``_interior_multiindices(3, p)`` order of
    the local vertices, placed by the face's sorted global vertices."""
    faces = mesh.entities(2)
    forder = np.lexsort(faces.T[::-1])
    sorted_faces = faces[forder]
    n_face_int = (p - 1) * (p - 2) // 2
    lookup = _face_interior_lookup(p)
    n = fverts.shape[0]
    fid = forder[_row_searchsorted(sorted_faces, np.sort(fverts, axis=1))]
    rank = np.argsort(np.argsort(fverts, axis=1), axis=1)  # local -> sorted position
    columns = []
    for m in _interior_multiindices(3, p):
        cm = np.zeros((n, 3), dtype=np.int64)
        for t in range(3):
            cm[np.arange(n), rank[:, t]] = m[t]
        columns.append(face_offset + fid * n_face_int + lookup[cm[:, 0], cm[:, 1]])
    return columns


def _generic_lagrange_dofmap(mesh: Mesh, p: int):
    """Entity-based dofmap for continuous degree-``p`` simplex Lagrange.

    Global numbering: mesh vertices, then ``p-1`` dofs per edge (ordered
    by multiplicity at the edge's larger global vertex), then face-interior
    dofs per face (canonical order over the face's sorted global vertices),
    then cell-interior dofs.  The column order of ``cell_dofs`` matches
    ``_lattice_multiindices``, so the tabulated basis pairs with it."""
    tdim = mesh.tdim
    nc = mesh.num_cells
    cells64 = mesh.cells.astype(np.int64)
    nvert = mesh.num_vertices
    columns: list[np.ndarray] = [cells64[:, i] for i in range(tdim + 1)]
    coords_blocks: list[np.ndarray] = [mesh.coords]

    # edge dofs: dof s (0-based) lies at multiplicity s+1 of the larger vertex
    edges = mesh.entities(1)
    n_edges = edges.shape[0]
    columns += _edge_slot_columns(mesh, cells64, p, _edge_combos(tdim))
    elo = mesh.coords[np.minimum(edges[:, 0], edges[:, 1])]
    ehi = mesh.coords[np.maximum(edges[:, 0], edges[:, 1])]
    s = (np.arange(1, p) / p)[None, :, None]
    coords_blocks.append(((1 - s) * elo[:, None, :] + s * ehi[:, None, :]).reshape(-1, mesh.gdim))
    offset = nvert + n_edges * (p - 1)

    # face-interior dofs
    n_face_int = (p - 1) * (p - 2) // 2
    if tdim == 3 and n_face_int:
        faces = mesh.entities(2)
        for combo in _face_combos(3):
            columns += _face_slot_columns(mesh, cells64[:, combo], p, offset)
        fverts = mesh.coords[np.sort(faces, axis=1)]  # [nf, 3, gdim]
        mlist = np.asarray(_interior_multiindices(3, p), dtype=np.float64) / p
        coords_blocks.append(np.einsum("mk,fkg->fmg", mlist, fverts).reshape(-1, mesh.gdim))
        offset += faces.shape[0] * n_face_int
    elif tdim == 2 and n_face_int:
        # triangle interior: cell-local, sequential slots in lattice order
        for t in range(n_face_int):
            columns.append(offset + np.arange(nc, dtype=np.int64) * n_face_int + t)
        mlist = np.asarray(_interior_multiindices(3, p), dtype=np.float64) / p
        coords_blocks.append(np.einsum("mk,ckg->cmg", mlist, mesh.coords[cells64]).reshape(-1, mesh.gdim))
        offset += nc * n_face_int

    # cell-interior dofs (tets, p >= 4)
    if tdim == 3 and p >= 4:
        cell_ms = _interior_multiindices(4, p)
        n_int = len(cell_ms)
        for t in range(n_int):
            columns.append(offset + np.arange(nc, dtype=np.int64) * n_int + t)
        mlist = np.asarray(cell_ms, dtype=np.float64) / p
        coords_blocks.append(np.einsum("mk,ckg->cmg", mlist, mesh.coords[cells64]).reshape(-1, mesh.gdim))
        offset += nc * n_int

    dof_coords = np.concatenate(coords_blocks, axis=0)
    assert dof_coords.shape[0] == offset
    return np.stack(columns, axis=1).astype(np.int32), int(offset), dof_coords


def functionspace(mesh: Mesh, element, shape: tuple | None = None) -> FunctionSpace:
    """A function space.  ``element`` is an :class:`Element`, a ``(family,
    degree)`` tuple or a ``(family, degree, (dim,))`` tuple (a blocked
    vector space, as ``dolfinx.fem.functionspace(mesh, ("P", 1, (3,)))``);
    ``shape`` may also be given on its own."""
    if isinstance(element, tuple):
        if len(element) == 3:
            family, degree, shape = element
        else:
            family, degree = element
        element = Element(_FAMILY_ALIASES[family], int(degree))
    V = _space_from_element(mesh, element)
    bs = int(np.prod(shape)) if shape else 1
    return _blocked_space(V, bs) if bs > 1 else V


def _blocked_space(V: FunctionSpace, bs: int) -> FunctionSpace:
    """Vector-valued space over ``V`` with ``bs`` interleaved components
    (dof = scalar_dof * bs + component)."""
    nc = V.cell_dofs.shape[0]
    cell_dofs = (V.cell_dofs[:, :, None].astype(np.int64) * bs + np.arange(bs)[None, None, :]).reshape(nc, -1)
    return FunctionSpace(
        mesh=V.mesh,
        element=V.element,
        cell_dofs=cell_dofs.astype(np.int32),
        ndofs=V.ndofs * bs,
        dof_coords=np.repeat(V.dof_coords, bs, axis=0),
        block_size=bs,
        scalar_base=V,
    )


# ---------------------------------------------------------------------------
# Functions & constants


class _XView:
    """Mimics dolfinx's ``Function.x``: mutable host array + scatter no-op."""

    def __init__(self, array: np.ndarray):
        self._array = array

    @property
    def array(self) -> np.ndarray:
        return self._array

    @array.setter
    def array(self, v) -> None:
        self._array[...] = v

    def scatter_forward(self) -> None:  # single-process host view
        pass


class Function:
    """A finite-element function: host dof array + its space (the
    dolfinx-style mutable ``.x.array``).  Device code takes the array as a
    tensor; the solvers keep their state on the device."""

    def __init__(self, V: FunctionSpace, name: str | None = None, dtype=np.float64):
        self._V = V
        self.name = name or "f"
        self._array = np.zeros(V.ndofs, dtype=dtype)
        self.x = _XView(self._array)

    @property
    def function_space(self) -> FunctionSpace:
        return self._V

    def ufl_element(self):
        return self._V.element

    def copy(self) -> "Function":
        f = Function(self._V, name=self.name)
        f.x.array[:] = self.x.array
        return f

    def interpolate(self, source, device=None, use_kernels: bool = True) -> None:
        """Set the dofs from another :class:`Function` or from a callable.

        From a function: one product with the transfer matrix
        (:func:`build_transfer_matrix`, kept on the device by
        :func:`transfer_operator`) on ``device`` (the card when None) in its
        working dtype, component by component on blocked spaces: the source
        values go up in that dtype, the result comes down.  The product is
        B8 (its twin on the CPU, or with ``use_kernels=False``).  From a
        callable: the callable
        of the ``[3, n_scalar_dofs]`` dof coordinates (zero rows beyond
        gdim), on the host; a blocked space's callable returns ``[bs,
        n_scalar_dofs]``."""
        from .config import default_dtype, resolve_device
        from .ops.cuda_ell import csr_spmv, csr_spmv_twin

        V = self._V
        bs = V.block_size
        if isinstance(source, Function):
            Vs = source.function_space
            if Vs.block_size != bs:
                raise ValueError(
                    f"cannot interpolate a {Vs.block_size}-component function into a {bs}-component space"
                )
            dev = resolve_device(device)
            T = transfer_operator(Vs.scalar_space, V.scalar_space, dev, default_dtype(dev))
            src = torch.from_numpy(np.ascontiguousarray(source.x.array.reshape(-1, bs))).to(T.vals.dtype).to(dev)
            spmv = csr_spmv if use_kernels else csr_spmv_twin
            out = torch.stack([spmv(T, src[:, c].contiguous()) for c in range(bs)], dim=1)
            self.x.array[:] = out.cpu().numpy().reshape(-1)
            return
        if callable(source):
            ns = V.ndofs // bs
            x = np.zeros((3, ns))
            x[: V.mesh.gdim, :] = V.scalar_space.dof_coords.T
            vals = np.asarray(source(x))
            if bs == 1:
                self.x.array[:] = np.broadcast_to(vals, (ns,))
            else:
                self.x.array[:] = np.broadcast_to(vals, (bs, ns)).T.reshape(-1)
            return
        raise TypeError(f"Cannot interpolate from {type(source)}")

    def eval(self, points: np.ndarray) -> np.ndarray:
        return evaluate_function(self, points)


class Constant:
    """Mutable scalar/vector constant (mirrors ``dolfinx.fem.Constant``)."""

    def __init__(self, mesh_or_value, value=None):
        if value is None:
            value = mesh_or_value
        self._value = np.asarray(value, dtype=np.float64)

    @property
    def value(self):
        return self._value if self._value.ndim else float(self._value)

    @value.setter
    def value(self, v):
        self._value = np.asarray(v, dtype=np.float64)

    def __float__(self) -> float:
        return float(self._value)

    def __len__(self) -> int:
        return self._value.shape[0] if self._value.ndim else 0

    def __array__(self, dtype=None):
        return np.asarray(self._value, dtype=dtype)


def interpolation_points(V: FunctionSpace) -> np.ndarray:
    """The element's interpolation points in the reference cell
    (reference ``utils.py:19-23``)."""
    return V.element.dof_ref_points(V.mesh.tdim)


# ---------------------------------------------------------------------------
# Cell geometry


@dataclass
class CellGeometry:
    edges: np.ndarray  # [nc, tdim, gdim] edge vectors from vertex 0
    volume: np.ndarray  # [nc]
    grads: np.ndarray  # [nc, tdim+1, gdim]  physical gradients of P1 basis
    inv_edges: np.ndarray  # [nc, tdim, gdim] rows = grad of ref coord xi_i


def _batched_det_inv(E: np.ndarray):
    """Determinant and inverse of [nc, d, d] batches via cofactors (the
    closed form is pure vectorized arithmetic; ``np.linalg`` would send
    each tiny matrix through LAPACK)."""

    def _check(det):
        if np.any(det == 0):
            raise np.linalg.LinAlgError(
                "singular cell Jacobian: mesh contains degenerate "
                "(zero-volume) cells"
            )

    d = E.shape[-1]
    if d == 1:
        det = E[:, 0, 0]
        _check(det)
        inv = (1.0 / det)[:, None, None]
        return det, inv
    if d == 2:
        a, b = E[:, 0, 0], E[:, 0, 1]
        c, dd = E[:, 1, 0], E[:, 1, 1]
        det = a * dd - b * c
        _check(det)
        inv = np.empty_like(E)
        r = 1.0 / det
        inv[:, 0, 0] = dd * r
        inv[:, 0, 1] = -b * r
        inv[:, 1, 0] = -c * r
        inv[:, 1, 1] = a * r
        return det, inv
    if d == 3:
        a = E[:, 0, 0]; b = E[:, 0, 1]; c = E[:, 0, 2]  # noqa: E702
        p = E[:, 1, 0]; q = E[:, 1, 1]; r = E[:, 1, 2]  # noqa: E702
        u = E[:, 2, 0]; v = E[:, 2, 1]; w = E[:, 2, 2]  # noqa: E702
        A = q * w - r * v
        B = r * u - p * w
        C = p * v - q * u
        det = a * A + b * B + c * C
        _check(det)
        inv = np.empty_like(E)
        s = 1.0 / det
        inv[:, 0, 0] = A * s
        inv[:, 1, 0] = B * s
        inv[:, 2, 0] = C * s
        inv[:, 0, 1] = (c * v - b * w) * s
        inv[:, 1, 1] = (a * w - c * u) * s
        inv[:, 2, 1] = (b * u - a * v) * s
        inv[:, 0, 2] = (b * r - c * q) * s
        inv[:, 1, 2] = (c * p - a * r) * s
        inv[:, 2, 2] = (a * q - b * p) * s
        return det, inv
    return np.linalg.det(E), np.linalg.inv(E)


def cell_geometry(mesh: Mesh, cells: np.ndarray | None = None) -> CellGeometry:
    """Per-cell affine geometry (edges, volume, basis gradients).  The
    full-mesh result is cached on the mesh; with ``cells`` only that subset
    is computed (a small stimulus or probe region must not force the whole
    mesh's geometry).  An embedded mesh (``tdim < gdim``) takes the
    Gram-matrix form: volume ``sqrt(det(E E^T)) / tdim!`` and the gradients
    in the cell's tangent space."""
    cached = getattr(mesh, "_cell_geometry", None)
    if cached is not None:
        if cells is None:
            return cached
        cells = np.asarray(cells)
        return CellGeometry(
            edges=cached.edges[cells],
            volume=cached.volume[cells],
            grads=cached.grads[cells],
            inv_edges=cached.inv_edges[cells],
        )
    tdim, gdim = mesh.tdim, mesh.gdim
    cell_verts = mesh.cells if cells is None else mesh.cells[np.asarray(cells)]
    X = mesh.coords[cell_verts]  # [nc, tdim+1, gdim]
    E = X[:, 1:, :] - X[:, :1, :]  # [nc, tdim, gdim]
    if tdim == gdim:
        detJ, invE = _batched_det_inv(E)
        vol = np.abs(detJ) / math.factorial(tdim)
        # xi = (x - x0) @ invE, so grad xi_i = invE[:, i]
        Gi = np.transpose(invE, (0, 2, 1))  # [nc, tdim(i), gdim]
    else:
        G = np.einsum("cik,cjk->cij", E, E)
        detG, invG = _batched_det_inv(G)
        vol = np.sqrt(np.abs(detG)) / math.factorial(tdim)
        Gi = np.einsum("cij,cjk->cik", invG, E)
    g0 = -Gi.sum(axis=1, keepdims=True)
    grads = np.concatenate([g0, Gi], axis=1)  # [nc, tdim+1, gdim]
    geom = CellGeometry(edges=E, volume=vol, grads=grads, inv_edges=Gi)
    if cells is None:
        mesh._cell_geometry = geom
    return geom


# ---------------------------------------------------------------------------
# Matrix assembly


def _broadcast_cell_tensor(M_cells, nc: int, g: int) -> np.ndarray:
    """Conductivity spec -> per-cell [nc, g, g] tensor (scalar/constant
    specs stay a stride-0 broadcast)."""
    Mc = np.asarray(M_cells, dtype=np.float64)
    if Mc.ndim == 0:
        Mc = np.broadcast_to(np.eye(g) * Mc, (nc, g, g))
    elif Mc.ndim == 2:
        Mc = np.broadcast_to(Mc, (nc, g, g))
    return Mc


def _p1_mass_base(d: int) -> np.ndarray:
    """Closed-form P1 simplex mass matrix / volume:
    ``(1 + delta_ij) / ((d+1)(d+2))``."""
    return (np.ones((d + 1, d + 1)) + np.eye(d + 1)) / ((d + 1) * (d + 2))


def _is_p1(V: FunctionSpace) -> bool:
    return V.element.family == "P" and V.element.degree == 1 and V.block_size == 1


def _check_pde_space(V: FunctionSpace) -> None:
    """The JAX package's guards on PDE assembly."""
    if V.element.family == "Quadrature":
        raise NotImplementedError("PDE assembly on Quadrature spaces")
    if V.block_size != 1:
        raise NotImplementedError(
            "PDE assembly on blocked (vector) spaces — the monodomain "
            "voltage is scalar; vector spaces carry data fields (fibers)"
        )


def _operator_cache_path(kind: str, cache_key: str, V: FunctionSpace, M_cells, dtype) -> Path:
    """The disk-cache slot of an assembled ``(mass, stiffness)`` pair
    (``fem.py:1118-1144`` there): keyed by ``kind`` and the caller's key,
    and by content, the space, the dtype, the mesh's coordinates and cells
    and the conductivity's bytes."""
    el = V.element
    parts = (kind, cache_key, V.ndofs, V.mesh.num_cells, f"{el.family}{el.degree}", V.block_size,
             np.dtype(dtype or np.float64).name)
    return cache.fingerprint("operators", parts, (V.mesh.coords, V.mesh.cells,
                                                  np.asarray(M_cells, dtype=np.float64)))


def _operator_cache_load(path, dtype):
    """The pair a slot holds (stencil or ELL, as it was stored), or None."""
    f = cache.load_arrays(path)
    if f is None:
        return None
    try:
        n = int(f["n"])
        if "offsets" in f:
            offs = tuple(int(d) for d in f["offsets"])
            return tuple(stencil_from_numpy(offs, f[k], dtype=_torch_dtype(dtype)) for k in ("mvals", "kvals"))
        tail = "tail_rows" in f
        return tuple(
            ELLMatrix(cols=f["cols"], vals=f[k], shape=(n, n),
                      tail_rows=f["tail_rows"] if tail else None, tail_cols=f["tail_cols"] if tail else None,
                      tail_vals=f[f"{k}_tail"] if tail else None)
            for k in ("mvals", "kvals")
        )
    except (KeyError, ValueError):
        return None


def _operator_cache_store(path, mass, stiff) -> None:
    """Publish a stencil or ELL pair to its slot (:func:`cache.store_arrays`)."""
    if isinstance(mass, ELLMatrix):
        arrays = dict(n=mass.shape[0], cols=mass.cols, mvals=mass.vals, kvals=stiff.vals)
        if mass.has_tail:
            arrays.update(tail_rows=mass.tail_rows, tail_cols=mass.tail_cols, mvals_tail=mass.tail_vals,
                          kvals_tail=stiff.tail_vals)
    else:
        arrays = dict(n=mass.shape[0], offsets=np.asarray(mass.offsets, dtype=np.int64),
                      mvals=mass.vals.numpy(), kvals=stiff.vals.numpy())
    cache.store_arrays(path, arrays)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype or np.float64)).dtype


def assemble_mass_stiffness_stencil(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
    max_offsets: int = 64,
    *,
    dtype=None,
    cache_key: str | None = None,
):
    """Direct stencil-form assembly of the consistent mass and anisotropic
    stiffness for a P1 space whose operator has a small global column-offset
    set (lexicographically ordered structured meshes).  Returns ``(mass,
    stiff)`` as CPU :class:`~.ops.sparse.StencilMatrix` with values of the
    numpy ``dtype`` (float64 when None), or ``None`` for any other space or
    when the offset set exceeds ``max_offsets``.  ``cache_key`` opts into
    the operator disk cache (``max_offsets`` keys the slot too, so a warm
    slot never hands back a wider stencil than the bound allows).

    Each of the 16 element-matrix (i, j) slots scatters straight into the
    ``[n, K]`` stencil table with ``np.bincount``: no COO sort and no
    ``[nc, 4, 4]`` element tensor (the numpy branch of the JAX package's
    ``fem.py:1042-1066``)."""
    if not _is_p1(V):
        return None
    slot = None
    if cache_key is not None:
        slot = _operator_cache_path("stencil", f"{cache_key}|mo{max_offsets}", V, M_cells, dtype)
        cached = _operator_cache_load(slot, dtype)
        if cached is not None:
            return cached
    mesh = V.mesh
    nd = V.ndofs_per_cell
    n = V.ndofs
    d, g = mesh.tdim, mesh.gdim
    Mc = _broadcast_cell_tensor(M_cells, mesh.num_cells, g)
    base = _p1_mass_base(d)
    geom = cell_geometry(mesh)
    vol = geom.volume
    cd = V.cell_dofs.astype(np.int64)

    # global offset set from per-pair unique diffs; the size check runs
    # before any Python-set materialization so unstructured meshes decline
    # after one vectorized unique
    offsets: set[int] = set()
    for i in range(nd):
        for j in range(nd):
            u = np.unique(cd[:, j] - cd[:, i])
            if u.size > max_offsets:
                return None
            offsets.update(int(v) for v in u)
            if len(offsets) > max_offsets:
                return None
    offs = np.array(sorted(offsets), dtype=np.int64)
    K = offs.size

    mst = np.zeros(n * K)
    kst = np.zeros(n * K)
    for j in range(nd):
        # M . grad(phi_j), one [nc, g] vector at a time
        MGj = np.einsum("cgh,ch->cg", Mc, geom.grads[:, j, :])
        for i in range(nd):
            dij = cd[:, j] - cd[:, i]
            kk = np.searchsorted(offs, dij)
            lin = cd[:, i] * K + kk
            mst += np.bincount(lin, weights=vol * base[i, j], minlength=n * K)
            ke_ij = vol * np.einsum("cg,cg->c", geom.grads[:, i, :], MGj)
            kst += np.bincount(lin, weights=ke_ij, minlength=n * K)

    offsets_t = tuple(int(v) for v in offs)
    mass = stencil_from_numpy(offsets_t, mst.reshape(n, K), dtype=_torch_dtype(dtype))
    stiff = stencil_from_numpy(offsets_t, kst.reshape(n, K), dtype=_torch_dtype(dtype))
    if slot is not None:
        _operator_cache_store(slot, mass, stiff)
    return mass, stiff


def _reference_tensors(element: Element, d: int) -> tuple[np.ndarray, np.ndarray]:
    """``(M_hat [nd, nd], S_hat [d, d, nd, nd])``: the element's mass and
    reference-gradient products integrated over the reference simplex
    (times d!, so a cell's matrices are ``|K| M_hat`` and ``|K| sum_ts
    A_ts S_hat_ts``), by the rule the JAX package's exact quadrature uses."""
    pts, wts = simplex_rule(d, max(2 * element.degree, 2))
    N = element.tabulate(d, pts)  # [nq, nd]
    dN = element.tabulate_grad(d, pts)  # [nq, nd, d]
    w = wts * math.factorial(d)
    return np.einsum("q,qi,qj->ij", w, N, N), np.einsum("q,qit,qjs->tsij", w, dN, dN)


def _element_matrices(V: FunctionSpace, M_cells) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell mass and stiffness ``[nc, ndpc, ndpc]``: P1's closed form,
    the reference tensors for any other space."""
    mesh = V.mesh
    geom = cell_geometry(mesh)
    nc, d, g = mesh.num_cells, mesh.tdim, mesh.gdim
    Mc = _broadcast_cell_tensor(M_cells, nc, g)
    if _is_p1(V):
        Me = geom.volume[:, None, None] * _p1_mass_base(d)[None]
        # stiffness: vol * G_i . M . G_j
        MG = np.einsum("cgh,cjh->cjg", Mc, geom.grads)
        Ke = geom.volume[:, None, None] * np.einsum("cig,cjg->cij", geom.grads, MG)
        return Me, Ke
    M_hat, S_hat = _reference_tensors(V.element, d)
    G = geom.inv_edges  # [nc, d, g]: grad_x xi_t
    GM = np.einsum("ctg,cgh->cth", G, Mc)
    A = geom.volume[:, None, None] * np.einsum("cth,csh->cts", GM, G)
    nd = M_hat.shape[0]
    Me = geom.volume[:, None, None] * M_hat[None]
    Ke = (A.reshape(nc, d * d) @ S_hat.reshape(d * d, nd * nd)).reshape(nc, nd, nd)
    return Me, Ke


def assemble_mass_stiffness_coo(V: FunctionSpace, M_cells: np.ndarray | float):
    """Raw COO triplets ``(rows, cols, mass_vals, stiff_vals, shape)`` of the
    consistent mass and anisotropic stiffness (duplicates unsummed, shared
    pattern, cell-major order), on any Lagrange space; Quadrature and
    blocked spaces raise, as in the JAX package."""
    _check_pde_space(V)
    Me, Ke = _element_matrices(V, M_cells)
    nd = V.ndofs_per_cell
    rows = np.repeat(V.cell_dofs, nd, axis=1).ravel()
    cols = np.tile(V.cell_dofs, (1, nd)).ravel()
    return rows, cols, Me.reshape(-1), Ke.reshape(-1), (V.ndofs, V.ndofs)


def _cell_blocks_to_csr(row_dofs: np.ndarray, col_dofs: np.ndarray, blocks, shape: tuple[int, int]):
    """CSR of ``sum_c`` of local blocks: entry ``(row_dofs[c, a],
    col_dofs[c, b])`` gets ``block[c, a, b]`` for each value set in
    ``blocks`` (all of one pattern).  Returns ``(indptr [n_rows + 1] int64,
    cols [nnz] int32, [vals [nnz] float64, ...])``, columns ascending within
    each row, duplicates summed in cell-major ``(c, a, b)`` order (the
    order of the JAX package's stable-sorted COO pipeline), zeros kept.

    No global sort of the triplets: the ``(c, a)`` pairs are grouped by
    row through the inverse of ``row_dofs`` (a sort of ``nc * na``
    entries), each row's columns are sorted on their own (scipy's
    per-row sort), and each triplet's CSR slot is found from the
    sorted order once for every value set."""
    import scipy.sparse as sp

    n_rows, n_cols = shape
    nc, na = row_dofs.shape
    nb = col_dofs.shape[1]
    flat = row_dofs.ravel()
    order = np.argsort(flat, kind="stable")  # (c, a) pairs grouped by row, cells ascending
    row_counts = np.bincount(flat, minlength=n_rows).astype(np.int64) * nb
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_counts, out=indptr[1:])
    c = order // na
    trip = (order[:, None] * nb + np.arange(nb)[None, :]).ravel()  # index into [c, a, b]
    cols = col_dofs[c].ravel()
    A = sp.csr_matrix((trip.astype(np.float64), cols, indptr), shape=shape)
    A.has_sorted_indices = False
    A.sort_indices()
    sorted_cols = A.indices
    first = np.empty(sorted_cols.size, dtype=bool)  # a new (row, col) pair starts here
    first[1:] = sorted_cols[1:] != sorted_cols[:-1]
    first[indptr[:-1][row_counts > 0]] = True
    n_first = np.zeros(first.size + 1, dtype=np.int64)
    np.cumsum(first, out=n_first[1:])
    slot_of = np.empty(trip.size, dtype=np.int64)
    slot_of[A.data.astype(np.int64)] = n_first[1:] - 1
    vals = [np.bincount(slot_of, weights=np.asarray(b, dtype=np.float64).ravel(), minlength=int(n_first[-1]))
            for b in blocks]
    return n_first[indptr], sorted_cols[first].astype(np.int32), vals


def _csr_to_ell_group(indptr, cols, vals_list, shape, dtype=None) -> tuple[ELLMatrix, ...]:
    """ELL matrices of one layout from a shared CSR pattern (the layout
    ``coo_to_ell_group`` gives: a row's entries in column order, then
    padding at the row's own column with value 0; rare long rows spill
    into the COO tail)."""
    n_rows = shape[0]
    counts = np.diff(indptr)
    width = int(counts.max()) if counts.size else 1
    urows = np.repeat(np.arange(n_rows), counts)
    pos = np.arange(cols.size) - indptr[urows]
    ell_cols = np.tile(np.arange(n_rows, dtype=np.int32)[:, None], (1, width))
    ell_cols[urows, pos] = cols
    out = []
    for vals in vals_list:
        ell_vals = np.zeros((n_rows, width))
        ell_vals[urows, pos] = vals
        out.append(_build_ell(ell_cols, ell_vals, counts, shape, dtype))
    return tuple(out)


def assemble_mass_stiffness(V: FunctionSpace, M_cells: np.ndarray | float, *, dtype=None,
                            cache_key: str | None = None):
    """Consistent mass and anisotropic stiffness as two host
    :class:`~.ops.sparse.ELLMatrix` of one shared layout, so
    ``a*Mass + b*Stiff`` is a value-level combination, with values of the
    numpy ``dtype`` (float64 when None).  ``M_cells``: scalar,
    [gdim, gdim] or per-cell [nc, gdim, gdim].  P1 goes through the COO
    pipeline (one sort of the shared pattern for both value sets); any
    other Lagrange space through its reference tensors and
    :func:`_cell_blocks_to_csr`.  Quadrature and blocked spaces raise.
    ``cache_key`` opts into the operator disk cache."""
    _check_pde_space(V)
    slot = None
    if cache_key is not None:
        slot = _operator_cache_path("ell", cache_key, V, M_cells, dtype)
        cached = _operator_cache_load(slot, dtype)
        if cached is not None:
            return cached
    if _is_p1(V):
        rows, cols, mvals, kvals, shape = assemble_mass_stiffness_coo(V, M_cells)
        pair = coo_to_ell_group(rows, cols, [mvals, kvals], shape, dtype)
    else:
        Me, Ke = _element_matrices(V, M_cells)
        shape = (V.ndofs, V.ndofs)
        indptr, cols, vals = _cell_blocks_to_csr(V.cell_dofs, V.cell_dofs, [Me, Ke], shape)
        pair = _csr_to_ell_group(indptr, cols, vals, shape, dtype)
    if slot is not None:
        _operator_cache_store(slot, *pair)
    return pair


def assemble_mass_stiffness_auto(V: FunctionSpace, M_cells: np.ndarray | float, *, dtype=None,
                                 cache_key: str | None = None):
    """Stencil-first operator assembly: the direct stencil where the mesh
    structure allows (P1), ELL otherwise, upgraded to stencil form when
    the ELL pattern turns out to be a global stencil (the JAX
    ``BaseModel``'s route).  Returns two :class:`~.ops.sparse.StencilMatrix`
    (CPU) or two host :class:`~.ops.sparse.ELLMatrix`, with values of the
    numpy ``dtype`` (float64 when None).  ``cache_key`` opts both
    assemblies into the operator disk cache (``fem.py:941-967`` there)."""
    pair = assemble_mass_stiffness_stencil(V, M_cells, dtype=dtype, cache_key=cache_key)
    if pair is not None:
        return pair
    mass, stiff = assemble_mass_stiffness(V, M_cells, dtype=dtype, cache_key=cache_key)
    mst = ell_to_stencil(mass)
    if mst is not None:
        kst = ell_to_stencil(stiff)
        if kst is not None and kst.offsets == mst.offsets:
            return tuple(A.with_values(A.vals.to(_torch_dtype(dtype))) for A in (mst, kst))
    return mass, stiff


# ---------------------------------------------------------------------------
# Quadrature data for load vectors


@dataclass
class CellQuadData:
    """Quadrature tables for a (sub)domain integral (host numpy).

    X: [ne, nq, gdim] physical quad points; W: [ne, nq] physical weights
    (already include |detJ|); N: [nq, nd] basis at quad points;
    dofs: [ne, nd] global dofs."""

    X: np.ndarray
    W: np.ndarray
    N: np.ndarray
    dofs: np.ndarray
    ndofs: int
    _device_tables: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def device_tables(self, device=None, dtype: torch.dtype | None = None) -> "_QuadTables":
        """The tables on ``device`` (the card when None) in ``dtype`` (the
        device's working dtype when None), made once and kept."""
        from .config import default_dtype, resolve_device

        dev = resolve_device(device)
        dtype = dtype or default_dtype(dev)
        key = (str(dev), dtype)
        if key not in self._device_tables:
            self._device_tables[key] = _QuadTables.build(self, dev, dtype)
        return self._device_tables[key]

    def assemble_load(self, fn, t, device=None, dtype: torch.dtype | None = None, spmv=None) -> torch.Tensor:
        """b_i = sum_q W_q phi_i(x_q) fn(x_q, t) on ``device`` (the card
        when None): ``fn`` takes the quadrature points as a ``[gdim, ne,
        nq]`` tensor and ``t`` as a 0-d tensor.  The cell-to-dof sum is one
        CSR product, in element order within each dof: ``spmv``, by
        default B8's wrapper (the kernel on the card, its twin on the
        CPU; a solver on the twins passes ``csr_spmv_twin``)."""
        tab = self.device_tables(device, dtype)
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(float(t), dtype=tab.W.dtype, device=tab.W.device)
        vals = torch.as_tensor(fn(tab.X, t), device=tab.W.device).to(tab.W.dtype)
        vals = torch.broadcast_to(vals, tab.W.shape) * tab.W
        cellvals = vals @ tab.N  # [ne, nd]
        return (spmv or tab.csr_spmv)(tab.scatter, cellvals.reshape(-1))

    def assemble_load_host(self, fn=None, t=0.0) -> np.ndarray:
        """b_i = sum_q W_q phi_i(x_q) fn(x_q, t); ``fn=None`` means the unit
        function (the separable TimeWindow load)."""
        x = np.moveaxis(self.X, -1, 0)
        vals = (np.ones(self.X.shape[:2]) if fn is None else np.asarray(fn(x, t))) * self.W
        cellvals = np.einsum("eq,qd->ed", vals, self.N)
        b = np.zeros(self.ndofs, dtype=vals.dtype)
        np.add.at(b, self.dofs.ravel(), cellvals.ravel())
        return b

    def interpolate(self, u: np.ndarray) -> np.ndarray:
        """Values of the FE function u at quad points: [ne, nq]."""
        return np.einsum("ed,qd->eq", np.asarray(u)[self.dofs], self.N)

    def integrate(self, integrand, u: np.ndarray | None = None, t=None) -> float:
        """∫ integrand(x[, u_q][, t]) over the subdomain (numpy callable;
        x is [gdim, ne, nq])."""
        args = [np.moveaxis(self.X, -1, 0)]
        if u is not None:
            args.append(self.interpolate(u))
        if t is not None:
            args.append(t)
        return float(np.sum(self.W * integrand(*args)))


@dataclass
class _QuadTables:
    """A :class:`CellQuadData` on one device: ``X`` [gdim, ne, nq], ``W``
    [ne, nq], ``N`` [nq, nd] and ``scatter``, the [ndofs, ne * nd] 0/1 CSR
    map from cell values to dofs (columns ascending, so each dof sums its
    cells in element order), with ``csr_spmv`` the product to apply it."""

    X: torch.Tensor
    W: torch.Tensor
    N: torch.Tensor
    scatter: object  # ops.cuda_ell.CSRMatrix
    csr_spmv: object

    @classmethod
    def build(cls, quad: CellQuadData, device: torch.device, dtype: torch.dtype) -> "_QuadTables":
        from .ops.cuda_ell import CSRMatrix, csr_spmv

        flat = np.asarray(quad.dofs, dtype=np.int64).ravel()
        order = np.argsort(flat, kind="stable")
        indptr = np.zeros(quad.ndofs + 1, dtype=np.int64)
        np.cumsum(np.bincount(flat, minlength=quad.ndofs), out=indptr[1:])
        scatter = CSRMatrix(
            indptr=torch.from_numpy(indptr.astype(np.int32)),
            cols=torch.from_numpy(order.astype(np.int32)),
            vals=torch.ones(flat.size, dtype=torch.float64),
            shape=(int(quad.ndofs), int(flat.size)),
        ).to(device, dtype)

        def on_dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

        return cls(X=on_dev(np.moveaxis(quad.X, -1, 0)), W=on_dev(quad.W), N=on_dev(quad.N),
                   scatter=scatter, csr_spmv=csr_spmv)


def cell_quadrature(
    V: FunctionSpace, cells: np.ndarray | None = None, degree: int = 4, dtype=np.float64
) -> CellQuadData:
    """Quadrature tables over (a subset of) cells for the space ``V``."""
    mesh = V.mesh
    if cells is None:
        cells = np.arange(mesh.num_cells)
        geom = cell_geometry(mesh)
    else:
        cells = np.asarray(cells, dtype=np.int64)
        geom = cell_geometry(mesh, cells)
    pts, wts = simplex_rule(mesh.tdim, degree)
    N = V.element.tabulate(mesh.tdim, pts)  # [nq, nd]
    x0 = mesh.coords[mesh.cells[cells, 0]]
    X = x0[:, None, :] + np.einsum("qd,cdg->cqg", pts, geom.edges)
    W = (geom.volume * math.factorial(mesh.tdim))[:, None] * wts[None, :]
    return CellQuadData(
        X=np.asarray(X, dtype=dtype),
        W=np.asarray(W, dtype=dtype),
        N=np.asarray(N, dtype=dtype),
        dofs=np.asarray(V.cell_dofs[cells], dtype=np.int32),
        ndofs=V.ndofs,
    )


def _facet_dofs(V: FunctionSpace, fverts: np.ndarray) -> np.ndarray:
    """Global dofs [nf, ndofs_per_facet] of a continuous Lagrange space on
    the given facets, ordered to pair with the facet element's basis
    (vertices, per-facet-edge interior, facet interior)."""
    p = V.element.degree
    mesh = V.mesh
    fdim = fverts.shape[1] - 1
    fverts64 = fverts.astype(np.int64)
    columns = [fverts64[:, i] for i in range(fdim + 1)]
    if p >= 2 and fdim >= 1:
        columns += _edge_slot_columns(mesh, fverts64, p, _edge_combos(fdim))
    if p >= 3 and fdim == 2:
        face_offset = mesh.num_vertices + mesh.entities(1).shape[0] * (p - 1)
        columns += _face_slot_columns(mesh, fverts64, p, face_offset)
    return np.stack(columns, axis=1)


def facet_quadrature(
    V: FunctionSpace, facets: np.ndarray, degree: int = 4, dtype=None
) -> CellQuadData:
    """Quadrature tables over boundary facets (for ``ds`` stimuli) of a
    continuous Lagrange space of any degree."""
    if V.element.family != "P":
        raise NotImplementedError("facet integrals implemented for Lagrange spaces")
    dtype = dtype or np.float64
    mesh = V.mesh
    p = V.element.degree
    fdim = mesh.tdim - 1
    fverts = mesh.entities(fdim)[np.asarray(facets, dtype=np.int64)]  # [nf, fdim+1]
    F = mesh.coords[fverts]  # [nf, fdim+1, gdim]
    E = F[:, 1:, :] - F[:, :1, :]
    if fdim == 0:
        area = np.ones(F.shape[0])
        wts = np.ones(1)
        N = np.ones((1, 1))
        X = F[:, :1, :]
        dofs = fverts
    else:
        G = np.einsum("cik,cjk->cij", E, E)
        area = np.sqrt(np.abs(np.linalg.det(G))) / math.factorial(fdim)
        pts, wts = simplex_rule(fdim, degree)
        N = Element("P", p).tabulate(fdim, pts)
        X = F[:, :1, :] + np.einsum("qd,cdg->cqg", pts, E)
        dofs = _facet_dofs(V, fverts) if p >= 2 else fverts
    scale = math.factorial(fdim) if fdim > 0 else 1.0
    W = (area * scale)[:, None] * wts[None, :]
    return CellQuadData(
        X=np.asarray(X, dtype=dtype),
        W=np.asarray(W, dtype=dtype),
        N=np.asarray(N, dtype=dtype),
        dofs=np.asarray(dofs, dtype=np.int32),
        ndofs=V.ndofs,
    )


# ---------------------------------------------------------------------------
# Scalar forms


@dataclass
class ScalarForm:
    """Lazily assembled scalar integral (mirrors ``dolfinx.fem.form`` +
    ``assemble_scalar``).  Re-reads its coefficient Function at assembly
    time, so a form built once stays valid as solutions update."""

    quad: CellQuadData
    integrand: object  # numpy callable (x[, u_q][, t]) -> values
    coefficient: Function | None = None
    time: Constant | None = None

    def assemble(self) -> float:
        u = None if self.coefficient is None else self.coefficient.x.array
        t = None if self.time is None else float(self.time)
        return self.quad.integrate(self.integrand, u=u, t=t)


def assemble_scalar(form: ScalarForm) -> float:
    return form.assemble()


def integral(mesh_or_space, integrand, degree: int = 4) -> ScalarForm:
    """Form for ∫ integrand(x) dx over the whole domain."""
    V = mesh_or_space
    if isinstance(V, Mesh):
        V = functionspace(V, ("P", 1))
    return ScalarForm(quad=cell_quadrature(V, degree=degree), integrand=integrand)


def function_integral(u: Function, integrand, degree: int = 4, time: Constant | None = None) -> ScalarForm:
    """Form for ∫ integrand(x, u(x)[, t]) dx: error norms and the ECG
    electrode integral."""
    return ScalarForm(
        quad=cell_quadrature(u.function_space, degree=degree),
        integrand=integrand,
        coefficient=u,
        time=time,
    )


# ---------------------------------------------------------------------------
# Dirichlet BCs and dof location


def locate_dofs_topological(V: FunctionSpace, dim: int, entities: np.ndarray) -> np.ndarray:
    """Dofs of a continuous Lagrange space attached to the given mesh
    entities (vertices, edges or facets); other spaces raise, as in the
    JAX package."""
    mesh = V.mesh
    ents = mesh.entities(dim)[np.asarray(entities, dtype=np.int64)]
    if V.element.family == "P" and V.element.degree == 1:
        return np.unique(ents.ravel()).astype(np.int32)
    if V.element.family == "P" and V.element.degree == 2:
        vert_dofs = np.unique(ents.ravel())
        if dim == 0:
            return vert_dofs.astype(np.int32)
        # the edge dofs on those entities
        edges = mesh.entities(1)
        order = np.lexsort(edges.T[::-1])
        sorted_edges = edges[order]
        edge_sets = []
        for i, j in itertools.combinations(range(ents.shape[1]), 2):
            local = np.sort(ents[:, [i, j]], axis=1)
            idx = _row_searchsorted(sorted_edges, local)
            found = (sorted_edges[idx] == local).all(axis=1)  # only actual mesh edges
            edge_sets.append(order[idx[found]])
        edge_dofs = mesh.num_vertices + np.unique(np.concatenate(edge_sets))
        return np.concatenate([vert_dofs, edge_dofs]).astype(np.int32)
    if V.element.family == "P":
        if dim == 0:
            return np.unique(ents.ravel()).astype(np.int32)
        if dim in (1, mesh.tdim - 1):
            # facets carry vertex + edge + facet-interior dofs
            return np.unique(_facet_dofs(V, ents).ravel()).astype(np.int32)
    raise NotImplementedError


@dataclass
class DirichletBC:
    value: float
    dofs: np.ndarray


def dirichletbc(value: float, dofs: np.ndarray, V: FunctionSpace | None = None) -> DirichletBC:
    return DirichletBC(value=float(value), dofs=np.asarray(dofs, dtype=np.int32))


# ---------------------------------------------------------------------------
# Point evaluation & transfer


def _locate_cells(mesh: Mesh, points: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """Lowest-index cell containing each point (vectorized barycentric
    test, one point at a time, over the cells whose bounding box holds
    it); -1 when outside.  Barycentric coordinates all >= -tol put a point
    at most (tdim + 1) * tol of the cell's extent outside its box on each
    axis, so boxes padded by more than that drop no cell the test accepts,
    and only the cells left need their geometry (the JAX package's native
    sweep prefilters the same way, and so only where tdim == gdim: an
    embedded cell's test reads the point's projection onto it)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[None, :]
    pts = pts[:, : mesh.gdim]
    boxed = mesh.tdim == mesh.gdim
    boxes = []  # per axis: the cells' padded (lo, hi)
    for a in range(mesh.gdim if boxed else 0):
        c = [mesh.coords[mesh.cells[:, k], a] for k in range(mesh.cells.shape[1])]
        lo, hi = functools.reduce(np.minimum, c), functools.reduce(np.maximum, c)
        pad = (hi - lo) * max(4 * (mesh.tdim + 1) * tol, 1e-8)
        boxes.append((lo - pad, hi + pad))
    out = np.full(pts.shape[0], -1, dtype=np.int64)
    for pi, p in enumerate(pts):
        cand = np.arange(mesh.num_cells)
        for (lo, hi), x in zip(boxes, p):
            cand = cand[(lo[cand] <= x) & (hi[cand] >= x)]
        if not cand.size:
            continue
        geom = cell_geometry(mesh, cand)
        d = p[None, :] - mesh.coords[mesh.cells[cand, 0]]  # [nk, gdim]
        xi = np.einsum("cg,cig->ci", d, geom.inv_edges)  # [nk, tdim]
        lam0 = 1.0 - xi.sum(axis=1)
        ok = (xi >= -tol).all(axis=1) & (lam0 >= -tol)
        hits = np.nonzero(ok)[0]
        if hits.size:
            out[pi] = cand[hits[0]]
    return out


def _reference_coords(mesh: Mesh, points: np.ndarray, tol: float) -> tuple[np.ndarray, np.ndarray]:
    """``(cells, xi)``: the cell holding each physical point and the
    point's reference coordinates in it; raises for points outside."""
    cells = _locate_cells(mesh, points, tol=tol)
    if (cells < 0).any():
        raise ValueError(f"Points outside mesh: {points[cells < 0]}")
    sub = cell_geometry(mesh, cells)
    x0 = mesh.coords[mesh.cells[cells, 0]]
    return cells, np.einsum("pg,pig->pi", points[:, : mesh.gdim] - x0, sub.inv_edges)


def evaluate_function(u: Function, points: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """``u`` at physical points, on the host: ``[np]``, or ``[np, bs]`` on
    a blocked space (one point given as ``[gdim]`` gives a scalar or
    ``[bs]``).  Quadrature spaces raise, as in the JAX package."""
    V = u.function_space
    pts = np.asarray(points, dtype=np.float64)
    squeeze = pts.ndim == 1
    if squeeze:
        pts = pts[None, :]
    cells, xi = _reference_coords(V.mesh, pts, tol)
    if V.element.family == "Quadrature":
        raise NotImplementedError("evaluate_function on quadrature spaces")
    N = V.element.tabulate(V.mesh.tdim, xi)  # row i: point i's own reference coordinates
    bs = V.block_size
    if bs == 1:
        vals = (u.x.array[V.cell_dofs[cells]] * N).sum(axis=1)
    else:
        comp = u.x.array.reshape(-1, bs)
        vals = np.einsum("pic,pi->pc", comp[V.scalar_space.cell_dofs[cells]], N)
    return vals[0] if squeeze else vals


def point_evaluation_tables(
    V: FunctionSpace, points: np.ndarray, tol: float = 1e-8
) -> tuple[np.ndarray, np.ndarray]:
    """(dofs [np, ndpc], weights [np, ndpc]) such that
    ``u(points) = (u_dofs[dofs] * weights).sum(axis=1)``."""
    cells, xi = _reference_coords(V.mesh, np.asarray(points, dtype=np.float64), tol)
    return V.cell_dofs[cells], V.element.tabulate(V.mesh.tdim, xi)


def _transfer_entry(Vs: FunctionSpace, Vt: FunctionSpace):
    """The cache slot of the ``Vs -> Vt`` transfer, on the source space:
    ``[Vt, host matrix or None, {(device, dtype): device matrix}]`` (the
    entry holds the target, so its id cannot be reused while it lives)."""
    cache = vars(Vs).setdefault("_transfer_cache", {})
    return cache.setdefault(id(Vt), [Vt, None, {}])


def build_transfer_matrix(Vs: FunctionSpace, Vt: FunctionSpace):
    """Interpolation matrix T, ``target_dofs = T @ source_dofs``, as a host
    float64 :class:`~.ops.cuda_ell.CSRMatrix` of shape ``(Vt.ndofs,
    Vs.ndofs)`` (rectangular in general; cached on ``Vs`` per target).

    For pointwise elements a target dof's value is the source evaluated at
    the target's dof point in the dof's owner cell (the last cell holding
    it), or at each quadrature point of a Quadrature target; for a
    Quadrature source, the mass-lumped L2 projection ``u_i = sum_{c,q} w
    phi_i v_q / sum w phi_i``.  Entries that are exactly zero are dropped."""
    from .ops.cuda_ell import CSRMatrix

    entry = _transfer_entry(Vs, Vt)
    if entry[1] is not None:
        return entry[1]
    mesh = Vs.mesh
    nt, ns = Vt.ndofs, Vs.ndofs
    if Vs.element.family == "Quadrature":
        pts, wts = simplex_rule(mesh.tdim, Vs.element.degree)
        geom = cell_geometry(mesh)
        W = (geom.volume * math.factorial(mesh.tdim))[:, None] * wts[None, :]  # [nc, nq]
        Nt = Vt.element.tabulate(mesh.tdim, pts)  # [nq, ndt]
        wphi = np.einsum("cq,qd->cdq", W, Nt)  # entry (dof d of cell c, point q)
        indptr, cols, (vals,) = _cell_blocks_to_csr(Vt.cell_dofs, Vs.cell_dofs, [wphi], (nt, ns))
        den = np.zeros(nt)
        np.add.at(den, Vt.cell_dofs.ravel(), wphi.sum(axis=2).ravel())
        den[den == 0] = 1.0
        vals = vals / np.repeat(den, np.diff(indptr))
    else:
        # one row per target point: the source basis there, in the point's cell
        if Vt.element.family == "Quadrature":
            pts, _ = simplex_rule(mesh.tdim, Vt.element.degree)
            owner = np.repeat(np.arange(mesh.num_cells), pts.shape[0])
            ref = np.tile(pts, (mesh.num_cells, 1))
            tgt = Vt.cell_dofs.ravel()
        else:
            owner = Vt.dof_owner_cell
            geom = cell_geometry(mesh)
            x0 = mesh.coords[mesh.cells[owner, 0]]
            ref = np.einsum("pg,pig->pi", Vt.dof_coords - x0, geom.inv_edges[owner])
            tgt = np.arange(nt)
        Ns = Vs.element.tabulate(mesh.tdim, ref)  # [npts, nds]
        src = Vs.cell_dofs[owner]
        by_col = np.argsort(src, axis=1, kind="stable")
        rows_cols = np.empty((nt, src.shape[1]), dtype=np.int64)
        rows_vals = np.zeros((nt, src.shape[1]))
        rows_cols[tgt] = np.take_along_axis(src, by_col, axis=1)
        rows_vals[tgt] = np.take_along_axis(Ns, by_col, axis=1)
        indptr = np.arange(nt + 1, dtype=np.int64) * src.shape[1]
        cols, vals = rows_cols.ravel(), rows_vals.ravel()
    live = vals != 0.0
    counts = np.bincount(np.repeat(np.arange(nt), np.diff(indptr))[live], minlength=nt)
    indptr = np.zeros(nt + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    T = CSRMatrix(
        indptr=torch.from_numpy(indptr.astype(np.int32)),
        cols=torch.from_numpy(cols[live].astype(np.int32)),
        vals=torch.from_numpy(np.ascontiguousarray(vals[live], dtype=np.float64)),
        shape=(int(nt), int(ns)),
    )
    entry[1] = T
    return T


def transfer_operator(Vs: FunctionSpace, Vt: FunctionSpace, device: torch.device, dtype: torch.dtype):
    """:func:`build_transfer_matrix` on ``device`` in ``dtype``, made once
    per (source, target, device, dtype) and kept on the source space."""
    entry = _transfer_entry(Vs, Vt)
    key = (str(device), dtype)
    if key not in entry[2]:
        entry[2][key] = build_transfer_matrix(Vs, Vt).to(device, dtype)
    return entry[2][key]
