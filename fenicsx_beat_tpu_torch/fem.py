"""Finite-element layer, P1 subset: spaces, functions, cell geometry,
stencil and ELL assembly, cell and facet quadrature, scalar forms,
Dirichlet dofs and probe tables.

Host-side (numpy) port of the parts of ``fenicsx_beat_tpu/fem.py`` that the
fused monodomain solver, the object-oriented models, the transmural layer
labelling and ECG recovery run at setup time (and the lazily assembled
forms of ``ECGRecovery.eval``).  Every array here is built once on the
host; the solver moves the results to its device.  The one per-step
piece is :meth:`CellQuadData.assemble_load`, a general stimulus
expression's load vector on the solver's device: the expression at the
quadrature points, then the cell-to-dof sum as one CSR product (B8,
``ops/cuda_ell.csr_spmv``) through a map built once on the host, so the
sum has a fixed order and no float atomics.  Where the JAX package calls its native C++ kit,
the port takes the kit's numpy branch: the slot loop of
``assemble_mass_stiffness_stencil``, the COO pipeline of
``assemble_mass_stiffness`` (not the one-pass native ELL assembly, which
gives the same operator in another ELL layout) and the barycentric sweep
of ``_locate_cells``.  Higher-degree, discontinuous and blocked spaces and
the operator disk cache are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .convert import stencil_from_numpy
from .mesh import Mesh
from .ops.quadrature import simplex_rule
from .ops.sparse import coo_to_ell_group, ell_to_stencil

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
    "point_evaluation_tables",
]


# ---------------------------------------------------------------------------
# Elements


def _bary(pts: np.ndarray) -> np.ndarray:
    """Barycentric coords [np, tdim+1] of reference-simplex points [np, tdim]."""
    lam0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([lam0, pts], axis=1)


_FAMILY_ALIASES = {"P": "P", "CG": "P", "Lagrange": "P"}


@dataclass(frozen=True)
class Element:
    family: str  # "P"
    degree: int

    def __post_init__(self):
        if self.family != "P" or self.degree != 1:
            raise NotImplementedError(
                f"element ({self.family}, {self.degree}): the port supports P1 only"
            )

    def dof_ref_points(self, tdim: int) -> np.ndarray:
        """Interpolation points in the reference cell, one per local dof
        (P1: the vertices)."""
        return np.concatenate([np.zeros((1, tdim)), np.eye(tdim)], axis=0)

    def tabulate(self, tdim: int, pts: np.ndarray) -> np.ndarray:
        """Basis values [np, tdim+1] at reference points [np, tdim]."""
        return _bary(pts)


# ---------------------------------------------------------------------------
# Function space


@dataclass
class FunctionSpace:
    mesh: Mesh
    element: Element
    cell_dofs: np.ndarray  # [nc, tdim+1] int32
    ndofs: int

    @property
    def ndofs_per_cell(self) -> int:
        return self.cell_dofs.shape[1]

    @property
    def dof_coords(self) -> np.ndarray:
        """[ndofs, gdim] coordinates of the dofs (P1: the vertices)."""
        return self.mesh.coords

    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self.dof_coords


def functionspace(mesh: Mesh, element) -> FunctionSpace:
    """P1 function space; ``element`` is an Element or a ("P", 1) tuple."""
    if isinstance(element, tuple):
        if len(element) != 2:
            raise NotImplementedError("blocked (vector) spaces are not ported yet")
        family, degree = element
        if family not in _FAMILY_ALIASES:
            raise NotImplementedError(f"element family {family!r} is not ported yet")
        element = Element(_FAMILY_ALIASES[family], int(degree))
    return FunctionSpace(
        mesh=mesh,
        element=element,
        cell_dofs=np.ascontiguousarray(mesh.cells, dtype=np.int32),
        ndofs=mesh.num_vertices,
    )


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

    def interpolate(self, source) -> None:
        """Set the dofs from a callable of the [3, ndofs] dof coordinates
        (zero rows beyond gdim); interpolation between spaces is not
        ported yet."""
        if not callable(source):
            raise TypeError(f"Cannot interpolate from {type(source)}")
        V = self._V
        x = np.zeros((3, V.ndofs))
        x[: V.mesh.gdim, :] = V.dof_coords.T
        self.x.array[:] = np.broadcast_to(np.asarray(source(x)), (V.ndofs,))


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
    """Per-cell affine geometry (edges, volume, basis gradients) of a
    ``tdim == gdim`` simplex mesh.  The full-mesh result is cached on the
    mesh; with ``cells`` only that subset is computed (a small stimulus or
    probe region must not force the whole mesh's geometry)."""
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
    if tdim != gdim:
        raise NotImplementedError("embedded (tdim < gdim) meshes are not ported yet")
    cell_verts = mesh.cells if cells is None else mesh.cells[np.asarray(cells)]
    X = mesh.coords[cell_verts]  # [nc, tdim+1, gdim]
    E = X[:, 1:, :] - X[:, :1, :]  # [nc, tdim, gdim]
    detJ, invE = _batched_det_inv(E)
    vol = np.abs(detJ) / math.factorial(tdim)
    # xi = (x - x0) @ invE, so grad xi_i = invE[:, i]
    Gi = np.transpose(invE, (0, 2, 1))  # [nc, tdim(i), gdim]
    g0 = -Gi.sum(axis=1, keepdims=True)
    grads = np.concatenate([g0, Gi], axis=1)  # [nc, tdim+1, gdim]
    geom = CellGeometry(edges=E, volume=vol, grads=grads, inv_edges=Gi)
    if cells is None:
        mesh._cell_geometry = geom
    return geom


# ---------------------------------------------------------------------------
# Matrix assembly (P1, stencil form)


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


def assemble_mass_stiffness_stencil(
    V: FunctionSpace,
    M_cells: np.ndarray | float,
    max_offsets: int = 64,
):
    """Direct stencil-form assembly of the consistent mass and anisotropic
    stiffness for a P1 space whose operator has a small global column-offset
    set (lexicographically ordered structured meshes).  Returns ``(mass,
    stiff)`` as float64 CPU :class:`~.ops.sparse.StencilMatrix`, or
    ``None`` when the offset set exceeds ``max_offsets``.

    Each of the 16 element-matrix (i, j) slots scatters straight into the
    ``[n, K]`` stencil table with ``np.bincount``: no COO sort and no
    ``[nc, 4, 4]`` element tensor (the numpy branch of the JAX package's
    ``fem.py:1042-1066``)."""
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
    mass = stencil_from_numpy(offsets_t, mst.reshape(n, K))
    stiff = stencil_from_numpy(offsets_t, kst.reshape(n, K))
    return mass, stiff


def assemble_mass_stiffness_coo(V: FunctionSpace, M_cells: np.ndarray | float):
    """Raw COO triplets ``(rows, cols, mass_vals, stiff_vals, shape)`` of the
    consistent mass and anisotropic stiffness (duplicates unsummed, shared
    pattern): the P1 closed-form branch of the JAX package's
    ``assemble_mass_stiffness_coo``."""
    mesh = V.mesh
    geom = cell_geometry(mesh)
    nc, d, g = mesh.num_cells, mesh.tdim, mesh.gdim
    Mc = _broadcast_cell_tensor(M_cells, nc, g)
    Me = geom.volume[:, None, None] * _p1_mass_base(d)[None]
    # stiffness: vol * G_i . M . G_j
    MG = np.einsum("cgh,cjh->cjg", Mc, geom.grads)
    Ke = geom.volume[:, None, None] * np.einsum("cig,cjg->cij", geom.grads, MG)
    nd = V.ndofs_per_cell
    rows = np.repeat(V.cell_dofs, nd, axis=1).ravel()
    cols = np.tile(V.cell_dofs, (1, nd)).ravel()
    return rows, cols, Me.reshape(-1), Ke.reshape(-1), (V.ndofs, V.ndofs)


def assemble_mass_stiffness(V: FunctionSpace, M_cells: np.ndarray | float):
    """Consistent mass and anisotropic stiffness as two host
    :class:`~.ops.sparse.ELLMatrix` of one shared layout, so
    ``a*Mass + b*Stiff`` is a value-level combination.  ``M_cells``: scalar,
    [gdim, gdim] or per-cell [nc, gdim, gdim].  Goes through the COO
    pipeline (one sort of the shared pattern for both value sets)."""
    rows, cols, mvals, kvals, shape = assemble_mass_stiffness_coo(V, M_cells)
    mass, stiff = coo_to_ell_group(rows, cols, [mvals, kvals], shape)
    return mass, stiff


def assemble_mass_stiffness_auto(V: FunctionSpace, M_cells: np.ndarray | float):
    """Stencil-first operator assembly: the direct stencil where the mesh
    structure allows, generic ELL otherwise, upgraded to stencil form when
    the ELL pattern turns out to be a global stencil.  Returns two
    :class:`~.ops.sparse.StencilMatrix` (float64 CPU) or two host float64
    :class:`~.ops.sparse.ELLMatrix`."""
    pair = assemble_mass_stiffness_stencil(V, M_cells)
    if pair is not None:
        return pair
    mass, stiff = assemble_mass_stiffness(V, M_cells)
    mst = ell_to_stencil(mass)
    if mst is not None:
        kst = ell_to_stencil(stiff)
        if kst is not None and kst.offsets == mst.offsets:
            return mst, kst
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

    def assemble_load(self, fn, t, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
        """b_i = sum_q W_q phi_i(x_q) fn(x_q, t) on ``device`` (the card
        when None): ``fn`` takes the quadrature points as a ``[gdim, ne,
        nq]`` tensor and ``t`` as a 0-d tensor.  The cell-to-dof sum is one
        CSR product (B8 on the card, its twin on the CPU), in element
        order within each dof."""
        tab = self.device_tables(device, dtype)
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(float(t), dtype=tab.W.dtype, device=tab.W.device)
        vals = torch.as_tensor(fn(tab.X, t), device=tab.W.device).to(tab.W.dtype)
        vals = torch.broadcast_to(vals, tab.W.shape) * tab.W
        cellvals = vals @ tab.N  # [ne, nd]
        return tab.csr_spmv(tab.scatter, cellvals.reshape(-1))

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


def facet_quadrature(
    V: FunctionSpace, facets: np.ndarray, degree: int = 4, dtype=None
) -> CellQuadData:
    """Quadrature tables over boundary facets (for ``ds`` stimuli) of the P1
    space; the JAX package's ``facet_quadrature`` for degree 1."""
    dtype = dtype or np.float64
    mesh = V.mesh
    fdim = mesh.tdim - 1
    fverts = mesh.entities(fdim)[np.asarray(facets, dtype=np.int64)]  # [nf, fdim+1]
    F = mesh.coords[fverts]  # [nf, fdim+1, gdim]
    E = F[:, 1:, :] - F[:, :1, :]
    if fdim == 0:
        area = np.ones(F.shape[0])
        wts = np.ones(1)
        N = np.ones((1, 1))
        X = F[:, :1, :]
    else:
        G = np.einsum("cik,cjk->cij", E, E)
        area = np.sqrt(np.abs(np.linalg.det(G))) / math.factorial(fdim)
        pts, wts = simplex_rule(fdim, degree)
        N = Element("P", 1).tabulate(fdim, pts)
        X = F[:, :1, :] + np.einsum("qd,cdg->cqg", pts, E)
    scale = math.factorial(fdim) if fdim > 0 else 1.0
    W = (area * scale)[:, None] * wts[None, :]
    return CellQuadData(
        X=np.asarray(X, dtype=dtype),
        W=np.asarray(W, dtype=dtype),
        N=np.asarray(N, dtype=dtype),
        dofs=np.asarray(_facet_dofs(V, fverts), dtype=np.int32),
        ndofs=V.ndofs,
    )


def _facet_dofs(V: FunctionSpace, fverts: np.ndarray) -> np.ndarray:
    """Global dofs [nf, ndofs_per_facet] of the space on the given facets:
    for P1, the facet's vertices (higher degrees are not ported)."""
    if V.element.degree != 1:
        raise NotImplementedError("facet dofs of degree > 1 are not ported yet")
    return fverts


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
    """Dofs attached to the given mesh entities (P1: their vertices)."""
    if V.element.degree != 1:
        raise NotImplementedError("dof location on degree > 1 spaces is not ported yet")
    ents = V.mesh.entities(dim)[np.asarray(entities, dtype=np.int64)]
    return np.unique(ents.ravel()).astype(np.int32)


@dataclass
class DirichletBC:
    value: float
    dofs: np.ndarray


def dirichletbc(value: float, dofs: np.ndarray, V: FunctionSpace | None = None) -> DirichletBC:
    return DirichletBC(value=float(value), dofs=np.asarray(dofs, dtype=np.int32))


# ---------------------------------------------------------------------------
# Point evaluation


def _locate_cells(mesh: Mesh, points: np.ndarray, tol: float = 1e-10) -> np.ndarray:
    """Lowest-index cell containing each point (vectorized barycentric
    test over all cells, one point at a time); -1 when outside."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[None, :]
    pts = pts[:, : mesh.gdim]
    geom = cell_geometry(mesh)
    x0 = mesh.coords[mesh.cells[:, 0]]  # [nc, gdim]
    out = np.full(pts.shape[0], -1, dtype=np.int64)
    for pi, p in enumerate(pts):
        d = p[None, :] - x0  # [nc, gdim]
        xi = np.einsum("cg,cig->ci", d, geom.inv_edges)  # [nc, tdim]
        lam0 = 1.0 - xi.sum(axis=1)
        ok = (xi >= -tol).all(axis=1) & (lam0 >= -tol)
        hits = np.nonzero(ok)[0]
        if hits.size:
            out[pi] = hits[0]
    return out


def point_evaluation_tables(
    V: FunctionSpace, points: np.ndarray, tol: float = 1e-8
) -> tuple[np.ndarray, np.ndarray]:
    """(dofs [np, ndpc], weights [np, ndpc]) such that
    ``u(points) = (u_dofs[dofs] * weights).sum(axis=1)``."""
    mesh = V.mesh
    pts = np.asarray(points, dtype=np.float64)
    cells = _locate_cells(mesh, pts, tol=tol)
    if (cells < 0).any():
        raise ValueError(f"Points outside mesh: {pts[cells < 0]}")
    sub = cell_geometry(mesh, cells)
    x0 = mesh.coords[mesh.cells[cells, 0]]
    xi = np.einsum("pg,pig->pi", pts[:, : mesh.gdim] - x0, sub.inv_edges)
    N = V.element.tabulate(mesh.tdim, xi)
    return V.cell_dofs[cells], N
