"""FEM helper utilities: projection between spaces, space parsing,
transmural layer labelling by a Laplace solve.

Port of ``fenicsx_beat_tpu/utils.py``: ``local_project`` (a copy between
spaces of one size, else the transfer of ``fem.Function.interpolate``,
one B8 product on the device), ``parse_element`` / ``space_from_string``
for every family and degree, blocked with ``dim > 1``,
``interpolation_points``, and ``laplace_solve`` (its Jacobi branch) and
``expand_layer``: endo/epi surface markers become
endo/mid/epi volume layers by thresholding the solution of -Laplace(u) = 0
with u = 0 on the endocardium and u = 1 on the epicardium.  The solve is
the port's Jacobi-PCG (:mod:`.ops.cg`) on the device, with the CSR SpMV
kernel (:mod:`.ops.cuda_ell`) as the operator.  The SA-AMG preconditioner
the JAX package takes at 5,000 dofs and more is not ported (ROADMAP A11):
``precond="amg"`` raises, and so does ``"auto"`` at that size; pass
``precond="jacobi"``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import fem
from .config import default_dtype, resolve_device
from .mesh import MeshTags
from .ops.cg import cg
from .ops.cuda_ell import CSRMatrix, csr_spmv

__all__ = [
    "interpolation_points",
    "local_project",
    "parse_element",
    "space_from_string",
    "laplace_solve",
    "expand_layer",
    "AMG_MIN_DOFS",
]

logger = logging.getLogger(__name__)

AMG_MIN_DOFS = 5000  # "auto" takes AMG from here on in the JAX package

# re-exported for parity with reference utils
interpolation_points = fem.interpolation_points


def local_project(
    v: fem.Function,
    V: fem.FunctionSpace,
    u: fem.Function | None = None,
    device=None,
    use_kernels: bool = True,
) -> fem.Function:
    """Element-wise projection/interpolation between spaces (reference
    ``utils.py:26-58``): a copy into ``u`` (a new function of ``V`` when
    None) when the two spaces have the same number of dofs, as the JAX
    package does; else ``u.interpolate(v)`` on ``device`` (the card when
    None): the transfer matrix's product, B8 on the card (its twin with
    ``use_kernels=False``)."""
    U = u if u is not None else fem.Function(V)
    if v.x.array.size == U.x.array.size:
        U.x.array[:] = v.x.array[:]
        return U
    U.interpolate(v, device=device, use_kernels=use_kernels)
    return U


def parse_element(space_string: str, mesh, dim: int = 1) -> fem.Element:
    """Parse '{family}_{degree}' strings, e.g. 'P_1', 'DG_1', 'Quadrature_4'
    (reference ``utils.py:61-84``).  ``dim > 1`` selects a blocked variant,
    applied by :func:`space_from_string` (the element is scalar; blocking
    lives on the space)."""
    family_str, degree_str = space_string.split("_")
    aliases = {
        "Lagrange": "P",
        "P": "P",
        "CG": "P",
        "Discontinuous Lagrange": "DG",
        "DG": "DG",
        "dP": "DG",
        "Quadrature": "Quadrature",
        "Q": "Quadrature",
        "Quad": "Quadrature",
    }
    if family_str not in aliases:
        msg = f"Unknown element family: {family_str}, available families: {sorted(set(aliases))}"
        raise ValueError(msg)
    return fem.Element(aliases[family_str], int(degree_str))


def space_from_string(space_string: str, mesh, dim: int = 1) -> fem.FunctionSpace:
    """Function space from a '{family}_{degree}' string; ``dim > 1`` builds
    a blocked vector space (reference ``utils.py:87-112``)."""
    el = parse_element(space_string, mesh, dim)
    return fem.functionspace(mesh, el, shape=(dim,) if dim > 1 else None)


def laplace_solve(
    V: fem.FunctionSpace,
    bcs: list[fem.DirichletBC],
    rtol: float | None = None,
    atol: float = 1e-14,
    maxiter: int = 10_000,
    precond: str = "auto",
    device=None,
) -> np.ndarray:
    """Solve -Laplace(u) = 0 with Dirichlet BCs by masked Jacobi-PCG.

    Dirichlet rows are eliminated by masking around the operator (the free
    dofs solve ``K_ff u_f = -K_fb g``).  Runs on ``device`` (the card when
    None) in its working dtype; ``rtol`` defaults to 1e-10 in float64 (the
    JAX package's) and 1e-6 in float32, where 1e-10 is below rounding.
    Returns the solution on the host."""
    if precond not in ("auto", "amg", "jacobi"):
        raise ValueError(f"precond must be auto/amg/jacobi, got {precond!r}")
    n = V.ndofs
    if precond == "amg" or (precond == "auto" and n >= AMG_MIN_DOFS):
        raise NotImplementedError(
            f"the AMG preconditioner (precond={precond!r} at {n} dofs) is not ported yet "
            "(ROADMAP A11); pass precond='jacobi'"
        )
    dev = resolve_device(device)
    dtype = default_dtype(dev)
    if rtol is None:
        rtol = 1e-10 if dtype == torch.float64 else 1e-6
    _, K = fem.assemble_mass_stiffness(V, 1.0)
    u_bc = np.zeros(n)
    free = np.ones(n, dtype=bool)
    for bc in bcs:
        u_bc[bc.dofs] = bc.value
        free[bc.dofs] = False
    Kd = CSRMatrix.from_operator(K).to(dev, dtype)
    freed = torch.as_tensor(free, device=dev)
    ubc = torch.as_tensor(u_bc, device=dev).to(dtype)

    def matvec(v):
        return torch.where(freed, csr_spmv(Kd, torch.where(freed, v, 0.0)), 0.0)

    b = torch.where(freed, -csr_spmv(Kd, ubc), 0.0)
    diag = torch.where(freed, Kd.diagonal(), 1.0)
    x, info = cg(matvec, b, precond_diag=diag, rtol=rtol, atol=atol, maxiter=maxiter)
    if not info.converged:
        logger.warning(
            "Laplace CG did not converge: %d iters, residual %g", info.iterations, info.residual_norm
        )
    return torch.where(freed, x, ubc).cpu().numpy()


def expand_layer(
    V: fem.FunctionSpace,
    ft: MeshTags,
    endo_marker: int,
    epi_marker: int,
    endo_size: float,
    epi_size: float,
    output_mid_marker: int = 0,
    output_endo_marker: int = 1,
    output_epi_marker: int = 2,
    precond: str = "auto",
    device=None,
) -> np.ndarray:
    """Expand endo/epi surface markers into transmural volume layers by
    thresholding a Laplace solution.  Returns the per-dof layer markers
    (int32; the JAX package returns them as a P1 Function).  ``precond``
    goes to :func:`laplace_solve`."""
    logger.info("Expanding endo and epi markers to the rest of the mesh")
    endo_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_marker))
    epi_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(epi_marker))
    bcs = [fem.dirichletbc(0.0, endo_dofs, V), fem.dirichletbc(1.0, epi_dofs, V)]
    arr = laplace_solve(V, bcs, precond=precond, device=device)
    labels = np.full(V.ndofs, output_mid_marker, dtype=np.int32)
    labels[arr <= endo_size] = output_endo_marker
    labels[arr >= 1 - epi_size] = output_epi_marker
    return labels
