"""FEM helper utilities: projection between spaces, space parsing,
transmural layer labelling by a Laplace solve.

Port of ``fenicsx_beat_tpu/utils.py``: ``local_project`` (a copy between
spaces of one size, else the transfer of ``fem.Function.interpolate``,
one B8 product on the device), ``parse_element`` / ``space_from_string``
for every family and degree, blocked with ``dim > 1``,
``interpolation_points``, ``laplace_solve``, and ``expand_layer`` /
``expand_layer_biv``: endo/epi surface markers become endo/mid/epi volume
layers by thresholding the solution of -Laplace(u) = 0 with u = 0 on the
endocardium (both endocardia in the BiV, one solve each, their pointwise
minimum) and u = 1 on the epicardium.  The solve is the port's PCG
(:mod:`.ops.cg`) on the device with the CSR SpMV kernel
(:mod:`.ops.cuda_ell`) as the operator, preconditioned by Jacobi or, as in
the JAX package from 5,000 dofs on (``precond="auto"``), by the SA-AMG
V-cycle of :mod:`.ops.amg`, every product of which is the same kernel.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple

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
    "expand_layer_biv",
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


class LaplaceInfo(NamedTuple):
    """How a :func:`_laplace_solve` call went: the preconditioner taken, CG
    iterations, the final residual norm, whether it converged, and the
    AMG hierarchy's depth and setup seconds (host build and the push to
    the device; 0 and 0.0 on Jacobi)."""

    precond: str
    iterations: int
    residual_norm: float
    converged: bool
    amg_levels: int
    amg_setup_s: float


def laplace_solve(
    V: fem.FunctionSpace,
    bcs: list[fem.DirichletBC],
    rtol: float | None = None,
    atol: float = 1e-14,
    maxiter: int = 10_000,
    precond: str = "auto",
    device=None,
) -> np.ndarray:
    """Solve -Laplace(u) = 0 with Dirichlet BCs by masked PCG.

    Dirichlet rows are eliminated by masking around the operator (the free
    dofs solve ``K_ff u_f = -K_fb g``).  ``precond="auto"`` takes the SA-AMG
    V-cycle (:mod:`.ops.amg`) from :data:`AMG_MIN_DOFS` dofs on, as the JAX
    package does, and Jacobi below; ``"amg"`` and ``"jacobi"`` force one.
    The hierarchy is built on the host on the masked matrix ``D K D`` (the
    Dirichlet rows become decoupled zero rows, which it leaves off the
    coarse grids).  Runs on ``device`` (the card when None) in its
    working dtype; ``rtol`` defaults to 1e-10 in float64 (the JAX
    package's) and 1e-6 in float32, where 1e-10 is below rounding.
    Returns the solution on the host."""
    return _laplace_solve(V, bcs, rtol=rtol, atol=atol, maxiter=maxiter, precond=precond, device=device)[0]


def _laplace_solve(
    V: fem.FunctionSpace,
    bcs: list[fem.DirichletBC],
    rtol: float | None = None,
    atol: float = 1e-14,
    maxiter: int = 10_000,
    precond: str = "auto",
    device=None,
) -> tuple[np.ndarray, LaplaceInfo]:
    """:func:`laplace_solve`: its solution, and how the solve went."""
    if precond not in ("auto", "amg", "jacobi"):
        raise ValueError(f"precond must be auto/amg/jacobi, got {precond!r}")
    n = V.ndofs
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
    use_amg = precond == "amg" or (precond == "auto" and n >= AMG_MIN_DOFS)
    levels, setup_s = 0, 0.0
    if use_amg:
        import scipy.sparse as sp

        from .ops.amg import amg_apply, build_amg, operator_to_csr

        tic = time.perf_counter()
        D = sp.diags(free.astype(np.float64))
        hier = build_amg(D @ operator_to_csr(K) @ D).to_device(dev, dtype)
        levels, setup_s = hier.n_levels, time.perf_counter() - tic
        prec = dict(precond=lambda r: amg_apply(hier, r))
    else:
        prec = dict(precond_diag=torch.where(freed, Kd.diagonal(), 1.0))
    x, info = cg(matvec, b, rtol=rtol, atol=atol, maxiter=maxiter, **prec)
    if not info.converged:
        logger.warning(
            "Laplace CG did not converge: %d iters, residual %g", info.iterations, info.residual_norm
        )
    return torch.where(freed, x, ubc).cpu().numpy(), LaplaceInfo(
        "amg" if use_amg else "jacobi", info.iterations, info.residual_norm, info.converged, levels, setup_s
    )


def _layers(arr: np.ndarray, endo_size, epi_size, mid, endo, epi) -> np.ndarray:
    labels = np.full(arr.shape[0], mid, dtype=np.int32)
    labels[arr <= endo_size] = endo
    labels[arr >= 1 - epi_size] = epi
    return labels


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
    return _layers(arr, endo_size, epi_size, output_mid_marker, output_endo_marker, output_epi_marker)


def expand_layer_biv(
    V: fem.FunctionSpace,
    ft: MeshTags,
    endo_lv_marker: int,
    endo_rv_marker: int,
    epi_marker: int,
    endo_size: float,
    epi_size: float,
    output_mid_marker: int = 0,
    output_endo_marker: int = 1,
    output_epi_marker: int = 2,
    device=None,
) -> np.ndarray:
    """Biventricular variant (reference ``utils.py:225-355``): one Laplace
    solve from each endocardium (LV, RV) to the epicardium, combined by
    their pointwise minimum, thresholded as :func:`expand_layer` does.
    Returns the per-dof layer markers (int32)."""
    logger.info("Expanding endo and epi markers to the rest of the mesh (biv)")
    endo_lv_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_lv_marker))
    endo_rv_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(endo_rv_marker))
    epi_dofs = fem.locate_dofs_topological(V, ft.dim, ft.find(epi_marker))
    epi = fem.dirichletbc(1.0, epi_dofs, V)
    arr_lv = laplace_solve(V, [fem.dirichletbc(0.0, endo_lv_dofs, V), epi], device=device)
    arr_rv = laplace_solve(V, [fem.dirichletbc(0.0, endo_rv_dofs, V), epi], device=device)
    arr = np.min([arr_rv, arr_lv], axis=0)
    return _layers(arr, endo_size, epi_size, output_mid_marker, output_endo_marker, output_epi_marker)
