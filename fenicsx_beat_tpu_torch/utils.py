"""Transmural layer labelling by a Laplace solve.

Port of ``laplace_solve`` (its Jacobi branch) and ``expand_layer`` from
``fenicsx_beat_tpu/utils.py``: endo/epi surface markers become
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

__all__ = ["laplace_solve", "expand_layer", "AMG_MIN_DOFS"]

logger = logging.getLogger(__name__)

AMG_MIN_DOFS = 5000  # "auto" takes AMG from here on in the JAX package


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
