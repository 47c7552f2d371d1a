"""Generic preconditioned conjugate gradients in torch.

Port of ``fenicsx_beat_tpu/ops/cg.py``.  JAX runs the loop as a
``lax.while_loop`` on the device; here it is a Python loop whose exit
test reads one scalar back to the host per iteration.  This is the plain
reference the fused solver's kernel PCG (:mod:`.cuda_cg`) is tested
against: same recurrences, same tolerance rule.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["CGInfo", "cg"]


class CGInfo(NamedTuple):
    iterations: int
    residual_norm: float
    converged: bool


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a, b)


def cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    precond_diag: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 1000,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, CGInfo]:
    """Solve A x = b for SPD A with Jacobi-preconditioned CG."""
    dot = dot or _vdot
    x = torch.zeros_like(b) if x0 is None else x0
    minv = None if precond_diag is None else 1.0 / precond_diag

    def apply_prec(r):
        return r if minv is None else r * minv

    r = b - matvec(x)
    z = apply_prec(r)
    p = z
    rz = dot(r, z)
    tol = torch.clamp(rtol * torch.sqrt(dot(b, b)), min=atol)
    k = 0
    while k < maxiter and bool(torch.sqrt(dot(r, r)) > tol):
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rnorm = torch.sqrt(dot(r, r))
    return x, CGInfo(iterations=k, residual_norm=float(rnorm), converged=bool(rnorm <= tol))
