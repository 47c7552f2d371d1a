"""Generic preconditioned conjugate gradients in torch.

Port of ``fenicsx_beat_tpu/ops/cg.py``.  JAX runs the loop as a
``lax.while_loop`` on the device; here it is a Python loop whose exit
test ``sqrt(<r, r>) > tol`` reads one scalar back to the host per
iteration.  It is the plain reference the fused solver's kernel PCG
(:mod:`.cuda_cg`) is tested against, and the solver of the unstructured
paths (the fused solver's ELL branch, ``utils.laplace_solve``) with the
CSR SpMV kernel as ``matvec``: same recurrences, same tolerance rule, so
the iteration counts match JAX's.  As in JAX, a general preconditioner
``precond`` (the bidomain's DCT solve or its deflated block
preconditioner) takes precedence over the Jacobi ``precond_diag``, and the
default inner product flattens its operands (``jnp.vdot``), so the
bidomain's stacked ``[2, n]`` system runs through the same loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["CGInfo", "cg", "cg_solve"]


class CGInfo(NamedTuple):
    iterations: int
    residual_norm: float
    converged: bool


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    precond_diag: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 1000,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, int, torch.Tensor, torch.Tensor]:
    """Preconditioned CG for SPD A, keeping the final residual on the
    device: ``precond(r)`` (an SPD ``z = P^{-1} r``) if given, else Jacobi
    with ``precond_diag``, else none.

    Returns ``(x, iterations, rr, tol)`` with ``rr = <r, r>`` and ``tol``
    0-d tensors.  The loop reads ``sqrt(rr) > tol`` back to the host once
    per test: ``iterations + 1`` reads, or ``maxiter`` when it stops
    there."""
    dot = dot or _vdot
    x = torch.zeros_like(b) if x0 is None else x0
    minv = None if precond_diag is None else 1.0 / precond_diag

    def apply_prec(r):
        if precond is not None:
            return precond(r)
        return r if minv is None else r * minv

    r = b - matvec(x)
    z = apply_prec(r)
    p = z
    rz = dot(r, z)
    tol = torch.clamp(rtol * torch.sqrt(dot(b, b)), min=atol)
    rr = dot(r, r)
    k = 0
    while k < maxiter and bool(torch.sqrt(rr) > tol):
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        rr = dot(r, r)
        k += 1
    return x, k, rr, tol


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
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> tuple[torch.Tensor, CGInfo]:
    """Solve A x = b for SPD A with preconditioned CG (:func:`cg_solve`)."""
    x, k, rr, tol = cg_solve(
        matvec, b, x0, precond_diag=precond_diag, rtol=rtol, atol=atol, maxiter=maxiter, dot=dot,
        precond=precond,
    )
    rnorm = torch.sqrt(rr)
    return x, CGInfo(iterations=k, residual_norm=float(rnorm), converged=bool(rnorm <= tol))
