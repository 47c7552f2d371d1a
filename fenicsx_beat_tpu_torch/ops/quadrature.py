"""Simplex quadrature rules (interval, triangle, tetrahedron), arbitrary degree.

Replaces the quadrature machinery the reference gets from Basix/FFCx
(used e.g. through ``metadata={"quadrature_degree": 8}`` in
``tests/test_monodomain.py:58-60`` of the reference).  Rules are built as
collapsed (Duffy) tensor products of Gauss-Jacobi rules, which gives exact
integration of polynomials up to the requested degree on the reference
simplex for any degree.

All outputs are host-side numpy arrays computed once at setup time.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def gauss_jacobi(n: int, alpha: float, beta: float) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule on [-1, 1] with weight (1-x)^alpha (1+x)^beta.

    Golub-Welsch: eigen-decomposition of the symmetric tridiagonal Jacobi
    matrix built from the three-term recurrence coefficients.
    """
    if n < 1:
        raise ValueError("need at least one quadrature point")
    k = np.arange(n, dtype=np.float64)
    ab = alpha + beta
    # diagonal (recurrence a_k)
    denom = (2 * k + ab) * (2 * k + ab + 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        diag = np.where(denom != 0.0, (beta**2 - alpha**2) / denom, 0.0)
    diag[0] = (beta - alpha) / (ab + 2)
    # off-diagonal (recurrence sqrt(b_k)), k = 1..n-1
    kk = k[1:]
    num = 4 * kk * (kk + alpha) * (kk + beta) * (kk + ab)
    den = (2 * kk + ab) ** 2 * (2 * kk + ab + 1) * (2 * kk + ab - 1)
    off = np.sqrt(num / den)
    J = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    x, V = np.linalg.eigh(J)
    mu0 = 2.0 ** (ab + 1) * math.gamma(alpha + 1) * math.gamma(beta + 1) / math.gamma(ab + 2)
    w = mu0 * V[0, :] ** 2
    return x, w


def _gj01(n: int, alpha: float) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Jacobi on [0,1] with weight (1-x)^alpha."""
    x, w = gauss_jacobi(n, alpha, 0.0)
    # map [-1,1] -> [0,1]: t=(x+1)/2; weight picks up (1/2)^(alpha+1)
    t = (x + 1.0) / 2.0
    w = w * 0.5 ** (alpha + 1.0)
    return t, w


@lru_cache(maxsize=None)
def simplex_rule(tdim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature rule on the reference simplex of topological dim ``tdim``.

    Reference simplices: interval [0,1]; triangle {x,y>=0, x+y<=1};
    tetrahedron {x,y,z>=0, x+y+z<=1}.  Returns (points [nq, tdim],
    weights [nq]); weights sum to the simplex measure 1/tdim!.
    """
    degree = max(int(degree), 1)
    n = (degree + 2) // 2  # ceil((degree+1)/2)
    if tdim == 0:
        return np.zeros((1, 0)), np.ones(1)
    if tdim == 1:
        t, w = _gj01(n, 0.0)
        return t[:, None], w
    if tdim == 2:
        # Duffy: x = a (1-b), y = b ; Jacobian factor (1-b) absorbed in Jacobi weight
        a, wa = _gj01(n, 0.0)
        b, wb = _gj01(n, 1.0)
        A, B = np.meshgrid(a, b, indexing="ij")
        WA, WB = np.meshgrid(wa, wb, indexing="ij")
        x = (A * (1 - B)).ravel()
        y = B.ravel()
        w = (WA * WB).ravel()
        return np.stack([x, y], axis=1), w
    if tdim == 3:
        a, wa = _gj01(n, 0.0)
        b, wb = _gj01(n, 1.0)
        c, wc = _gj01(n, 2.0)
        A, B, C = np.meshgrid(a, b, c, indexing="ij")
        WA, WB, WC = np.meshgrid(wa, wb, wc, indexing="ij")
        x = (A * (1 - B) * (1 - C)).ravel()
        y = (B * (1 - C)).ravel()
        z = C.ravel()
        w = (WA * WB * WC).ravel()
        return np.stack([x, y, z], axis=1), w
    raise ValueError(f"Unsupported simplex dimension {tdim}")
