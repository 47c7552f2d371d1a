"""DCT-based spectral preconditioning for constant-stencil operators.

Port of ``fenicsx_beat_tpu/ops/spectral.py``.  The bidomain extracellular
block is pure stiffness: unlike the monodomain theta system it is not
mass-dominated, and Jacobi-CG iterations grow like O(1/h).  On the
structured grids the stencil path detects, the interior stiffness row is
one constant stencil, and the cosine (DCT-II) basis nearly diagonalizes it
under Neumann boundaries, so the exact inverse of that constant-stencil
operator is a spectrally equivalent preconditioner.

The eigenvalue model (:func:`stencil_dct_eigenvalues`, with its constancy
guard and SPD floor) is the JAX package's, copied as host numpy.  The
solve (:func:`dct_solve`) is separable per-axis dense products with
orthonormal DCT-II matrices, ``torch.tensordot`` as the JAX package left it
to XLA; the matrices are built once per (size, device) on the device.

Precision: JAX forces ``Precision.HIGHEST`` on these products, because a
lower-precision transform broke the preconditioner's symmetry and CG
stagnated (``spectral.py:174-177`` there).  A float32 product on the card
runs in TF32 wherever ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` allow it, a process-wide setting
this module neither reads nor changes.  So the transform runs in float64
whatever the operand's dtype, which no such setting touches, and the
result is cast back: at the dx=0.1 slab (201 x 71 x 31 nodes) one solve is
about 0.5 GFLOP.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

__all__ = [
    "grid_shape",
    "stencil_dct_eigenvalues",
    "dct_solve",
    "stencil_dct_solver",
]


def grid_shape(mesh) -> tuple[int, ...] | None:
    """Node dimensions of a lexicographically ordered tensor grid, or
    ``None``.  The structured meshes (create_rectangle / create_box / the
    slab geometries) enumerate nodes as ``ix*(Ny*Nz) + iy*Nz + iz`` over a
    uniform product grid."""
    coords = mesh.coords
    n, gdim = coords.shape
    axes = [np.unique(coords[:, a]) for a in range(gdim)]
    if int(np.prod([len(u) for u in axes])) != n:
        return None
    dims = tuple(len(u) for u in axes)
    # verify lexicographic order (last axis fastest) and uniform spacing
    grids = np.meshgrid(*axes, indexing="ij")
    expect = np.stack([g.ravel() for g in grids], axis=1)
    if not np.allclose(expect, coords, atol=1e-12):
        return None
    for u in axes:
        if len(u) > 2 and not np.allclose(np.diff(u), u[1] - u[0], rtol=1e-8):
            return None
    return dims


def _strides(dims) -> np.ndarray:
    s = np.ones(len(dims), dtype=np.int64)
    for a in range(len(dims) - 2, -1, -1):
        s[a] = s[a + 1] * dims[a + 1]
    return s


def _decode_offsets(offsets, dims):
    """Flat stencil offsets -> per-axis displacements with |d_a| <= 1 (the
    P1 simplex reach), or ``None``.  Requires every axis >= 4 nodes so the
    decode is unambiguous (a 2- or 3-node axis lets a wraparound multi-jump
    masquerade as a neighbor displacement)."""
    if any(N < 4 for N in dims):
        return None
    strides = _strides(dims)
    out = []
    for o in offsets:
        hit = None
        for d in np.ndindex(*([3] * len(dims))):
            disp = tuple(x - 1 for x in d)  # each in {-1, 0, 1}
            if int(np.dot(disp, strides)) == int(o):
                hit = disp
                break
        if hit is None:
            return None
        out.append(hit)
    return out


def stencil_dct_eigenvalues(stencil, mesh, dtype=None):
    """``(lam [dims], dims)`` for the DCT-II eigenvalue model of
    ``stencil``'s constant interior row, host numpy, or ``None`` when the
    mesh is not a tensor grid, the coefficients are not constant across
    interior rows (heterogeneous conductivity), or the offsets do not
    decode.  ``dtype`` (numpy) casts ``lam``; by default it keeps the
    stencil values' dtype."""
    dims = grid_shape(mesh)
    if dims is None:
        return None
    disps = _decode_offsets(stencil.offsets, dims)
    if disps is None:
        return None
    vals = stencil.vals
    vals = vals.detach().cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
    strides = _strides(dims)
    center_idx = [d // 2 for d in dims]
    center = int(np.dot(center_idx, strides))
    c = vals[center]
    # constancy guard: the model is built from ONE row; decline when other
    # interior rows disagree (e.g. per-cell scar conductivities) -- a
    # mis-scaled global preconditioner is worse than Jacobi
    probes = []
    for a in range(len(dims)):
        for d in (-1, 1):
            idx = list(center_idx)
            idx[a] += d
            if 0 < idx[a] < dims[a] - 1:
                probes.append(int(np.dot(idx, strides)))
    for p in probes:
        if not np.allclose(vals[p], c, rtol=1e-8, atol=1e-12 * np.abs(c).max()):
            return None

    lam = np.zeros(dims)
    for coef, disp in zip(c, disps):
        term = np.ones(dims)
        for a, (d_a, N_a) in enumerate(zip(disp, dims)):
            k = np.arange(N_a)
            cos = np.cos(np.pi * k * abs(d_a) / N_a)
            shape = [1] * len(dims)
            shape[a] = N_a
            term = term * cos.reshape(shape)
        lam += coef * term
    scale = np.abs(lam).max()
    pos = lam[np.abs(lam) > 1e-12 * scale]
    if pos.size == 0:
        return None
    floor = float(np.abs(pos).min())
    lam = np.where(np.abs(lam) < 1e-12 * scale, np.mean(np.abs(pos)), lam)
    lam = np.maximum(lam, 0.25 * floor)  # SPD guard for the dropped cross-terms
    return lam.astype(vals.dtype if dtype is None else dtype), dims


@functools.lru_cache(maxsize=32)
def _dct_matrix(N: int, device: torch.device) -> torch.Tensor:
    """Orthonormal DCT-II matrix (scipy ``norm='ortho'`` convention),
    float64 on ``device``: ``C[k, n] = s_k cos(pi (n + 1/2) k / N)``."""
    n = torch.arange(N, dtype=torch.float64, device=device)
    k = n[:, None]
    C = torch.cos(math.pi * (n + 0.5) * k / N)
    s = torch.full((N, 1), math.sqrt(2.0 / N), dtype=torch.float64, device=device)
    s[0] = math.sqrt(1.0 / N)
    return s * C


def dct_solve(r: torch.Tensor, lam: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """Apply the DCT-diagonal inverse: ``z ~ stencil^-1 r`` for the model
    operator whose eigenvalues are ``lam`` (from
    :func:`stencil_dct_eigenvalues`, a tensor on ``r``'s device): a forward
    transform along every axis, a division by ``lam``, an inverse
    transform.  Computed in float64 (see the module docstring) and returned
    in ``r``'s dtype."""
    dev = r.device
    x = r.to(torch.float64).reshape(dims)
    for a, N in enumerate(dims):
        x = torch.movedim(torch.tensordot(_dct_matrix(N, dev), x, dims=([1], [a])), 0, a)
    x = x / lam.to(torch.float64).reshape(dims)
    for a, N in enumerate(dims):
        x = torch.movedim(torch.tensordot(_dct_matrix(N, dev).T, x, dims=([1], [a])), 0, a)
    return x.reshape(r.shape).to(r.dtype)


def stencil_dct_solver(stencil, mesh) -> Callable | None:
    """Closure form of the solver (its float64 eigenvalues moved to the
    operand's device), or ``None`` where :func:`stencil_dct_eigenvalues`
    declines."""
    out = stencil_dct_eigenvalues(stencil, mesh, dtype=np.float64)
    if out is None:
        return None
    lam, dims = out
    lam_t = torch.as_tensor(lam)

    def apply(r):
        return dct_solve(r, lam_t.to(r.device), dims)

    return apply
