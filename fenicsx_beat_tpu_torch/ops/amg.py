"""Smoothed-aggregation algebraic multigrid (SA-AMG) preconditioner.

Port of ``fenicsx_beat_tpu/ops/amg.py``, the counterpart of the hypre
BoomerAMG the reference reaches for on every hard elliptic solve: the
transmural Laplace solves of ``utils.laplace_solve`` on unstructured
meshes, and the bidomain's extracellular block wherever the DCT spectral
preconditioner declines (unstructured or heterogeneous operators).

- **Setup on the host** (numpy + scipy.sparse, once per operator), the
  JAX package's arithmetic line for line: the strength graph, aggregation
  by vectorized Luby-style maximal-independent-set rounds (a seeded
  priority, so every build is the same), tentative and smoothed
  prolongation ``P = (I - omega/lmax D^-1 A) T``, Galerkin products
  ``A_c = P^T A P``, per-level power-iteration estimates of
  ``lambda_max(D^-1 A)``, and a dense (pseudo-)inverse of the coarsest
  operator.  The host hierarchy keeps the caller's own operator on level
  0 and scipy CSR matrices below.
- **Application on the device**: :meth:`AMGHierarchy.to_device` puts every
  level's ``A``, ``P`` and ``R = P^T`` on the device as a
  :class:`~.cuda_ell.CSRMatrix`, so every product of a V-cycle is one
  launch of the CSR SpMV kernel (B8, ``csrc/csr_spmv.cu``) on the card and
  its plain twin on the CPU.  The Chebyshev recurrences are tensor
  arithmetic and the bottom solve is one dense ``coarse_inv @ r``, as the
  JAX package computes them outside any Pallas kernel.

With equal pre- and post-smoothing degrees and a zero initial guess the
V-cycle is a fixed symmetric positive (semi)definite linear operator in the
residual, hence a valid CG preconditioner.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from .cuda_ell import CSRMatrix, csr_spmv
from .sparse import operator_to_csr

__all__ = [
    "AMGLevel",
    "AMGHierarchy",
    "build_amg",
    "amg_apply",
    "chebyshev_smooth",
    "operator_to_csr",
]


def _np_dtype(dtype) -> np.dtype:
    """numpy dtype of ``dtype`` (numpy, torch or None -> float64)."""
    if dtype is None:
        return np.dtype(np.float64)
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


# ----------------------------------------------------------------------
# host-side setup pieces
# ----------------------------------------------------------------------
def _neighbor_max(indptr: np.ndarray, indices: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Per-row max of ``x[indices]`` over a CSR adjacency (0 for empty
    rows), by ``reduceat`` over the non-empty row starts."""
    out = np.zeros(len(indptr) - 1, dtype=x.dtype)
    nz = np.diff(indptr) > 0
    if not nz.any():
        return out
    gathered = x[indices]
    out[nz] = np.maximum.reduceat(gathered, indptr[:-1][nz])
    return out


def _strength_graph(A, theta: float):
    """Symmetric strength-of-connection graph: keep off-diagonal (i, j)
    with ``|a_ij| >= theta * sqrt(|a_ii * a_jj|)``, symmetrized."""
    import scipy.sparse as sp

    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    C = A.tocoo()
    off = C.row != C.col
    strong = off & (np.abs(C.data) >= theta * np.sqrt(d[C.row] * d[C.col]))
    S = sp.csr_matrix(
        (np.ones(int(strong.sum()), dtype=np.int8), (C.row[strong], C.col[strong])),
        shape=A.shape,
    )
    return S.maximum(S.T).tocsr()


def _aggregate(S, active: np.ndarray) -> tuple[np.ndarray, int]:
    """Aggregate nodes over the strength graph ``S``: Luby-style MIS roots
    (vectorized rounds), every other node joins the adjacent aggregate of
    maximal root priority, repeated transitively; strength-isolated
    leftovers become singleton aggregates.  ``active=False`` nodes (rows
    with no off-diagonal entry, e.g. masked Dirichlet dofs) stay out of
    every aggregate (``agg = -1``): the smoother alone handles them, and
    the coarsening cannot stall on them.  Returns ``(agg [n], n_aggregates)``."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    rng = np.random.default_rng(20260818)
    pri = rng.permutation(n).astype(np.float64) + 1.0  # unique, > 0

    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 root, 2 covered
    state[~active] = 2
    while True:
        und = state == 0
        if not und.any():
            break
        p_und = np.where(und, pri, 0.0)
        nb = _neighbor_max(indptr, indices, p_und)
        new_roots = und & (pri > nb)  # unique priorities: the strict max wins
        state[new_roots] = 1
        touched = _neighbor_max(indptr, indices, new_roots.astype(np.float64)) > 0
        state[(state == 0) & touched] = 2

    roots = np.nonzero(state == 1)[0]
    n_root = roots.size
    agg = np.full(n, -1, dtype=np.int64)
    agg[roots] = np.arange(n_root)

    # attach the remaining nodes to the adjacent aggregated neighbour of
    # largest priority; repeat so chains two or more steps from a root resolve
    enc = float(n_root + n + 1)
    for _ in range(n):
        un = (agg < 0) & active
        if not un.any():
            break
        # composite key priority * enc + (agg + 1): its max decodes the
        # winning neighbour's aggregate (exact in float64, n * enc << 2^53)
        comp = np.where(agg >= 0, pri * enc + (agg + 1).astype(np.float64), 0.0)
        nb = _neighbor_max(indptr, indices, comp)
        take = un & (nb > 0)
        if not take.any():
            rest = np.nonzero(un)[0]
            agg[rest] = n_root + np.arange(rest.size)
            n_root += rest.size
            break
        agg[take] = (nb[take] % enc).astype(np.int64) - 1
    return agg, n_root


def _per_level(val, k: int):
    """Per-level option: a scalar applies everywhere, a tuple or list
    clamps to its last entry for deeper levels."""
    if isinstance(val, (tuple, list)):
        return val[min(k, len(val) - 1)]
    return val


def _estimate_lmax(A, dinv: np.ndarray, iters: int = 12) -> float:
    """Power-iteration estimate of ``lambda_max(D^-1 A)`` (host, setup
    time); 1.0 for degenerate operators."""
    n = A.shape[0]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if not np.isfinite(ny) or ny == 0.0:
            return 1.0
        lam = ny
        x = y / ny
    return float(lam)


# ----------------------------------------------------------------------
# the hierarchy
# ----------------------------------------------------------------------
@dataclass
class AMGLevel:
    """One fine level: its operator, inverse diagonal, Chebyshev bound and
    the transfer pair to the next coarser level.  On the host ``A`` is the
    caller's operator (level 0) or a scipy CSR matrix, ``P`` and ``R``
    scipy CSR, ``dinv`` numpy; on a device all three matrices are
    :class:`~.cuda_ell.CSRMatrix` and ``dinv`` a tensor."""

    A: Any
    dinv: Any  # [n]
    lmax: Any  # lambda_max(D^-1 A) with a 5% margin
    P: Any  # [n, nc] prolongation
    R: Any  # [nc, n] restriction (= P^T)


@dataclass
class AMGHierarchy:
    """SA hierarchy of fixed depth; ``coarse_inv`` is the dense
    (pseudo-)inverse of the coarsest Galerkin operator, ``degree`` and
    ``lmin_frac`` the Chebyshev smoother's degree and spectrum slice."""

    levels: tuple[AMGLevel, ...]
    coarse_inv: Any  # [nc, nc]
    degree: int = 2
    lmin_frac: float = 1.0 / 30.0

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def on_host(self) -> bool:
        return isinstance(self.coarse_inv, np.ndarray)

    def to_device(self, device=None, dtype: torch.dtype | None = None, level0_A: CSRMatrix | None = None
                  ) -> "AMGHierarchy":
        """The hierarchy on ``device`` (the card when None) in ``dtype``
        (float32 on the card, float64 on the CPU by default): every level's
        ``A``, ``P`` and ``R`` as a :class:`~.cuda_ell.CSRMatrix`, applied by
        B8.  ``level0_A`` shares the caller's device copy of the fine
        operator instead of packing it again."""
        dev = resolve_device(device)
        dt = dtype or default_dtype(dev)

        def ship(M):
            return CSRMatrix.from_operator(M).to(dev, dt)

        levels = tuple(
            AMGLevel(
                A=level0_A if (i == 0 and level0_A is not None) else ship(lv.A),
                dinv=torch.as_tensor(np.asarray(lv.dinv, dtype=np.float64)).to(device=dev, dtype=dt),
                lmax=float(lv.lmax),
                P=ship(lv.P),
                R=ship(lv.R),
            )
            for i, lv in enumerate(self.levels)
        )
        coarse = torch.as_tensor(np.asarray(self.coarse_inv, dtype=np.float64)).to(device=dev, dtype=dt)
        return replace(self, levels=levels, coarse_inv=coarse)


def build_amg(
    A,
    *,
    strength_theta: float | tuple = 0.05,
    omega: float | tuple = 4.0 / 3.0,
    max_levels: int = 12,
    coarse_n: int = 500,
    degree: int = 2,
    agg_passes: int | tuple = 1,
    dtype=None,
    semidefinite: bool = False,
    cache_key: str | None = None,
) -> AMGHierarchy:
    """Build an SA hierarchy on the host for the SPD (or constant-nullspace
    semidefinite) operator ``A``: a host :class:`~.sparse.ELLMatrix`,
    :class:`~.sparse.StencilMatrix` or scipy sparse matrix.  Push it to a
    device with :meth:`AMGHierarchy.to_device`.

    ``semidefinite=True`` keeps the coarsest solve well posed for the
    bidomain extracellular block (nullspace: the constants): the dense
    bottom solve is an eigenvalue-thresholded pseudo-inverse.

    ``strength_theta``, ``omega`` and ``agg_passes`` take a scalar (every
    level) or a tuple (level k uses entry ``min(k, len - 1)``): the
    strength-of-connection threshold, the prolongator smoothing weight
    (0: the tentative, unsmoothed P) and the number of composed MIS
    aggregation passes per level.  ``dtype`` (numpy or torch; float64 by
    default) is the type of the stored values, ``dinv``, ``lmax`` and
    ``coarse_inv``; the Galerkin products are formed in float64.

    ``cache_key`` opts into the disk cache (:mod:`..cache`): the slot is
    keyed by the operator's CSR bytes and every option, and a warm build
    reads back the whole hierarchy, bit for bit what a rebuild gives (the
    build is deterministic)."""
    import scipy.sparse as sp

    A0 = (A if sp.issparse(A) else operator_to_csr(A)).tocsr()
    npdt = _np_dtype(dtype)

    slot = None
    if cache_key is not None:
        from ..cache import fingerprint, load_arrays

        # content-addressed: cache_key only opts in; callers that build the
        # same hierarchy share the slot
        slot = fingerprint(
            "amg",
            (strength_theta, omega, max_levels, coarse_n, degree, agg_passes, npdt, semidefinite),
            (A0.indptr, A0.indices, A0.data),
        )
        cached = load_arrays(slot)
        if cached is not None:
            h = _hierarchy_from_arrays(cached, A)
            if h is not None:
                return h

    levels: list[AMGLevel] = []
    Ak = A0
    fine_ops = [A]  # level 0's operator is the caller's own
    while Ak.shape[0] > coarse_n and len(levels) < max_levels - 1:
        # rows with no off-diagonal entry (masked Dirichlet dofs) stay off
        # the coarse grid; else they persist as singletons on every level
        offdiag = Ak.copy()
        offdiag.setdiag(0.0)
        offdiag.eliminate_zeros()
        active = np.diff(offdiag.indptr) > 0
        theta_k = _per_level(strength_theta, len(levels))
        S = _strength_graph(Ak, theta_k)
        agg, n_agg = _aggregate(S, active)
        if n_agg == 0 or n_agg >= 0.9 * Ak.shape[0]:
            break  # coarsening stalled: solve what there is densely
        # aggressive coarsening: further MIS passes on the tentative
        # Galerkin coarse graph
        for _ in range(_per_level(agg_passes, len(levels)) - 1):
            rows1 = np.nonzero(agg >= 0)[0]
            T1 = sp.csr_matrix((np.ones(rows1.size), (rows1, agg[rows1])), shape=(Ak.shape[0], n_agg))
            A1 = (T1.T @ Ak @ T1).tocsr()
            S1 = _strength_graph(A1, theta_k)
            agg1, n1 = _aggregate(S1, np.ones(n_agg, dtype=bool))
            if n1 == 0 or n1 >= 0.9 * n_agg:
                break
            agg[rows1] = agg1[agg[rows1]]
            n_agg = n1
        sizes = np.bincount(agg[agg >= 0], minlength=n_agg).astype(np.float64)
        rows_t = np.nonzero(agg >= 0)[0]
        T = sp.csr_matrix(
            (1.0 / np.sqrt(sizes[agg[rows_t]]), (rows_t, agg[rows_t])),
            shape=(Ak.shape[0], n_agg),
        )
        d = Ak.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0), 0.0)
        lmax = _estimate_lmax(Ak, dinv)
        omega_k = _per_level(omega, len(levels))
        if omega_k == 0.0:
            P = T.tocsr()  # unsmoothed aggregation: one entry a fine row
        else:
            DinvA = sp.diags(dinv) @ Ak
            P = (T - (omega_k / lmax) * (DinvA @ T)).tocsr()
        P.eliminate_zeros()
        Ac = (P.T @ Ak @ P).tocsr()
        Ac.eliminate_zeros()
        # order the coarse level by each aggregate's first fine member, so
        # it inherits the fine level's bandedness (JAX's order, kept)
        first_member = np.full(n_agg, Ak.shape[0], dtype=np.int64)
        rows_fm = np.nonzero(agg >= 0)[0]
        np.minimum.at(first_member, agg[rows_fm], rows_fm)
        cperm = np.argsort(first_member, kind="stable")
        Ac = Ac[cperm][:, cperm].tocsr()
        P = P[:, cperm].tocsr()

        fine = fine_ops[-1]
        levels.append(
            AMGLevel(
                A=fine if not levels else _cast_csr(fine, npdt),
                dinv=dinv.astype(npdt),
                lmax=np.asarray(1.05 * lmax, dtype=npdt),
                P=_cast_csr(P, npdt),
                R=_cast_csr(P.T.tocsr(), npdt),
            )
        )
        fine_ops.append(Ac)
        Ak = Ac

    Ad = np.asarray(Ak.todense(), dtype=np.float64)
    Ad = 0.5 * (Ad + Ad.T)
    # fully zero rows (masked Dirichlet dofs that reached the bottom) carry
    # zero residuals: an inert identity diagonal keeps the inverse valid
    zero = ~Ad.any(axis=1)
    if zero.any():
        Ad[zero, zero] = 1.0
    if semidefinite:
        coarse_inv = np.linalg.pinv(Ad, rcond=1e-10, hermitian=True)
    else:
        try:
            coarse_inv = np.linalg.inv(Ad)
        except np.linalg.LinAlgError:
            coarse_inv = np.linalg.pinv(Ad, rcond=1e-12, hermitian=True)
    h = AMGHierarchy(levels=tuple(levels), coarse_inv=coarse_inv.astype(npdt), degree=degree,
                     lmin_frac=1.0 / 30.0)
    if slot is not None:
        from ..cache import store_arrays

        store_arrays(slot, _hierarchy_to_arrays(h))
    return h


def _cast_csr(M, npdt):
    """Sorted, duplicate-free scipy CSR with values in ``npdt``."""
    M = M.tocsr(copy=True)
    M.sum_duplicates()
    M.sort_indices()
    M.data = M.data.astype(npdt)
    return M


# ----------------------------------------------------------------------
# disk cache round trip
# ----------------------------------------------------------------------
def _csr_to_arrays(out: dict, prefix: str, M) -> None:
    out[prefix + "indptr"] = M.indptr
    out[prefix + "indices"] = M.indices
    out[prefix + "data"] = M.data
    out[prefix + "shape"] = np.asarray(M.shape, dtype=np.int64)


def _csr_from_arrays(d: dict, prefix: str):
    import scipy.sparse as sp

    shape = tuple(int(x) for x in d[prefix + "shape"])
    return sp.csr_matrix((d[prefix + "data"], d[prefix + "indices"], d[prefix + "indptr"]), shape=shape)


def _hierarchy_to_arrays(h: AMGHierarchy) -> dict:
    """Flat array dict for the disk cache.  Level 0's ``A`` is the caller's
    own operator (not stored: the caller passes it back on a load)."""
    out = {
        "n_levels": np.asarray(len(h.levels)),
        "coarse_inv": np.asarray(h.coarse_inv),
        "degree": np.asarray(h.degree),
        "lmin_frac": np.asarray(h.lmin_frac),
    }
    for i, lv in enumerate(h.levels):
        if i > 0:
            _csr_to_arrays(out, f"L{i}_A_", lv.A)
        out[f"L{i}_dinv"] = np.asarray(lv.dinv)
        out[f"L{i}_lmax"] = np.asarray(lv.lmax)
        _csr_to_arrays(out, f"L{i}_P_", lv.P)
        _csr_to_arrays(out, f"L{i}_R_", lv.R)
    return out


def _hierarchy_from_arrays(d: dict, level0_A) -> AMGHierarchy | None:
    try:
        levels = tuple(
            AMGLevel(
                A=level0_A if i == 0 else _csr_from_arrays(d, f"L{i}_A_"),
                dinv=d[f"L{i}_dinv"],
                lmax=d[f"L{i}_lmax"],
                P=_csr_from_arrays(d, f"L{i}_P_"),
                R=_csr_from_arrays(d, f"L{i}_R_"),
            )
            for i in range(int(d["n_levels"]))
        )
        return AMGHierarchy(levels=levels, coarse_inv=d["coarse_inv"], degree=int(d["degree"]),
                            lmin_frac=float(d["lmin_frac"]))
    except Exception:
        return None


# ----------------------------------------------------------------------
# application
# ----------------------------------------------------------------------
def chebyshev_smooth(Amv, dinv, lmax: float, b, x, degree: int, lmin_frac: float = 1.0 / 30.0):
    """Degree-``degree`` Chebyshev smoother on the Jacobi-preconditioned
    operator ``D^-1 A``, aimed at the spectrum slice ``[lmin_frac * lmax,
    1.01 * lmax]``.  ``Amv`` is the matvec; ``x=None`` is a zero initial
    guess (one SpMV fewer).  A fixed polynomial in ``A``: symmetric, so
    equal pre- and post-smoothing keep the V-cycle SPD."""
    lo = lmin_frac * lmax
    hi = 1.01 * lmax
    th = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = th / delta
    rho = 1.0 / sigma
    if x is None:
        r = b
        x = torch.zeros_like(b)
    else:
        r = b - Amv(x)
    d = (dinv * r) / th
    for _ in range(degree - 1):
        x = x + d
        r = r - Amv(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho * rho_new) * d + (2.0 * rho_new / delta) * (dinv * r)
        rho = rho_new
    return x + d


def amg_apply(h: AMGHierarchy, r: torch.Tensor, spmv=csr_spmv) -> torch.Tensor:
    """One V(degree, degree) cycle with a zero initial guess, ``z ~= A^-1 r``,
    on ``r``'s device: on each level the two smoothings, the residual and
    both transfers are CSR products by ``spmv`` (B8's wrapper: the kernel
    on the card, 2 * degree + 2 launches a level; ``csr_spmv_twin`` runs
    the twin anywhere), the bottom a dense product."""
    if h.on_host:
        raise TypeError("amg_apply needs the hierarchy on a device: call AMGHierarchy.to_device first")

    def cycle(k: int, rk: torch.Tensor) -> torch.Tensor:
        if k == len(h.levels):
            return h.coarse_inv @ rk
        lv = h.levels[k]

        def Amv(v):
            return spmv(lv.A, v)

        x = chebyshev_smooth(Amv, lv.dinv, lv.lmax, rk, None, h.degree, h.lmin_frac)
        rc = spmv(lv.R, rk - Amv(x))
        x = x + spmv(lv.P, cycle(k + 1, rc))
        return chebyshev_smooth(Amv, lv.dinv, lv.lmax, rk, x, h.degree, h.lmin_frac)

    return cycle(0, r)
