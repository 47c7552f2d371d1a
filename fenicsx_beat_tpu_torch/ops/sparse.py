"""Sparse operators: fixed-offset (stencil) in torch, padded-row (ELL) on the host.

Port of ``StencilMatrix``, ``ELLMatrix`` and their host helpers from
``fenicsx_beat_tpu/ops/sparse.py``, plus a copy of ``operator_to_csr``
from ``fenicsx_beat_tpu/ops/amg.py`` (re-exported by :mod:`.amg`).

On lexicographically ordered structured meshes the P1 operator couples
row ``r`` to columns ``r + offsets[k]`` with one global offset set (15
offsets for the Kuhn-tet slab), so ``A @ x`` is K shifted multiply-adds.
Mass and stiffness share the offset set, so the theta-system operator is a
value-level combination (:meth:`StencilMatrix.combine`).  The
symmetric-stencil helpers feed the fused solver's kernel path
(:mod:`.cuda_spmv`): a symmetric operator needs only its ``d >= 0`` value
columns.  The general stencil SpMV (:mod:`.cuda_stencil`, ECG recovery)
streams the full table (:func:`pack_values`); its windowed form stages
one operand window per cluster of nearby offsets (:func:`offset_clusters`).

Unstructured meshes assemble to :class:`ELLMatrix`: padded rows with a
COO tail for the few high-degree rows (the LV's welded apex).  It stays
numpy-backed: the device format of an unstructured operator is the CSR of
:mod:`.cuda_ell`, packed from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "StencilMatrix",
    "stencil_is_symmetric",
    "pack_values",
    "OffsetClusters",
    "offset_clusters",
    "pack_sym_values",
    "ELLMatrix",
    "ell_spmv",
    "coo_to_ell",
    "coo_to_ell_group",
    "ell_to_stencil",
    "operator_to_csr",
]


@dataclass
class StencilMatrix:
    """Row r couples to columns ``r + offsets[k]`` with weights
    ``vals[r, k]``; rows lacking a neighbour at offset d carry weight 0."""

    offsets: tuple[int, ...]
    vals: torch.Tensor  # [n_rows, K]
    shape: tuple[int, int]

    def with_values(self, vals: torch.Tensor) -> "StencilMatrix":
        return StencilMatrix(offsets=self.offsets, vals=vals, shape=self.shape)

    def combine(self, ca, other: "StencilMatrix | None", cb) -> "StencilMatrix":
        """``ca*self + cb*other`` for matrices sharing the offset set."""
        vals = ca * self.vals
        if other is not None:
            vals = vals + cb * other.vals
        return self.with_values(vals)

    def diagonal(self) -> torch.Tensor:
        return self.vals[:, self.offsets.index(0)]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        # zero-padded shifts: K multiply-adds, no gather, no scatter
        n = x.shape[0]
        y = torch.zeros_like(x)
        for k, d in enumerate(self.offsets):
            w = self.vals[:, k]
            if d == 0:
                y = y + w * x
            elif d > 0:
                y[: n - d] = y[: n - d] + w[: n - d] * x[d:]
            else:
                y[-d:] = y[-d:] + w[-d:] * x[: n + d]
        return y


def stencil_is_symmetric(offsets: Sequence[int], vals: np.ndarray, tol: float = 1e-9) -> bool:
    """Host check that the stencil matrix is symmetric: for every d > 0,
    ``v_{-d}[r] == v_{+d}[r-d]`` (rows reaching outside [0, n) are zero).
    Moved here from ``fenicsx_beat_tpu/ops/pallas_spmv.py``."""
    offsets = tuple(int(d) for d in offsets)
    if set(offsets) != {-d for d in offsets}:
        return False
    vals = np.asarray(vals)
    n = vals.shape[0]
    scale = max(np.abs(vals).max(), 1e-30)
    for d in offsets:
        if d <= 0:
            continue
        vneg = vals[:, offsets.index(-d)]
        vpos = vals[:, offsets.index(d)]
        shifted = np.zeros_like(vneg)
        shifted[d:] = vpos[: n - d]
        if np.abs(vneg - shifted).max() > tol * scale:
            return False
    return True


def pack_values(A: StencilMatrix) -> torch.Tensor:
    """The full ``[K, n]`` value table of a stencil (row k holds offset
    ``A.offsets[k]``), contiguous: the layout the general stencil SpMV
    streams.  The JAX package's ``pack_values`` without its 128-lane
    padding."""
    return A.vals.T.contiguous()


@dataclass(frozen=True)
class OffsetClusters:
    """Offsets grouped so that each group's operand window is narrow:
    ``offsets[k]`` lies in cluster ``cluster_of[k]``, whose offsets run from
    ``lo[c]`` to ``lo[c] + span[c]``."""

    cluster_of: tuple[int, ...]
    lo: tuple[int, ...]
    span: tuple[int, ...]


def offset_clusters(offsets: Sequence[int], tile: int) -> OffsetClusters:
    """Group a stencil's offsets for the windowed SpMV: sort them and start
    a new cluster wherever neighbouring offsets are more than ``tile``
    apart.  A block of ``tile`` rows then stages one window of ``tile +
    span`` operand entries per cluster (three of at most ``2 (nz + 1)``
    span on the Kuhn-tet slab) instead of one window over the whole reach."""
    offsets = [int(d) for d in offsets]
    groups: list[list[int]] = []
    prev = None
    for k in sorted(range(len(offsets)), key=offsets.__getitem__):
        if prev is None or offsets[k] - prev > tile:
            groups.append([])
        groups[-1].append(k)
        prev = offsets[k]
    cluster_of = [0] * len(offsets)
    lo, span = [], []
    for c, ks in enumerate(groups):
        ds = [offsets[k] for k in ks]
        lo.append(min(ds))
        span.append(max(ds) - min(ds))
        for k in ks:
            cluster_of[k] = c
    return OffsetClusters(cluster_of=tuple(cluster_of), lo=tuple(lo), span=tuple(span))


def pack_sym_values(A: StencilMatrix) -> tuple[tuple[int, ...], torch.Tensor]:
    """The ``d >= 0`` offsets of a symmetric stencil and their value
    columns as one contiguous ``[Kp, n]`` tensor (row k holds offset
    ``pos[k]``), the layout the symmetric SpMV streams."""
    pos = tuple(d for d in A.offsets if d >= 0)
    cols = [A.offsets.index(d) for d in pos]
    return pos, A.vals[:, cols].T.contiguous()


# ---------------------------------------------------------------------------
# ELL (padded rows + COO tail), host numpy


@dataclass
class ELLMatrix:
    """Padded sparse matrix: row i has entries ``(cols[i, k], vals[i, k])``.

    Padding entries point at column ``i`` itself with value 0.  Entries of
    rows beyond the capped width spill into a COO tail
    (``tail_rows/cols/vals``), so a few high-degree rows (the welded apex
    of the LV ellipsoid, degree about 2*n_theta) do not widen every row.
    All arrays are numpy (host); :func:`ell_spmv` applies it to a torch
    vector on the vector's device.
    """

    cols: np.ndarray  # [n_rows, width] int32
    vals: np.ndarray  # [n_rows, width]
    shape: tuple[int, int]
    tail_rows: np.ndarray | None = None  # [nt] int32
    tail_cols: np.ndarray | None = None  # [nt] int32
    tail_vals: np.ndarray | None = None  # [nt]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def has_tail(self) -> bool:
        return self.tail_rows is not None and self.tail_rows.shape[0] > 0

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def diagonal(self) -> np.ndarray:
        n = self.shape[0]
        rows = np.arange(n, dtype=self.cols.dtype)[:, None]
        d = np.sum(np.where(self.cols == rows, self.vals, 0.0), axis=1)
        if self.has_tail:
            on_diag = self.tail_rows == self.tail_cols
            np.add.at(d, self.tail_rows, np.where(on_diag, self.tail_vals, 0.0))
        return d

    def with_values(self, vals: np.ndarray, tail_vals: np.ndarray | None = None) -> "ELLMatrix":
        return ELLMatrix(
            cols=self.cols,
            vals=vals,
            shape=self.shape,
            tail_rows=self.tail_rows,
            tail_cols=self.tail_cols,
            tail_vals=self.tail_vals if tail_vals is None else tail_vals,
        )

    def combine(self, ca, other: "ELLMatrix | None", cb) -> "ELLMatrix":
        """``ca*self + cb*other`` for matrices sharing the sparsity pattern."""
        vals = ca * self.vals + (cb * other.vals if other is not None else 0.0)
        tail = None
        if self.has_tail:
            tail = ca * self.tail_vals + (cb * other.tail_vals if other is not None else 0.0)
        return self.with_values(vals, tail)


def ell_spmv(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (x: [n_cols]) by gather and row sum, on x's device."""
    dev, dt = x.device, x.dtype
    cols = torch.as_tensor(A.cols, device=dev).long()
    vals = torch.as_tensor(A.vals, device=dev).to(dt)
    y = (vals * x[cols]).sum(dim=1)
    if A.has_tail:
        tr = torch.as_tensor(A.tail_rows, device=dev).long()
        tc = torch.as_tensor(A.tail_cols, device=dev).long()
        tv = torch.as_tensor(A.tail_vals, device=dev).to(dt)
        y = y.index_add(0, tr, tv * x[tc])
    return y


def coo_to_ell_group(
    rows: np.ndarray,
    cols: np.ndarray,
    vals_list,
    shape: tuple[int, int],
    dtype=None,
) -> tuple[ELLMatrix, ...]:
    """Duplicate-summed COO triplets sharing one ``(rows, cols)`` pattern
    (mass/stiffness pairs) -> ELL matrices of one identical layout, from one
    sort of the pattern.  The numpy branch of the JAX package's
    ``coo_to_ell`` applied to each value set: duplicates are summed in
    their sorted order (``np.bincount`` over the group index, which adds
    sequentially like ``np.add.at``).  The native kit's
    ``coo_to_ell_arrays`` sorts once for each value set and is slower here:
    10.5 s against 2.85 s for the psize 0.1 LV pair's 21M triplets on the
    host of an NVIDIA H100 80GB HBM3 at 700 W (``benchmarks/setup_kit.py``)."""
    n_rows = shape[0]
    key = rows.astype(np.int64) * shape[1] + cols.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    first = np.ones(key_sorted.size, dtype=bool)
    first[1:] = key_sorted[1:] != key_sorted[:-1]
    inv = np.cumsum(first) - 1
    uniq = key_sorted[first]
    urows = (uniq // shape[1]).astype(np.int64)
    ucols = (uniq % shape[1]).astype(np.int32)

    counts = np.bincount(urows, minlength=n_rows)
    width = int(counts.max()) if counts.size else 1
    row_start = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    pos = np.arange(uniq.shape[0]) - row_start[urows]
    ell_cols = np.tile(np.arange(n_rows, dtype=np.int32)[:, None], (1, width))
    ell_cols[urows, pos] = ucols
    out = []
    for vals in vals_list:
        vals_sorted = np.asarray(vals)[order]
        summed = np.bincount(inv, weights=vals_sorted, minlength=uniq.size).astype(vals_sorted.dtype)
        ell_vals = np.zeros((n_rows, width), dtype=vals_sorted.dtype)
        ell_vals[urows, pos] = summed
        out.append(_build_ell(ell_cols, ell_vals, counts, shape, dtype))
    return tuple(out)


def coo_to_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    shape: tuple[int, int],
    dtype=None,
) -> ELLMatrix:
    """Assemble duplicate-summed COO triplets into a padded ELL matrix.
    Matrices assembled from the same (rows, cols) pattern produce identical
    layouts, so they can be combined value-wise (:meth:`ELLMatrix.combine`)."""
    return coo_to_ell_group(rows, cols, [vals], shape, dtype)[0]


def _build_ell(ell_cols, ell_vals, counts, shape, dtype) -> ELLMatrix:
    """Construct an ELLMatrix, spilling outlier high-degree rows into a COO
    tail when they would inflate the padded width.  The split depends only
    on the sparsity pattern (row counts), so mass/stiffness pairs split
    identically and stay ``combine``-compatible."""
    W = ell_cols.shape[1]
    cap = max(int(np.percentile(counts, 99)) if counts.size else 1, 4)
    if dtype is not None:
        ell_vals = ell_vals.astype(dtype)
    if W <= max(int(cap * 1.5), cap + 4):
        return ELLMatrix(cols=ell_cols.astype(np.int32), vals=ell_vals, shape=shape)
    heavy = np.nonzero(counts > cap)[0]
    tr, tc, tv = [], [], []
    for r in heavy:
        c = int(counts[r])
        tr.append(np.full(c - cap, r, dtype=np.int32))
        tc.append(ell_cols[r, cap:c].astype(np.int32))
        tv.append(ell_vals[r, cap:c])
    return ELLMatrix(
        cols=ell_cols[:, :cap].astype(np.int32),
        vals=ell_vals[:, :cap].copy(),
        shape=shape,
        tail_rows=np.concatenate(tr),
        tail_cols=np.concatenate(tc),
        tail_vals=np.concatenate(tv),
    )


def ell_to_stencil(A: ELLMatrix, max_offsets: int = 64) -> StencilMatrix | None:
    """Convert an ELL matrix to stencil form (float64 CPU values) when a
    small global offset set exists; None otherwise."""
    if A.has_tail:
        return None
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    n, _ = cols.shape
    rows = np.arange(n, dtype=np.int64)[:, None]
    offs = cols.astype(np.int64) - rows  # padding entries (col == row, 0) give offset 0
    uniq = np.unique(offs)
    if uniq.size > max_offsets:
        return None
    K = uniq.size
    st_vals = np.zeros((n, K), dtype=vals.dtype)
    kk = np.searchsorted(uniq, offs)
    np.add.at(st_vals, (np.broadcast_to(rows, offs.shape), kk), vals)
    return StencilMatrix(
        offsets=tuple(int(d) for d in uniq),
        vals=torch.from_numpy(st_vals),
        shape=A.shape,
    )


def operator_to_csr(A):
    """Host scipy CSR of an :class:`ELLMatrix` or :class:`StencilMatrix`
    (duplicates summed, the ELL's padding zeros and COO tail folded in).
    Copy of ``fenicsx_beat_tpu/ops/amg.py:operator_to_csr``."""
    import scipy.sparse as sp

    n, m = A.shape
    if isinstance(A, StencilMatrix):
        vals = A.vals.detach().cpu().numpy() if isinstance(A.vals, torch.Tensor) else np.asarray(A.vals)
        rows_list, cols_list, data_list = [], [], []
        r = np.arange(n, dtype=np.int64)
        for k, d in enumerate(A.offsets):
            c = r + d
            ok = (c >= 0) & (c < m) & (vals[:, k] != 0.0)
            rows_list.append(r[ok])
            cols_list.append(c[ok])
            data_list.append(vals[ok, k])
        rows = np.concatenate(rows_list)
        cols = np.concatenate(cols_list)
        data = np.concatenate(data_list)
    else:
        cols2 = np.asarray(A.cols)
        vals2 = np.asarray(A.vals)
        rows = np.repeat(np.arange(n, dtype=np.int64), cols2.shape[1])
        cols = cols2.reshape(-1).astype(np.int64)
        data = vals2.reshape(-1)
        keep = data != 0.0
        rows, cols, data = rows[keep], cols[keep], data[keep]
        if A.has_tail:
            rows = np.concatenate([rows, np.asarray(A.tail_rows, dtype=np.int64)])
            cols = np.concatenate([cols, np.asarray(A.tail_cols, dtype=np.int64)])
            data = np.concatenate([data, np.asarray(A.tail_vals)])
    M = sp.csr_matrix((data.astype(np.float64), (rows, cols)), shape=(n, m))
    M.sum_duplicates()
    return M
