"""B8: general sparse SpMV for unstructured operators, in CSR.

Counterpart of ``fenicsx_beat_tpu/ops/pallas_ell.py``: ``pack_lane_gather``,
``LaneGatherMatrix`` (``from_operator``, ``from_operator_group``,
``from_operator_pair``, ``combine``, ``diagonal``) and the kernel
``build_lane_gather_spmv`` with its COO tail.  The paged lane format exists
only to work around the TPU's gather limits; on the H100 the device format
is plain CSR (:class:`CSRMatrix`) and ``A @ x`` is one launch of
``csrc/csr_spmv.cu`` (:func:`csr_spmv`): a warp for each row longer than
:data:`LONG_ROW` entries (listed once per operator, ``CSRMatrix.long_rows``),
a thread for each other row.

The packing contract is the JAX one: duplicate entries are summed,
entries that are exactly zero in every operator of a group are dropped,
rectangular shapes are allowed, and operators packed as one group share
one layout, so :meth:`CSRMatrix.combine` works on values alone (the
theta-system ``C_m M + theta dt K`` every solver builds) and the diagonal
combines the same way.  CSR has no page cap: the rows that spill to the
TPU format's COO tail stay in their rows, and the product equals the JAX
kernel's plus its tail; the kernel's list of long rows is the port's form of
that split.

On a CUDA tensor :func:`csr_spmv` launches the kernel; on a CPU tensor it
runs the plain PyTorch twin :func:`csr_spmv_twin` (gather, multiply and a
fixed-order segment sum per row, in the tensor's own dtype).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .._build import check, load_library, require_cuda_f32, require_cuda_i32, stream_ptr

__all__ = ["CSRMatrix", "LONG_ROW", "long_rows_of", "pack_csr", "csr_spmv", "csr_spmv_twin"]

# Rows with more entries than this get a warp of their own in the kernel.
LONG_ROW = 32


def pack_csr(rows, cols, vals, shape: tuple[int, int]):
    """Pack COO triplets (duplicates summed) into CSR on the host.

    ``vals`` may be ``[nnz]`` or stacked ``[k, nnz]``: stacked value sets
    share ONE layout, decided by the union pattern, and an entry is
    dropped only where every set is exactly zero.  Returns ``(indptr
    [n_rows + 1] int64, cols [nnz] int64, vals [nnz] or [k, nnz] float64)``,
    columns ascending within each row."""
    n_rows, n_cols = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    stacked = vals.ndim == 2
    vals2 = vals if stacked else vals[None]
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.ones(ks.size, dtype=bool)
    first[1:] = ks[1:] != ks[:-1]
    inv = np.cumsum(first) - 1
    uniq = ks[first]
    summed = np.stack([np.bincount(inv, weights=v[order], minlength=uniq.size) for v in vals2])
    live = (summed != 0.0).any(axis=0)
    uniq, summed = uniq[live], summed[:, live]
    urows = uniq // n_cols
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(urows, minlength=n_rows), out=indptr[1:])
    return indptr, uniq % n_cols, summed if stacked else summed[0]


def long_rows_of(indptr: torch.Tensor) -> torch.Tensor:
    """The rows of ``indptr`` longer than :data:`LONG_ROW` entries, int32,
    on ``indptr``'s device."""
    return torch.nonzero(indptr[1:] - indptr[:-1] > LONG_ROW).flatten().to(torch.int32)


def _pack_ell_group(ops):
    """``(shape, indptr, cols, vals [k, nnz])`` of ELL operators sharing
    one layout and no COO tail, read in place: each row's entries are in
    column order with its padding (zeros at the row's own column) after,
    so dropping the entries that are zero in every operator leaves the
    duplicate-free, column-ordered rows :func:`pack_csr` would give.  None
    for any other group."""
    from .sparse import ELLMatrix

    first = ops[0]
    if not all(isinstance(A, ELLMatrix) and not A.has_tail and A.shape == first.shape for A in ops):
        return None
    if not all(A.cols is first.cols or np.array_equal(A.cols, first.cols) for A in ops[1:]):
        return None
    vals = np.stack([np.asarray(A.vals, dtype=np.float64) for A in ops])  # [k, n, w]
    live = (vals != 0.0).any(axis=0)
    indptr = np.zeros(first.shape[0] + 1, dtype=np.int64)
    np.cumsum(live.sum(axis=1), out=indptr[1:])
    return first.shape, indptr, np.asarray(first.cols)[live].astype(np.int64), vals[:, live]


def _as_csr(A):
    import scipy.sparse as sp

    from .sparse import operator_to_csr

    return (A if sp.issparse(A) else operator_to_csr(A)).tocsr()


@dataclass
class CSRMatrix:
    """Sparse matrix in CSR form, on one device: ``indptr`` [n_rows + 1]
    and ``cols`` [nnz] int32, ``vals`` [nnz]; ``diag`` [n] for square
    operators, captured at pack time; ``long_rows``, the rows longer than
    :data:`LONG_ROW` entries (int32, :func:`long_rows_of`), always found
    from ``indptr`` when a matrix is made (a list that missed a long row
    would leave its output unwritten), so never given.  ``@`` is
    :func:`csr_spmv`."""

    indptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]
    diag: torch.Tensor | None = None
    long_rows: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self.long_rows = long_rows_of(self.indptr)

    @classmethod
    def from_operator(cls, A) -> "CSRMatrix":
        """From a host :class:`~.sparse.ELLMatrix` (tail included),
        :class:`~.sparse.StencilMatrix` or scipy sparse matrix; float64 host
        (CPU) tensors, moved and cast with :meth:`to`."""
        return cls.from_operator_group((A,))[0]

    @classmethod
    def from_operator_group(cls, ops) -> tuple["CSRMatrix", ...]:
        """Pack same-pattern operators (mass/stiffness) into ONE shared
        layout, so :meth:`combine` between them is valid; each keeps the
        entries that are zero in it but not in the others.  ELL operators
        of one layout without a COO tail (rows in column order, padding of
        zeros after) are read row by row with no sort: the same CSR as the
        sorting path gives, which the others take."""
        packed = _pack_ell_group(ops)
        if packed is not None:
            shape, indptr, ucols, pvals = packed
        else:
            Ms = [_as_csr(A).tocoo() for A in ops]
            shape = Ms[0].shape
            if any(M.shape != shape for M in Ms):
                raise ValueError(f"operators of one group need one shape, got {[M.shape for M in Ms]}")
            rows = np.concatenate([M.row for M in Ms])
            cols = np.concatenate([M.col for M in Ms])
            stacked = np.zeros((len(Ms), rows.size))
            off = 0
            for k, M in enumerate(Ms):
                stacked[k, off : off + M.data.size] = M.data
                off += M.data.size
            indptr, ucols, pvals = pack_csr(rows, cols, stacked, shape)
        square = shape[0] == shape[1]
        if square:
            prow = np.repeat(np.arange(shape[0]), np.diff(indptr))
            on = prow == ucols
            diags = np.zeros((len(ops), shape[0]))
            diags[:, prow[on]] = pvals[:, on]
        indptr_t = torch.from_numpy(indptr.astype(np.int32))
        cols_t = torch.from_numpy(ucols.astype(np.int32))
        return tuple(
            cls(
                indptr=indptr_t,
                cols=cols_t,
                vals=torch.from_numpy(np.ascontiguousarray(pvals[k])),
                shape=(int(shape[0]), int(shape[1])),
                diag=torch.from_numpy(diags[k]) if square else None,
            )
            for k in range(len(ops))
        )

    @classmethod
    def from_operator_pair(cls, A, B) -> tuple["CSRMatrix", "CSRMatrix"]:
        """Two-operator form of :meth:`from_operator_group`."""
        return cls.from_operator_group((A, B))

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def to(self, device=None, dtype: torch.dtype | None = None) -> "CSRMatrix":
        """A copy on ``device`` with values (and diagonal) in ``dtype``."""
        dtype = dtype or self.vals.dtype
        return CSRMatrix(
            indptr=self.indptr.to(device),
            cols=self.cols.to(device),
            vals=self.vals.to(device=device, dtype=dtype),
            shape=self.shape,
            diag=None if self.diag is None else self.diag.to(device=device, dtype=dtype),
        )

    def diagonal(self) -> torch.Tensor | None:
        return self.diag

    def combine(self, ca, other: "CSRMatrix | None", cb) -> "CSRMatrix":
        """``ca*self + cb*other`` for matrices packed as one group."""
        vals = ca * self.vals + (cb * other.vals if other is not None else 0.0)
        diag = self.diag
        if diag is not None:
            diag = ca * diag + (cb * other.diag if other is not None else 0.0)
        return replace(self, vals=vals, diag=diag)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return csr_spmv(self, x)


def csr_spmv_twin(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: each row's products ``vals * x[cols]`` summed by
    a segment sum over ``indptr``, with no atomics, so its order is fixed
    on every device: on the CPU the entries one after another in CSR
    order (bit for bit what ``index_add_`` over the row of each entry
    gave), on the card one block per row in a fixed tree, the same bits
    run after run (``index_add_`` there adds with float atomics, in an
    order that changes between runs).  The gather is ``index_select``: on
    the CPU it does not take the multi-threaded advanced-indexing path,
    100x slower there."""
    prod = A.vals.to(x.dtype) * torch.index_select(x, 0, A.cols.long())
    return torch.segment_reduce(prod, "sum", offsets=A.indptr, unsafe=True)


def csr_spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x (x: [n_cols]); launches ``csrc/csr_spmv.cu`` on a CUDA
    tensor, runs the twin on a CPU tensor."""
    if x.device.type == "cpu":
        return csr_spmv_twin(A, x)
    require_cuda_f32(vals=A.vals, x=x)
    require_cuda_i32(indptr=A.indptr, cols=A.cols, long_rows=A.long_rows)
    n_rows, n_cols = A.shape
    if x.shape != (n_cols,) or A.indptr.shape != (n_rows + 1,) or A.vals.shape != A.cols.shape:
        raise ValueError(
            f"CSR operator {A.shape} (indptr {tuple(A.indptr.shape)}, {A.nnz} entries) "
            f"and x {tuple(x.shape)} do not match"
        )
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    n_long = int(A.long_rows.shape[0])
    err = load_library().lib.csr_spmv(
        A.indptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_rows, A.long_rows.data_ptr() if n_long else None, n_long, LONG_ROW, stream_ptr(x),
    )
    check(err, "csr_spmv")
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
