"""Per-rank CSR packing of the sharded solvers' unstructured local blocks.

Port of ``fenicsx_beat_tpu/parallel/lane.py``.  The sharded unstructured
SpMV applies each rank's local block, a rectangular ``[n_local, n_local +
2H]`` operator over the halo-extended index space, to the halo-extended
local vector.  The JAX package packs every device's block into its TPU
paged lane-gather format; on the H100 the device format is CSR
(:class:`~..ops.cuda_ell.CSRMatrix`, applied by B8, ``csrc/csr_spmv.cu``),
so each block is packed with its COO tail merged into its rows.  Value
stacks of one sparsity pattern (mass and stiffness) share one layout, so
the theta-system operators combine by value (:meth:`CSRMatrix.combine`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_ell import CSRMatrix, pack_csr
from .partition import Partition1D

__all__ = ["partition_lane_gather"]


def partition_lane_gather(part: Partition1D, cols3: np.ndarray, vals3_list: list[np.ndarray], tail3, dtype=None,
                          ranks=None):
    """Pack per-rank local ELL blocks (shared sparsity) into CSR.

    ``cols3``: ``[nd, n_local, W]`` extended-local columns;
    ``vals3_list``: k same-pattern value stacks ``[nd, n_local, W]``;
    ``tail3``: ``None`` or ``(tr3, tc3, tv3_0, tv3_1, ...)`` per-rank COO
    tails in the same extended-local space, merged into the rows;
    ``dtype``: the values' torch dtype (float64 when None); ``ranks``: the
    ranks to pack (every rank when None).

    Returns ``(blocks, diags, meta)``: ``blocks[rank]`` a tuple of k
    :class:`CSRMatrix` of shape ``(n_local, n_local + 2H)`` sharing one
    layout, host tensors (move them with :meth:`CSRMatrix.to`), each with
    its diagonal stream (the entries at column ``row + H``); ``diags`` k
    arrays ``[nd, n_local]`` of those diagonals; ``meta`` the extended
    width and the largest entry and tail counts."""
    nd, nl, W = cols3.shape
    n_ext = nl + 2 * part.halo
    nk = len(vals3_list)
    dtype = dtype or torch.float64
    rows = np.repeat(np.arange(nl, dtype=np.int64), W)
    rows_ext = (np.arange(nl) + part.halo)[:, None]

    diags = []
    for k in range(nk):
        dk = np.sum(np.where(np.asarray(cols3) == rows_ext[None], np.asarray(vals3_list[k]), 0.0), axis=2)
        if tail3 is not None:
            tr, tc, tv = np.asarray(tail3[0]), np.asarray(tail3[1]), np.asarray(tail3[2 + k])
            on = tc == tr + part.halo
            for d in range(nd):
                np.add.at(dk[d], tr[d][on[d]], tv[d][on[d]])
        diags.append(dk)

    blocks = {}
    nnz_max = 0
    for d in range(nd) if ranks is None else ranks:
        r_all = rows
        c_all = np.asarray(cols3[d], dtype=np.int64).reshape(-1)
        v_all = np.stack([np.asarray(v[d], dtype=np.float64).reshape(-1) for v in vals3_list])
        if tail3 is not None:
            r_all = np.concatenate([r_all, np.asarray(tail3[0][d], dtype=np.int64)])
            c_all = np.concatenate([c_all, np.asarray(tail3[1][d], dtype=np.int64)])
            tvs = np.stack([np.asarray(tail3[2 + k][d], dtype=np.float64) for k in range(nk)])
            v_all = np.concatenate([v_all, tvs], axis=1)
        indptr, ucols, pvals = pack_csr(r_all, c_all, v_all, (nl, n_ext))
        nnz_max = max(nnz_max, int(ucols.size))
        indptr_t = torch.from_numpy(indptr.astype(np.int32))
        cols_t = torch.from_numpy(ucols.astype(np.int32))
        blocks[d] = tuple(
            CSRMatrix(indptr=indptr_t, cols=cols_t, vals=torch.from_numpy(np.ascontiguousarray(pvals[k])).to(dtype),
                      shape=(nl, n_ext), diag=torch.from_numpy(diags[k][d]).to(dtype))
            for k in range(nk)
        )
    nt = 0 if tail3 is None else int(np.asarray(tail3[0]).shape[1])
    meta = {"n_ext": n_ext, "nnz_max": nnz_max, "tail_nnz_max": nt}
    return blocks, diags, meta
