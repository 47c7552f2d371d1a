"""Host-side 1-D node partitioning with planar halos.

Port of ``fenicsx_beat_tpu/parallel/partition.py``, numpy throughout (the
JAX module imports ``jax.numpy`` only for its return annotations).  The
structured slab generators order nodes lexicographically with x slowest
(:mod:`..mesh`), so a contiguous equal-size block partition along x gives
each rank a slab whose matrix rows only reference columns within a
bounded halo of its block; unstructured meshes reach the same shape after
an RCM renumbering (:mod:`.solver`).

``partition_ell`` turns a global ELL matrix into per-rank local blocks
with columns remapped into the rank's extended index space
``[0, n_loc + 2*halo)``:

    [ left-halo (H) | owned block (n_loc) | right-halo (H) ]

Every rank builds the same partition from the full mesh (the arrays are
deterministic host numpy, stacked ``[n_ranks, ...]`` as the JAX package
stacks them over its devices) and keeps its own block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.sparse import ELLMatrix, StencilMatrix

__all__ = [
    "Partition1D",
    "partition_nodes",
    "partition_ell",
    "partition_stencil",
    "partition_quadrature",
]


@dataclass(frozen=True)
class Partition1D:
    n_global: int  # true number of dofs
    n_devices: int
    n_local: int  # padded equal block size (n_pad = n_devices * n_local)
    halo: int  # uniform halo width

    @property
    def n_pad(self) -> int:
        return self.n_devices * self.n_local

    def real_rows(self, rank: int) -> int:
        """Rows of ``rank``'s block that hold real dofs (the rest pad)."""
        return int(np.clip(self.n_global - rank * self.n_local, 0, self.n_local))


def partition_nodes(n: int, n_devices: int) -> tuple[int, int]:
    """Equal padded block size."""
    n_local = -(-n // n_devices)
    return n_local, n_devices * n_local


def pad_global(x: np.ndarray, part: Partition1D, fill: float = 0.0) -> np.ndarray:
    """Pad the trailing (node) axis of a global array to n_pad."""
    pad = part.n_pad - x.shape[-1]
    if pad == 0:
        return x
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return np.pad(x, widths, constant_values=fill)


def partition_ell(A: ELLMatrix, n_devices: int) -> tuple[Partition1D, np.ndarray, np.ndarray, tuple | None]:
    """Split a global ELL matrix into stacked per-rank local blocks.

    Returns ``(partition, cols_local [nd, n_local, W] int32, vals [nd,
    n_local, W], tail)`` where ``tail`` is ``None`` or per-rank COO-tail
    arrays ``(rows [nd, nt] local-row int32, cols [nd, nt] extended-local-col
    int32, vals [nd, nt])`` covering the hybrid matrix's spilled
    high-degree entries (the welded LV apex), padded per rank with inert
    zero-value slots.  Padded rows are identity rows (value 1 at their own
    column).  Raises if any row reaches beyond its neighbours' blocks (the
    1-D partition assumption is violated: reorder nodes first, with RCM)."""
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    W = cols.shape[1]
    n_local, n_pad = partition_nodes(n, n_devices)

    pad = n_pad - n
    if pad:
        pad_cols = np.tile(np.arange(n, n_pad, dtype=cols.dtype)[:, None], (1, W))
        pad_vals = np.zeros((pad, W), dtype=vals.dtype)
        pad_vals[:, 0] = 1.0
        cols = np.concatenate([cols, pad_cols], axis=0)
        vals = np.concatenate([vals, pad_vals], axis=0)

    if A.has_tail:
        t_rows = np.asarray(A.tail_rows, dtype=np.int64)
        t_cols = np.asarray(A.tail_cols, dtype=np.int64)
        t_vals = np.asarray(A.tail_vals)
    else:
        t_rows = t_cols = np.zeros(0, dtype=np.int64)
        t_vals = np.zeros(0, dtype=vals.dtype)

    # required halo: the largest reach of any entry (main or tail) outside its row's block
    row_block = np.repeat(np.arange(n_pad) // n_local, W).reshape(n_pad, W)
    block_start = row_block * n_local
    reach_left = np.maximum(0, block_start - cols)
    reach_right = np.maximum(0, cols - (block_start + n_local - 1))
    halo = int(max(reach_left.max(), reach_right.max()))
    if t_rows.size:
        t_start = (t_rows // n_local) * n_local
        halo = max(
            halo,
            int(np.maximum(0, t_start - t_cols).max()),
            int(np.maximum(0, t_cols - (t_start + n_local - 1)).max()),
        )
    if halo > n_local:
        raise ValueError(
            f"halo {halo} exceeds local block {n_local}: too many devices for "
            "this mesh (or node ordering is not partition-friendly)"
        )

    part = Partition1D(n_global=n, n_devices=n_devices, n_local=n_local, halo=halo)

    cols_local = cols - block_start + halo
    cols3 = cols_local.reshape(n_devices, n_local, W).astype(np.int32)
    vals3 = vals.reshape(n_devices, n_local, W)

    tail3 = None
    if t_rows.size:
        dev = t_rows // n_local
        nt = int(np.bincount(dev, minlength=n_devices).max())
        # inert pad slots: value 0 at column 0 (any in-bounds extended index)
        tr3 = np.zeros((n_devices, nt), dtype=np.int32)
        tc3 = np.zeros((n_devices, nt), dtype=np.int32)
        tv3 = np.zeros((n_devices, nt), dtype=t_vals.dtype)
        for d in range(n_devices):
            sel = np.nonzero(dev == d)[0]
            k = sel.size
            tr3[d, :k] = (t_rows[sel] - d * n_local).astype(np.int32)
            tc3[d, :k] = (t_cols[sel] - d * n_local + halo).astype(np.int32)
            tv3[d, :k] = t_vals[sel]
        tail3 = (tr3, tc3, tv3)
    return part, cols3, vals3, tail3


def partition_stencil(A: StencilMatrix, n_devices: int, diag_pad: float = 0.0) -> tuple[Partition1D, np.ndarray]:
    """Split a global stencil matrix into per-rank local value blocks.

    Returns ``(partition, vals [nd, n_local, K])``; the halo equals the
    largest |offset|, so every shifted read lands inside the extended local
    vector ``[left-halo | owned | right-halo]``.  ``diag_pad`` is written
    at offset 0 for the padded rows."""
    n = A.shape[0]
    vals = np.asarray(A.vals)
    K = vals.shape[1]
    n_local, n_pad = partition_nodes(n, n_devices)
    halo = max(abs(int(d)) for d in A.offsets)
    if halo > n_local:
        raise ValueError(f"stencil halo {halo} exceeds local block {n_local}: too many devices for this mesh")
    pad = n_pad - n
    if pad:
        pad_vals = np.zeros((pad, K), dtype=vals.dtype)
        if diag_pad:
            pad_vals[:, tuple(A.offsets).index(0)] = diag_pad
        vals = np.concatenate([vals, pad_vals], axis=0)
    part = Partition1D(n_global=n, n_devices=n_devices, n_local=n_local, halo=halo)
    return part, vals.reshape(n_devices, n_local, K)


def partition_quadrature(quad, part: Partition1D, iperm: np.ndarray | None = None):
    """Per-rank quadrature tables for load assembly under the 1-D node
    partition (non-separable stimuli).

    Each rank receives the (padded) subset of elements that touch any of
    its owned rows, with dof slots masked by ownership so boundary elements
    shared by two ranks contribute each entry exactly once.  Returns
    ``(X [nd, ne, nq, g], W [nd, ne, nq], N [nq, nd], dofs_local [nd, ne,
    nd] int32, own [nd, ne, nd])``; pad elements replicate element 0 with
    zero weight."""
    X = np.asarray(quad.X)
    W = np.asarray(quad.W)
    N = np.asarray(quad.N)
    dofs = np.asarray(quad.dofs, dtype=np.int64)
    if iperm is not None:
        dofs = np.asarray(iperm, dtype=np.int64)[dofs]
    nd_, nl = part.n_devices, part.n_local
    dev_of = dofs // nl  # [ne, ndpc]

    selections = [np.nonzero((dev_of == d).any(axis=1))[0] for d in range(nd_)]
    ne_max = max(max((s.size for s in selections), default=0), 1)

    Xs = np.zeros((nd_, ne_max) + X.shape[1:], dtype=X.dtype)
    Ws = np.zeros((nd_, ne_max) + W.shape[1:], dtype=W.dtype)
    Ds = np.zeros((nd_, ne_max, dofs.shape[1]), dtype=np.int32)
    Os = np.zeros((nd_, ne_max, dofs.shape[1]), dtype=W.dtype)
    for d, sel in enumerate(selections):
        k = sel.size
        Xs[d] = X[0]
        if k == 0:
            continue
        Xs[d, :k] = X[sel]
        Ws[d, :k] = W[sel]
        own = dev_of[sel] == d
        Ds[d, :k] = np.where(own, dofs[sel] - d * nl, 0).astype(np.int32)
        Os[d, :k] = own
    return (Xs, Ws, N, Ds, Os)
