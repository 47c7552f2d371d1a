"""Fixed-offset (stencil) sparse operators in torch.

Port of ``StencilMatrix`` from ``fenicsx_beat_tpu/ops/sparse.py``: on
lexicographically ordered structured meshes the P1 operator couples row
``r`` to columns ``r + offsets[k]`` with one global offset set (15 offsets
for the Kuhn-tet slab), so ``A @ x`` is K shifted multiply-adds.  Mass and
stiffness share the offset set, so the theta-system operator is a
value-level combination (:meth:`StencilMatrix.combine`).

The symmetric-stencil helpers at the bottom feed the fused solver's
kernel path (:mod:`.cuda_spmv`): a symmetric operator needs only its
``d >= 0`` value columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

__all__ = ["StencilMatrix", "stencil_is_symmetric", "pack_sym_values"]


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


def pack_sym_values(A: StencilMatrix) -> tuple[tuple[int, ...], torch.Tensor]:
    """The ``d >= 0`` offsets of a symmetric stencil and their value
    columns as one contiguous ``[Kp, n]`` tensor (row k holds offset
    ``pos[k]``), the layout the symmetric SpMV streams."""
    pos = tuple(d for d in A.offsets if d >= 0)
    cols = [A.offsets.index(d) for d in pos]
    return pos, A.vals[:, cols].T.contiguous()
