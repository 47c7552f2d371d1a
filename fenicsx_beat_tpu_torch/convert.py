"""Carry the JAX package's operator tables and ionic states into the port.

The system has no weights: what crosses between the packages is the
assembled stencil operator (as its ``[n, K]`` table, or packed for the
JAX package's Pallas SpMVs) and the ``(num_states, n)`` state array, all
as numpy arrays (the JAX package keeps its assembly numpy-backed, so
``np.asarray(stencil.vals)`` is the table itself).  Checkpoints cross as
the npz that both fused solvers' ``save_state``/``load_state`` share.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.sparse import StencilMatrix

__all__ = ["stencil_from_numpy", "values_from_packed", "states_from_numpy"]


def stencil_from_numpy(
    offsets: Sequence[int],
    vals: np.ndarray,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float64,
) -> StencilMatrix:
    """The port's :class:`StencilMatrix` from an ``(offsets, [n, K] values)``
    stencil table."""
    vals = np.asarray(vals)
    if vals.ndim != 2 or vals.shape[1] != len(offsets):
        raise ValueError(
            f"stencil values of shape {vals.shape} do not match {len(offsets)} offsets"
        )
    n = vals.shape[0]
    t = torch.tensor(vals, dtype=dtype, device=device)  # a copy: never aliases the caller's array
    return StencilMatrix(offsets=tuple(int(d) for d in offsets), vals=t, shape=(n, n))


def values_from_packed(
    vals3: np.ndarray,
    n: int,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """The port's ``[K, n]`` value table (:func:`~.ops.sparse.pack_values`)
    from the JAX package's packed ``[K, R_pad, 128]`` stencil values (the
    ``pack_values`` of its Pallas stencil SpMVs): the lane padding cut off."""
    vals3 = np.asarray(vals3)
    if vals3.ndim != 3 or vals3.shape[1] * vals3.shape[2] < n:
        raise ValueError(f"packed values of shape {vals3.shape} do not hold {n} rows")
    flat = vals3.reshape(vals3.shape[0], -1)[:, :n]
    return torch.tensor(flat, dtype=dtype, device=device).contiguous()


def states_from_numpy(
    states: np.ndarray,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float64,
) -> torch.Tensor:
    """A contiguous ``(num_states, n)`` state tensor from a numpy array."""
    states = np.asarray(states)
    if states.ndim != 2:
        raise ValueError(f"states must be (num_states, n), got shape {states.shape}")
    # a copy: the solvers update states in place, never the caller's array
    return torch.tensor(states, dtype=dtype, device=device).contiguous()
