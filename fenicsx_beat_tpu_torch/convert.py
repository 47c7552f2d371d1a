"""Carry the JAX package's operator tables and ionic states into the port.

The system has no weights: what crosses between the packages is the
assembled stencil operator (as its ``[n, K]`` table, or packed for the
JAX package's Pallas SpMVs) and the ``(num_states, n)`` state array, all
as numpy arrays (the JAX package keeps its assembly numpy-backed, so
``np.asarray(stencil.vals)`` is the table itself).  Checkpoints cross as
the npz that both fused solvers' ``save_state``/``load_state`` share.
The JAX package's sharded solvers stack their per-device operands along a
leading ``[n_devices]`` axis (and their padded states along the node axis);
:func:`rank_blocks` cuts one rank's block out of them, the layout of the
port's SPMD ranks (:mod:`.parallel`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.sparse import ELLMatrix, StencilMatrix

__all__ = ["stencil_from_numpy", "ell_from_numpy", "values_from_packed", "states_from_numpy", "rank_blocks"]


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


def ell_from_numpy(cols, vals, shape, tail_rows=None, tail_cols=None, tail_vals=None) -> ELLMatrix:
    """The port's host :class:`ELLMatrix` from an ELL operator's arrays
    (``[n, W]`` columns and values, the COO tail's three arrays or None),
    copied."""
    tail = None if tail_rows is None or np.asarray(tail_rows).size == 0 else (
        np.array(tail_rows, dtype=np.int32), np.array(tail_cols, dtype=np.int32), np.array(tail_vals))
    return ELLMatrix(cols=np.array(cols, dtype=np.int32), vals=np.array(vals), shape=tuple(int(d) for d in shape),
                     tail_rows=None if tail is None else tail[0], tail_cols=None if tail is None else tail[1],
                     tail_vals=None if tail is None else tail[2])


def rank_blocks(arrays: dict, rank: int, n_devices: int, node_axis: dict | None = None,
                device: torch.device | str = "cpu", dtype: torch.dtype | None = None) -> dict:
    """``rank``'s blocks of stacked per-device arrays (numpy): each array of
    ``arrays`` is cut along its device axis, the leading one (``[nd,
    n_local, W]`` values, columns, tails and masks), or for the names in
    ``node_axis`` along that axis split into ``n_devices`` equal blocks
    (``{"states": -1}`` for ``[S, n_pad]`` padded states).  Returns torch
    tensors on ``device``, floating ones in ``dtype`` when given, integer
    and boolean ones as they are."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        ax = (node_axis or {}).get(name)
        if ax is None:
            if a.shape[0] != n_devices:
                raise ValueError(f"{name}: leading axis {a.shape[0]} is not the {n_devices} devices")
            blk = a[rank]
        else:
            blk = np.split(a, n_devices, axis=ax)[rank]
        t = torch.tensor(np.ascontiguousarray(blk), device=device)
        out[name] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


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
