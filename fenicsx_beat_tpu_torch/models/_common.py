"""What the port's ionic models share: their parameters as Python floats or
as node-aligned rows, and math that takes either.

A parameter vector becomes Python floats, so parameter-only terms are
computed once on the host, as the JAX kernels bake the vector in as
constants.  A node-aligned ``[NP, n]`` field (the per-node parameter form
of B1) becomes one row tensor per parameter, and the same formulas then run
node by node.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["unpack_params", "exp", "log", "sqrt", "floor", "maximum", "where_like"]


def unpack_params(parameters, like: torch.Tensor, names: list[str]) -> dict:
    """Parameter vector -> ``{name: Python float}``; node-aligned ``[NP, n]``
    field (numpy or torch) -> ``{name: row tensor}`` in ``like``'s dtype
    and device.  A vector tensor that requires grad (the differentiable
    solver's ``ionic`` parameters) -> ``{name: 0-d float64 tensor}`` on
    ``like``'s device, in the graph: a 0-d tensor takes part in type
    promotion as a Python float does, so the parameter-only terms are
    computed in float64 and the node terms in ``like``'s dtype, as on the
    float path."""
    if np.ndim(parameters) == 2:
        rows = torch.as_tensor(parameters).to(device=like.device, dtype=like.dtype)
        if rows.shape[0] != len(names):
            raise ValueError(f"the model takes {len(names)} parameter rows, got {rows.shape[0]}")
        return {name: rows[i] for i, name in enumerate(names)}
    if isinstance(parameters, torch.Tensor) and parameters.requires_grad:
        vals = parameters.reshape(-1).to(device=like.device, dtype=torch.float64)
        if vals.shape[0] != len(names):
            raise ValueError(f"the model takes {len(names)} parameters, got {vals.shape[0]}")
        return {name: vals[i] for i, name in enumerate(names)}
    if isinstance(parameters, torch.Tensor):
        parameters = parameters.detach().cpu().double().numpy()
    vals = np.asarray(parameters, dtype=np.float64).reshape(-1)
    if vals.shape[0] != len(names):
        raise ValueError(f"the model takes {len(names)} parameters, got {vals.shape[0]}")
    return {name: float(vals[i]) for i, name in enumerate(names)}


def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def exp(x):
    return torch.exp(x) if _is_t(x) else math.exp(x)


def log(x):
    return torch.log(x) if _is_t(x) else math.log(x)


def sqrt(x):
    return torch.sqrt(x) if _is_t(x) else math.sqrt(x)


def floor(x):
    return torch.floor(x) if _is_t(x) else math.floor(x)


def maximum(x, lo: float):
    return torch.clamp_min(x, lo) if _is_t(x) else max(x, lo)


def where_like(like: torch.Tensor):
    """``where`` over torch tensors and Python scalars: a Python-bool
    condition picks its branch; a tensor condition selects per node, a
    Python-scalar branch taking ``like``'s dtype (never the default one)."""

    def where(cond, a, b):
        if not _is_t(cond):
            return a if cond else b
        if not _is_t(a) and not _is_t(b):
            a = torch.full((), a, dtype=like.dtype, device=like.device)  # no host copy
        return torch.where(cond, a, b)

    return where
