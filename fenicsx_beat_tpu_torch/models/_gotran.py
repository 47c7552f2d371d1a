"""What the torch modules that :mod:`..odefile` generates call at run time.

A generated model follows the hand-written models' parameter convention
(:func:`._common.unpack_params`): a parameter vector becomes Python floats,
so parameter-only terms are computed once on the host, and a node-aligned
``[NP, n]`` field becomes row tensors.  Every helper here therefore takes
Python floats and tensors alike.  On floats it follows IEEE arithmetic as
the JAX module's numpy scalars do (an overflow gives ``inf``, a log of a
negative number ``nan``) instead of raising as :mod:`math` would.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import unpack_params, where_like

__all__ = [
    "unpack_params", "where_like", "time_like", "rows", "exp", "expm1", "log", "sqrt", "floor", "fabs",
    "power", "land", "lor", "lnot", "grl",
]


def _is_t(x) -> bool:
    return isinstance(x, torch.Tensor)


def _host(fn, x) -> float:
    with np.errstate(all="ignore"):
        return float(fn(np.float64(x)))


def exp(x):
    return torch.exp(x) if _is_t(x) else _host(np.exp, x)


def expm1(x):
    return torch.expm1(x) if _is_t(x) else _host(np.expm1, x)


def log(x):
    return torch.log(x) if _is_t(x) else _host(np.log, x)


def sqrt(x):
    return torch.sqrt(x) if _is_t(x) else _host(np.sqrt, x)


def floor(x):
    return torch.floor(x) if _is_t(x) else _host(np.floor, x)


def fabs(x):
    return torch.abs(x) if _is_t(x) else abs(float(x))


def power(x, y):
    if _is_t(x) or _is_t(y):
        return torch.pow(x, y)
    with np.errstate(all="ignore"):
        return float(np.power(np.float64(x), np.float64(y)))


def time_like(t, states: torch.Tensor) -> torch.Tensor:
    """The model's time as a 0-d tensor in the states' dtype and on their
    device, so every term of ``t`` is computed, and compared with its
    window, in the working dtype as the kernels compute it.  A 0-d tensor
    (a step replayed in a CUDA graph) is used as it is."""
    if _is_t(t):
        return t.to(states.dtype)
    return torch.tensor(float(t), dtype=states.dtype, device=states.device)


def rows(values, states: torch.Tensor) -> torch.Tensor:
    """Stack one value per state row into ``states``' shape; a value that
    does not depend on the node (a float, a 0-d tensor) is broadcast."""
    like = states[0]
    return torch.stack([v if _is_t(v) and v.shape == like.shape
                        else torch.as_tensor(v, dtype=states.dtype, device=states.device).expand_as(like)
                        for v in values])


def land(*args):
    if not any(_is_t(a) for a in args):
        return all(bool(a) for a in args)
    out = args[0]
    for a in args[1:]:
        out = torch.logical_and(torch.as_tensor(out), torch.as_tensor(a))
    return out


def lor(*args):
    if not any(_is_t(a) for a in args):
        return any(bool(a) for a in args)
    out = args[0]
    for a in args[1:]:
        out = torch.logical_or(torch.as_tensor(out), torch.as_tensor(a))
    return out


def lnot(a):
    return torch.logical_not(a) if _is_t(a) else not a


def grl(x, d, lin, dt: float, eps: float, where):
    """One GRL1 update of a state ``x`` with derivative ``d`` and
    self-derivative ``lin``: ``x + expm1(dt lin) d / lin`` where
    ``|lin| > eps``, forward Euler elsewhere, with a safe divisor as the
    JAX module has it."""
    big = fabs(lin) > eps
    return where(big, x + expm1(dt * lin) * d / where(big, lin, 1.0), x + dt * d)
