"""The pieces of ``fenicsx_beat_tpu/base_model.py`` the fused solver needs:
the solve status, stimulus normalization and scalar-expression wrapping.
The object-oriented theta-rule model itself is not ported yet."""

from __future__ import annotations

from enum import Enum, auto

import numpy as np

from .stimulation import Measure, Stimulus

__all__ = ["Status"]


class Status(str, Enum):
    OK = auto()
    NOT_CONVERGING = auto()


def _transform_I_s(I_s, dZ: Measure) -> list[Stimulus]:
    """Normalize the stimulus argument to a list of Stimulus
    (mirrors reference ``base_model.py:33-45``)."""
    if I_s is None:
        return []
    if isinstance(I_s, Stimulus):
        return [I_s]
    if callable(I_s) or np.isscalar(I_s):
        return [Stimulus(expr=I_s, dZ=dZ)]
    return list(I_s)


def _as_expr(expr):
    """Wrap scalars as constant space-time callables."""
    if callable(expr):
        return expr
    val = float(expr)
    return lambda x, t: val * np.ones_like(x[0])
