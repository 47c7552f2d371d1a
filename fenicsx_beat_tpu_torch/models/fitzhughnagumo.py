"""Modified FitzHugh-Nagumo model (cardiac-scaled two-variable model), in torch.

Port of ``fenicsx_beat_tpu/models/fitzhughnagumo.py`` with the same
contract: ``init_state_values`` / ``init_parameter_values`` /
``state_index`` / ``parameter_index`` / ``rhs`` / ``forward_euler`` /
``generalized_rush_larsen`` over a ``(2, n_points)`` state tensor::

    dv/dt = I + i_app,   I = -s*(c2/v_amp)*(v - v_rest)
                             + (c1/v_amp^2)*(v - v_rest)*(v - v_th)*(v_peak - v)
    ds/dt = b*(v - v_rest - c3*s),      v_th = v_amp*a + v_rest

State layout: (s, v) -- the voltage is row 1.  The formulas are the JAX
package's, term for term and in its order; forward Euler is the plain twin
of the CUDA ionic kernels (``csrc/fhn_step.cu``, ``csrc/fhn_node.cu``,
``csrc/fhn_multi.cu``).  ``parameters`` is the 11-entry vector (Python
floats) or a node-aligned ``[11, n]`` field (:mod:`._common`).  The
applied current's window is strict at both ends, ``start < t < start +
duration``, and is compared in the states' dtype, as the JAX model traces
it and the kernels evaluate it.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import unpack_params, where_like

__all__ = [
    "init_state_values",
    "init_parameter_values",
    "state_index",
    "parameter_index",
    "rhs",
    "forward_euler",
    "generalized_rush_larsen",
]

_STATE_NAMES = ["s", "v"]
_PARAM_NAMES = [
    "c_1",
    "c_2",
    "c_3",
    "a",
    "b",
    "v_amp",
    "v_rest",
    "v_peak",
    "stim_amplitude",
    "stim_duration",
    "stim_start",
]

_DEFAULT_PARAMS = {
    "c_1": 0.26,
    "c_2": 0.1,
    "c_3": 1.0,
    "a": 0.13,
    "b": 0.013,
    "v_amp": 125.0,
    "v_rest": -85.0,
    "v_peak": 40.0,
    "stim_amplitude": 100.0,
    "stim_duration": 1.0,
    "stim_start": 0.0,
}

_DEFAULT_STATES = {"s": 0.0, "v": -85.0}


def state_index(name: str) -> int:
    return _STATE_NAMES.index(name)


def parameter_index(name: str) -> int:
    return _PARAM_NAMES.index(name)


def init_state_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_STATE_NAMES)
    if unknown:
        raise KeyError(f"Unknown state name(s): {sorted(unknown)}")
    vals = dict(_DEFAULT_STATES)
    vals.update(overrides)
    return np.array([vals[n] for n in _STATE_NAMES], dtype=np.float64)


def init_parameter_values(**overrides) -> np.ndarray:
    vals = dict(_DEFAULT_PARAMS)
    vals.update(overrides)
    return np.array([vals[n] for n in _PARAM_NAMES], dtype=np.float64)


def _applied_current(states: torch.Tensor, t, p: dict):
    """``stim_amplitude`` inside the open window (start, start + duration),
    else 0, with ``t`` and the window in the states' dtype."""
    if isinstance(p["stim_start"], torch.Tensor):  # a node-aligned field: rows in the states' dtype
        start, end = p["stim_start"], p["stim_start"] + p["stim_duration"]
    else:
        w = np.float32 if states.dtype == torch.float32 else np.float64
        start = w(p["stim_start"])
        end = start + w(p["stim_duration"])
    if not isinstance(t, torch.Tensor):
        t = (np.float32 if states.dtype == torch.float32 else np.float64)(t)
    return where_like(states)((t > start) & (t < end), p["stim_amplitude"], 0.0)


def rhs(states: torch.Tensor, t, parameters):
    """Right-hand side f(states, t) -> (ds/dt, dv/dt)."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    s, v = states[0], states[1]
    c1, c2, c3, a, b = p["c_1"], p["c_2"], p["c_3"], p["a"], p["b"]
    v_amp, v_rest, v_peak = p["v_amp"], p["v_rest"], p["v_peak"]
    i_app = _applied_current(states, t, p)
    v_th = v_amp * a + v_rest
    I = -s * (c2 / v_amp) * (v - v_rest) + ((c1 / v_amp**2) * (v - v_rest)) * (v - v_th) * (  # noqa: E741
        -v + v_peak
    )
    ds_dt = b * (-c3 * s + (v - v_rest))
    dv_dt = I + i_app
    return ds_dt, dv_dt


def forward_euler(states: torch.Tensor, t, parameters, dt, **kwargs) -> torch.Tensor:
    """Explicit Euler step over all points at once."""
    ds_dt, dv_dt = rhs(states, t, parameters)
    return torch.stack([states[0] + dt * ds_dt, states[1] + dt * dv_dt])


# FHN has no gating variables with closed-form quasi-steady states; the
# generalized Rush-Larsen scheme reduces to forward Euler here (the ionic
# kernels are looked up by this name, so either resolves to them).
generalized_rush_larsen = forward_euler
