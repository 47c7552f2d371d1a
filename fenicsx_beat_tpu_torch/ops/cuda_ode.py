"""B1: the ionic step of the fused solver — TP06 generalized Rush-Larsen
with the PDE voltage injected into row V.

Counterpart of ``fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step``
(its ``v_index`` form).  :func:`tp06_grl_step_v` updates a ``(19, n)``
state tensor in place: on a CUDA tensor it launches the hand-written
kernel ``csrc/tp06_grl.cu``; on a CPU tensor it runs the plain PyTorch
twin :func:`tp06_grl_step_v_twin`.  The JAX kernel traces any jnp model;
this one is written for TP06 alone, so the solver accepts no other model
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import check, load_library, require_cuda_f32, stream_ptr
from ..models import tentusscher_panfilov_2006 as tp06

__all__ = ["tp06_grl_step_v", "tp06_grl_step_v_twin"]

V_INDEX = tp06.state_index("V")


def tp06_grl_step_v_twin(
    states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters
) -> torch.Tensor:
    """Plain PyTorch twin: ``states[V] = v``, then one GRL step, in place."""
    s = states.clone()
    s[V_INDEX] = v
    states.copy_(tp06.generalized_rush_larsen(s, float(t), parameters, float(dt)))
    return states


def tp06_grl_step_v(
    states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters
) -> torch.Tensor:
    """One TP06 GRL step of ``states`` (19, n) in place, with ``v`` (n,)
    replacing row V first (``v`` may be that row itself).  ``parameters``
    is the 54-entry host parameter vector."""
    if states.device.type == "cpu":
        return tp06_grl_step_v_twin(states, v, t, dt, parameters)
    require_cuda_f32(states=states, v=v)
    S, n = states.shape
    if S != len(tp06._STATE_NAMES) or v.shape != (n,):
        raise ValueError(f"states {tuple(states.shape)} and v {tuple(v.shape)}: need (19, n) and (n,)")
    params = np.ascontiguousarray(parameters, dtype=np.float32).reshape(-1)
    if params.shape[0] != len(tp06._PARAM_NAMES):
        raise ValueError(f"TP06 takes {len(tp06._PARAM_NAMES)} parameters, got {params.shape[0]}")
    err = load_library().lib.tp06_grl_step_v(
        states.data_ptr(), v.data_ptr(), n, float(t), float(dt),
        params.ctypes.data, stream_ptr(states),
    )
    check(err, "tp06_grl_step_v")
    tp06_grl_step_v.launches += 1
    return states


tp06_grl_step_v.launches = 0
