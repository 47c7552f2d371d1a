"""B1 and B7: the ionic steps of the fused solver — TP06 generalized
Rush-Larsen with the PDE voltage injected into row V.

B1, :func:`tp06_grl_step_v`, is the counterpart of
``fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step`` (its
``v_index`` form): one parameter set for every node.  B7,
:func:`tp06_grl_multi_step_v`, is the counterpart of
``build_pallas_multi_ode_step``: each node steps with the parameter set of
its model index (the transmural endo/mid/epi layers), a node with no model
keeps its states with V injected.

Both update a ``(19, n)`` state tensor in place: on a CUDA tensor they
launch the hand-written kernels ``csrc/tp06_grl.cu`` and
``csrc/tp06_grl_multi.cu`` (one copy of the formulas, ``csrc/tp06.cuh``);
on a CPU tensor they run their plain PyTorch twins.  The JAX kernels trace
any jnp model; these are written for TP06 alone, so the solver accepts no
other model on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import check, load_library, require_cuda_f32, require_cuda_i32, stream_ptr
from ..models import tentusscher_panfilov_2006 as tp06

__all__ = [
    "tp06_grl_step_v",
    "tp06_grl_step_v_twin",
    "tp06_grl_multi_step_v",
    "tp06_grl_multi_step_v_twin",
    "model_index_from_masks",
]

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


def model_index_from_masks(masks: np.ndarray) -> np.ndarray:
    """B7's per-node model index from ``[NM, n]`` 0/1 masks (one row per
    model, as :func:`~..odesolver.make_multi_ode` builds them): the mask
    row that selects the node, -1 where none does.  Where masks overlap the
    last one wins, as the JAX kernel overlays them in order."""
    masks = np.asarray(masks, dtype=bool)
    nm = masks.shape[0]
    last = nm - 1 - np.argmax(masks[::-1], axis=0)
    return np.where(masks.any(axis=0), last, -1).astype(np.int32)


def tp06_grl_multi_step_v_twin(
    states: torch.Tensor, v: torch.Tensor, model: torch.Tensor, t: float, dt: float, table
) -> torch.Tensor:
    """Plain PyTorch twin of B7: ``states[V] = v``; then every model's GRL
    step over all nodes, each kept where ``model`` selects it (the masked
    composition of ``make_multi_ode``), in place."""
    table = np.asarray(table.detach().cpu().double() if isinstance(table, torch.Tensor) else table)
    s = states.clone()
    s[V_INDEX] = v
    out = s
    for i in range(table.shape[0]):
        keep = model == i
        out = torch.where(keep[None, :], tp06.generalized_rush_larsen(s, float(t), table[i], float(dt)), out)
    states.copy_(out)
    return states


def tp06_grl_multi_step_v(
    states: torch.Tensor, v: torch.Tensor, model: torch.Tensor, t: float, dt: float, table
) -> torch.Tensor:
    """One multi-marker TP06 GRL step of ``states`` (19, n) in place:
    ``v`` (n,) replaces row V of every node first (``v`` may be that row
    itself); node k steps with parameter set ``table[model[k]]`` (``table``
    is ``[NM, 54]``), or keeps its states when ``model[k]`` is outside
    ``[0, NM)``.  On the card ``model`` is int32 and ``table`` float32, both
    on the states' device."""
    if states.device.type == "cpu":
        return tp06_grl_multi_step_v_twin(states, v, model, t, dt, table)
    require_cuda_f32(states=states, v=v, table=table)
    require_cuda_i32(model=model)
    S, n = states.shape
    if S != len(tp06._STATE_NAMES) or v.shape != (n,) or model.shape != (n,):
        raise ValueError(
            f"states {tuple(states.shape)}, v {tuple(v.shape)}, model {tuple(model.shape)}: "
            "need (19, n), (n,) and (n,)"
        )
    if table.dim() != 2 or table.shape[1] != len(tp06._PARAM_NAMES) or table.shape[0] < 1:
        raise ValueError(f"table {tuple(table.shape)}: need (NM, {len(tp06._PARAM_NAMES)})")
    err = load_library().lib.tp06_grl_multi_step_v(
        states.data_ptr(), v.data_ptr(), model.data_ptr(), n, float(t), float(dt),
        table.data_ptr(), table.shape[0], stream_ptr(states),
    )
    check(err, "tp06_grl_multi_step_v")
    tp06_grl_multi_step_v.launches += 1
    return states


tp06_grl_multi_step_v.launches = 0
