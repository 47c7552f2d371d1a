"""B1 and B7: the ionic steps of the splitting solvers -- one generalized
Rush-Larsen step with the PDE voltage injected into row V -- for TP06,
ToR-ORd dynCl and FitzHugh-Nagumo (whose GRL step is forward Euler).

Each model has three forms, counterparts of
``fenicsx_beat_tpu/ops/pallas_ode.py``:

- B1, ``<model>_step_v``: ``build_pallas_ode_step`` in its ``v_index``
  form, one parameter vector for every node;
- B1's per-node form, ``<model>_node_step_v``: ``build_pallas_ode_step``
  with ``node_params``, a node-aligned ``[NP, n]`` parameter field;
- B7, ``<model>_multi_step_v``: ``build_pallas_multi_ode_step``, each
  node stepping with the parameter set of its model index (the transmural
  endo/mid/epi layers); a node with no model keeps its states with V
  injected.

B1's forms inject V into the model's own voltage row
(:attr:`IonicModel.v_index`: 0 for TP06 and ToR-ORd, 1 for FHN).  B7 works
on ``make_multi_ode``'s storage layout, where every model's voltage is row
0 and its own row 0 sits in the voltage's row (the JAX kernel's ``swaps``),
so B7 injects into row 0.

All update a ``(S, n)`` state tensor in place: on a CUDA tensor they
launch the hand-written kernels (``csrc/tp06_grl{,_node,_multi}.cu``,
``csrc/torord_grl{,_node,_multi}.cu``, ``csrc/fhn_{step,node,multi}.cu``;
one copy of each model's formulas in ``csrc/tp06.cuh``,
``csrc/torord.cuh`` and ``csrc/fhn.cuh``); on a CPU tensor they run their
plain PyTorch twins.  The JAX kernels trace any jnp model; these are
written for the models in :data:`IONIC_MODELS`, which :func:`ionic_model`
looks up by the model's ``generalized_rush_larsen`` step, so the solvers
pick kernels by model.  Any other model raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Callable

import numpy as np
import torch

from .._build import check, load_library, require_cuda_f32, require_cuda_i32, stream_ptr
from ..models import fitzhughnagumo as fhn
from ..models import tentusscher_panfilov_2006 as tp06
from ..models import torord_dyncl as torord

__all__ = [
    "IonicModel",
    "IONIC_MODELS",
    "ionic_model",
    "voltage_row",
    "model_index_from_masks",
    "tp06_grl_step_v",
    "tp06_grl_step_v_twin",
    "tp06_grl_node_step_v",
    "tp06_grl_multi_step_v",
    "tp06_grl_multi_step_v_twin",
    "torord_grl_step_v",
    "torord_grl_step_v_twin",
    "torord_grl_node_step_v",
    "torord_grl_multi_step_v",
    "torord_grl_multi_step_v_twin",
    "fhn_step_v",
    "fhn_step_v_twin",
    "fhn_node_step_v",
    "fhn_multi_step_v",
    "fhn_multi_step_v_twin",
]


def voltage_row(model: ModuleType) -> int:
    """The row of ``model``'s states that holds the membrane voltage."""
    return model.state_index("V" if "V" in model._STATE_NAMES else "v")


def _time(t):
    return t if isinstance(t, torch.Tensor) else float(t)


def _b1_twin(model: ModuleType) -> Callable:
    vi = voltage_row(model)

    def twin(states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters) -> torch.Tensor:
        """Plain PyTorch twin of B1 and of its per-node form:
        ``states[V] = v`` (the model's voltage row), then one GRL step with
        the parameter vector or the ``[NP, n]`` field ``parameters``, in
        place.  ``t`` is a float, or a 0-d tensor on the states' device (a
        step captured in a CUDA graph)."""
        s = states.clone()
        s[vi] = v
        states.copy_(model.generalized_rush_larsen(s, _time(t), parameters, float(dt)))
        return states

    return twin


def _swap_rows(x: torch.Tensor, vi: int) -> torch.Tensor:
    """``x`` with rows 0 and ``vi`` exchanged (storage <-> model layout, an
    involution), by slices alone, so a CUDA graph can capture it."""
    return x if vi == 0 else torch.cat([x[vi : vi + 1], x[1:vi], x[:1], x[vi + 1 :]])


def _b7_twin(model: ModuleType) -> Callable:
    vi = voltage_row(model)

    def twin(states: torch.Tensor, v: torch.Tensor, index: torch.Tensor, t: float, dt: float,
             table) -> torch.Tensor:
        """Plain PyTorch twin of B7 on ``make_multi_ode``'s storage layout:
        ``states[0] = v``; then the GRL step with every row of ``table``
        over all nodes, in the model's own row order, each kept where
        ``index`` selects it (the masked composition of ``make_multi_ode``),
        in place.  ``t`` as for B1's twin."""
        table = np.asarray(table.detach().cpu().double() if isinstance(table, torch.Tensor) else table)
        s = states.clone()
        s[0] = v
        s_model = _swap_rows(s, vi)
        out = s
        for i in range(table.shape[0]):
            keep = index == i
            y = model.generalized_rush_larsen(s_model, _time(t), table[i], float(dt))
            out = torch.where(keep[None, :], _swap_rows(y, vi), out)
        states.copy_(out)
        return states

    return twin


def _shape_error(what: str, model: ModuleType, **shapes) -> ValueError:
    got = ", ".join(f"{k} {tuple(s)}" for k, s in shapes.items())
    return ValueError(f"{got}: {what} ({len(model._STATE_NAMES)} states, "
                      f"{len(model._PARAM_NAMES)} parameters)")


def _b1(name: str, model: ModuleType, twin: Callable) -> Callable:
    S, NP = len(model._STATE_NAMES), len(model._PARAM_NAMES)

    def step(states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters) -> torch.Tensor:
        if states.device.type == "cpu":
            return twin(states, v, t, dt, parameters)
        require_cuda_f32(states=states, v=v)
        n = states.shape[1]
        if states.shape[0] != S or v.shape != (n,):
            raise _shape_error("need (S, n) and (n,)", model, states=states.shape, v=v.shape)
        params = np.ascontiguousarray(parameters, dtype=np.float32).reshape(-1)
        if params.shape[0] != NP:
            raise _shape_error("need the parameter vector", model, parameters=params.shape)
        err = getattr(load_library().lib, name)(
            states.data_ptr(), v.data_ptr(), n, float(t), float(dt), params.ctypes.data, stream_ptr(states),
        )
        check(err, name)
        step.launches += 1
        return states

    step.__doc__ = (f"B1: one {model.__name__.rsplit('.', 1)[-1]} GRL step of ``states`` ({S}, n) in "
                    f"place, with ``v`` (n,) replacing row {voltage_row(model)} first (``v`` may be that "
                    f"row itself); "
                    f"``parameters`` is the {NP}-entry host parameter vector.")
    return _named(step, name)


def _b1_node(name: str, model: ModuleType, twin: Callable) -> Callable:
    S, NP = len(model._STATE_NAMES), len(model._PARAM_NAMES)

    def step(states: torch.Tensor, v: torch.Tensor, t: float, dt: float, params: torch.Tensor) -> torch.Tensor:
        if states.device.type == "cpu":
            return twin(states, v, t, dt, params)
        require_cuda_f32(states=states, v=v, params=params)
        n = states.shape[1]
        if states.shape[0] != S or v.shape != (n,) or params.shape != (NP, n):
            raise _shape_error("need (S, n), (n,) and (NP, n)", model, states=states.shape, v=v.shape,
                               params=params.shape)
        err = getattr(load_library().lib, name)(
            states.data_ptr(), v.data_ptr(), params.data_ptr(), n, float(t), float(dt), stream_ptr(states),
        )
        check(err, name)
        step.launches += 1
        return states

    step.__doc__ = (f"B1's per-node form: one GRL step of ``states`` ({S}, n) in place, ``v`` (n,) "
                    f"replacing row {voltage_row(model)} first; node i reads parameter k from ``params[k, i]`` "
                    f"(a node-aligned ({NP}, n) field, float32 on the states' device).")
    return _named(step, name)


def _b7(name: str, model: ModuleType, twin: Callable) -> Callable:
    S, NP = len(model._STATE_NAMES), len(model._PARAM_NAMES)

    def step(states: torch.Tensor, v: torch.Tensor, index: torch.Tensor, t: float, dt: float,
             table: torch.Tensor) -> torch.Tensor:
        if states.device.type == "cpu":
            return twin(states, v, index, t, dt, table)
        require_cuda_f32(states=states, v=v, table=table)
        require_cuda_i32(index=index)
        n = states.shape[1]
        if states.shape[0] != S or v.shape != (n,) or index.shape != (n,):
            raise _shape_error("need (S, n), (n,) and (n,)", model, states=states.shape, v=v.shape,
                               index=index.shape)
        if table.dim() != 2 or table.shape[1] != NP or table.shape[0] < 1:
            raise _shape_error("need the (NM, NP) table", model, table=table.shape)
        err = getattr(load_library().lib, name)(
            states.data_ptr(), v.data_ptr(), index.data_ptr(), n, float(t), float(dt),
            table.data_ptr(), table.shape[0], stream_ptr(states),
        )
        check(err, name)
        step.launches += 1
        return states

    step.__doc__ = (f"B7: one multi-marker GRL step of ``states`` ({S}, n), in make_multi_ode's storage "
                    f"layout, in place: ``v`` (n,) replaces row 0 of every node first (``v`` may be that "
                    f"row itself); node k "
                    f"steps with parameter set ``table[index[k]]`` (``table`` is (NM, {NP})), or "
                    f"keeps its states when ``index[k]`` is outside [0, NM).  On the card "
                    f"``index`` is int32 and ``table`` float32, both on the states' device.")
    return _named(step, name)


def _named(step: Callable, name: str) -> Callable:
    step.__name__ = step.__qualname__ = name
    step.launches = 0  # kernel launches; the CPU twin does not count
    return step


tp06_grl_step_v_twin = _b1_twin(tp06)
tp06_grl_multi_step_v_twin = _b7_twin(tp06)
tp06_grl_step_v = _b1("tp06_grl_step_v", tp06, tp06_grl_step_v_twin)
tp06_grl_node_step_v = _b1_node("tp06_grl_node_step_v", tp06, tp06_grl_step_v_twin)
tp06_grl_multi_step_v = _b7("tp06_grl_multi_step_v", tp06, tp06_grl_multi_step_v_twin)

torord_grl_step_v_twin = _b1_twin(torord)
torord_grl_multi_step_v_twin = _b7_twin(torord)
torord_grl_step_v = _b1("torord_grl_step_v", torord, torord_grl_step_v_twin)
torord_grl_node_step_v = _b1_node("torord_grl_node_step_v", torord, torord_grl_step_v_twin)
torord_grl_multi_step_v = _b7("torord_grl_multi_step_v", torord, torord_grl_multi_step_v_twin)

fhn_step_v_twin = _b1_twin(fhn)
fhn_multi_step_v_twin = _b7_twin(fhn)
fhn_step_v = _b1("fhn_step_v", fhn, fhn_step_v_twin)
fhn_node_step_v = _b1_node("fhn_node_step_v", fhn, fhn_step_v_twin)
fhn_multi_step_v = _b7("fhn_multi_step_v", fhn, fhn_multi_step_v_twin)


@dataclass(frozen=True)
class IonicModel:
    """A ported ionic model and its kernels, each beside its twin (the
    per-node form shares B1's twin, which takes a vector or a field)."""

    name: str
    module: ModuleType
    step: Callable  # B1
    node_step: Callable  # B1, per-node parameters
    multi_step: Callable  # B7
    step_twin: Callable
    multi_step_twin: Callable

    @property
    def num_params(self) -> int:
        return len(self.module._PARAM_NAMES)

    @property
    def v_index(self) -> int:
        """The model's voltage row, where B1's forms inject V."""
        return voltage_row(self.module)


IONIC_MODELS = {
    m.module.generalized_rush_larsen: m
    for m in (
        IonicModel("tp06", tp06, tp06_grl_step_v, tp06_grl_node_step_v, tp06_grl_multi_step_v,
                   tp06_grl_step_v_twin, tp06_grl_multi_step_v_twin),
        IonicModel("torord_dyncl", torord, torord_grl_step_v, torord_grl_node_step_v,
                   torord_grl_multi_step_v, torord_grl_step_v_twin, torord_grl_multi_step_v_twin),
        IonicModel("fhn", fhn, fhn_step_v, fhn_node_step_v, fhn_multi_step_v, fhn_step_v_twin,
                   fhn_multi_step_v_twin),
    )
}


def ionic_model(fun: Callable) -> IonicModel:
    """The ported model whose generalized Rush-Larsen step is ``fun``;
    ``NotImplementedError`` for any other step."""
    try:
        return IONIC_MODELS[fun]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"{getattr(fun, '__module__', '?')}.{getattr(fun, '__name__', fun)}: the port's ionic "
            "kernels run the generalized Rush-Larsen step of "
            + " or ".join(f"models.{m.module.__name__.rsplit('.', 1)[-1]}" for m in IONIC_MODELS.values())
            + " (forward_euler is FitzHugh-Nagumo's); other models are not ported yet (ROADMAP A4, A8)"
        ) from None


def model_index_from_masks(masks: np.ndarray) -> np.ndarray:
    """B7's per-node model index from ``[NM, n]`` 0/1 masks (one row per
    model, as :func:`~..odesolver.make_multi_ode` builds them): the mask
    row that selects the node, -1 where none does.  Where masks overlap the
    last one wins, as the JAX kernel overlays them in order."""
    masks = np.asarray(masks, dtype=bool)
    nm = masks.shape[0]
    last = nm - 1 - np.argmax(masks[::-1], axis=0)
    return np.where(masks.any(axis=0), last, -1).astype(np.int32)
