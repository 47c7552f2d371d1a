"""B1 and B7: the ionic steps of the splitting solvers -- one generalized
Rush-Larsen or forward-Euler step with the PDE voltage injected into row
V -- for TP06, ToR-ORd dynCl, ToR-ORd dynCl + Land and FitzHugh-Nagumo
(whose GRL step is forward Euler).

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

Markers that mix models run B7's mixed form, :func:`mixed_multi_step`:
one launch of each model's B7 kernel over the union ``[S_max, n]`` states,
on that model's own rows, its grid only the 256-node blocks that hold its
nodes (the JAX kernel's ``active[model, block]`` table as a compacted
grid, :func:`mixed_groups`); a node of another model (index
:data:`OTHER_MODEL`) is left untouched.  A marker whose parameters are a
node-aligned field steps its own nodes through B1's per-node form
(:func:`field_step`: a gather, the kernel, a scatter).

B1's forms inject V into the model's own voltage row
(:attr:`IonicModel.v_index`: 0 for TP06 and ToR-ORd, 1 for FHN).  B7 works
on ``make_multi_ode``'s storage layout, where every model's voltage is row
0 and its own row 0 sits in the voltage's row (the JAX kernel's ``swaps``),
so B7 injects into row 0.

All update a ``(S, n)`` state tensor in place: on a CUDA tensor they
launch the hand-written kernels (``csrc/tp06_grl{,_node,_multi}.cu``,
``csrc/torord_grl{,_node,_multi}.cu``, ``csrc/torord_land_grl{,_node,_multi}.cu``,
``csrc/fhn_{step,node,multi}.cu``; one copy of each model's formulas in
``csrc/tp06.cuh``, ``csrc/torord.cuh`` (with Land's ``csrc/torord_land.cuh``)
and ``csrc/fhn.cuh``); on a CPU tensor they run their plain PyTorch twins.
The ionic sources of TP06, ToR-ORd and Land are each built twice, as
``<model>_grl_*`` and, by ``csrc/<model>_fe*.cu``, as ``<model>_fe_*``: the
node body's compile-time scheme switch (``kFE``) turns its gate and
linear-state updates into forward Euler, whose twin is the model's
``forward_euler``.
The JAX kernels trace any jnp model.  Here the
models in :data:`IONIC_MODELS` have kernels, which :func:`ionic_model`
looks up by the model's step function, so the solvers pick kernels by
model: the three hand-written models by their ``generalized_rush_larsen``
and ``forward_euler``, FitzHugh-Nagumo by its one step, and every model that ``odefile.load_ode`` generates by both of its steps
(:func:`register_model`: GRL1 and forward Euler, the JAX kernel runs
either), whose kernels are the templates ``csrc/ode_{step,node,multi}.cu.in``
with the model's own node body, built at the first launch.  Any other model
raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import Callable

import numpy as np
import torch

from .._build import (
    check, load_library, load_model_library, model_symbol, require_cuda_f32, require_cuda_i32, stream_ptr,
)
from ..models import fitzhughnagumo as fhn
from ..models import tentusscher_panfilov_2006 as tp06
from ..models import torord_dyncl as torord
from ..models import torord_dyncl_land as land

__all__ = [
    "IonicModel",
    "IONIC_MODELS",
    "ionic_model",
    "register_model",
    "voltage_row",
    "model_index_from_masks",
    "OTHER_MODEL",
    "MixedGroup",
    "mixed_groups",
    "mixed_multi_step",
    "mixed_multi_step_twin",
    "FieldGroup",
    "field_group",
    "field_step",
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
    "torord_land_grl_step_v",
    "torord_land_grl_step_v_twin",
    "torord_land_grl_node_step_v",
    "torord_land_grl_multi_step_v",
    "torord_land_grl_multi_step_v_twin",
    "tp06_fe_step_v",
    "tp06_fe_step_v_twin",
    "tp06_fe_node_step_v",
    "tp06_fe_multi_step_v",
    "tp06_fe_multi_step_v_twin",
    "torord_fe_step_v",
    "torord_fe_step_v_twin",
    "torord_fe_node_step_v",
    "torord_fe_multi_step_v",
    "torord_fe_multi_step_v_twin",
    "torord_land_fe_step_v",
    "torord_land_fe_step_v_twin",
    "torord_land_fe_node_step_v",
    "torord_land_fe_multi_step_v",
    "torord_land_fe_multi_step_v_twin",
    "fhn_step_v",
    "fhn_step_v_twin",
    "fhn_node_step_v",
    "fhn_multi_step_v",
    "fhn_multi_step_v_twin",
]


# B7's model index of a node that another model's launch steps (the mixed
# form): left as it is, no V injected (fbt::kOtherModel, csrc/common.cuh)
OTHER_MODEL = -2
# nodes per block of B7's grid (fbt::kThreads, csrc/common.cuh)
BLOCK_NODES = 256


def voltage_row(model: ModuleType) -> int:
    """The row of ``model``'s states that holds the membrane voltage."""
    return model.state_index("V" if "V" in model._STATE_NAMES else "v")


def _time(t):
    return t if isinstance(t, torch.Tensor) else float(t)


def _b1_twin(model: ModuleType, fun: Callable | None = None) -> Callable:
    vi = voltage_row(model)
    fun = fun or model.generalized_rush_larsen

    def twin(states: torch.Tensor, v: torch.Tensor, t: float, dt: float, parameters) -> torch.Tensor:
        """Plain PyTorch twin of B1 and of its per-node form:
        ``states[V] = v`` (the model's voltage row), then one GRL step with
        the parameter vector or the ``[NP, n]`` field ``parameters``, in
        place.  ``t`` is a float, or a 0-d tensor on the states' device (a
        step captured in a CUDA graph)."""
        s = states.clone()
        s[vi] = v
        states.copy_(fun(s, _time(t), parameters, float(dt)))
        return states

    return twin


def _swap_rows(x: torch.Tensor, vi: int) -> torch.Tensor:
    """``x`` with rows 0 and ``vi`` exchanged (storage <-> model layout, an
    involution), by slices alone, so a CUDA graph can capture it."""
    return x if vi == 0 else torch.cat([x[vi : vi + 1], x[1:vi], x[:1], x[vi + 1 :]])


def _b7_twin(model: ModuleType, fun: Callable | None = None) -> Callable:
    vi = voltage_row(model)
    fun = fun or model.generalized_rush_larsen

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
            y = fun(s_model, _time(t), table[i], float(dt))
            out = torch.where(keep[None, :], _swap_rows(y, vi), out)
        states.copy_(out)
        return states

    return twin


def _twin_on_nodes(twin: Callable, states: torch.Tensor, v: torch.Tensor, index: torch.Tensor,
                   nodes: torch.Tensor, t: float, dt: float, table) -> None:
    """B7's twin on the columns ``nodes`` of ``states`` alone, in place: the
    mixed form's, whose other columns belong to other models' launches
    (index :data:`OTHER_MODEL`).  Each model's formulas then run on its
    own nodes only."""
    sub = states.index_select(1, nodes)
    twin(sub, v.index_select(0, nodes), index.index_select(0, nodes), t, dt, table)
    states.index_copy_(1, nodes, sub)


def _shape_error(what: str, model: ModuleType, **shapes) -> ValueError:
    got = ", ".join(f"{k} {tuple(s)}" for k, s in shapes.items())
    return ValueError(f"{got}: {what} ({len(model._STATE_NAMES)} states, "
                      f"{len(model._PARAM_NAMES)} parameters)")


def _b1(name: str, model: ModuleType, twin: Callable, library: Callable = load_library,
        symbol: str | None = None) -> Callable:
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
        err = getattr(library().lib, symbol or name)(
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


def _b1_node(name: str, model: ModuleType, twin: Callable, library: Callable = load_library,
             symbol: str | None = None) -> Callable:
    S, NP = len(model._STATE_NAMES), len(model._PARAM_NAMES)

    def step(states: torch.Tensor, v: torch.Tensor, t: float, dt: float, params: torch.Tensor) -> torch.Tensor:
        if states.device.type == "cpu":
            return twin(states, v, t, dt, params)
        require_cuda_f32(states=states, v=v, params=params)
        n = states.shape[1]
        if states.shape[0] != S or v.shape != (n,) or params.shape != (NP, n):
            raise _shape_error("need (S, n), (n,) and (NP, n)", model, states=states.shape, v=v.shape,
                               params=params.shape)
        err = getattr(library().lib, symbol or name)(
            states.data_ptr(), v.data_ptr(), params.data_ptr(), n, float(t), float(dt), stream_ptr(states),
        )
        check(err, name)
        step.launches += 1
        return states

    step.__doc__ = (f"B1's per-node form: one GRL step of ``states`` ({S}, n) in place, ``v`` (n,) "
                    f"replacing row {voltage_row(model)} first; node i reads parameter k from ``params[k, i]`` "
                    f"(a node-aligned ({NP}, n) field, float32 on the states' device).")
    return _named(step, name)


def _b7(name: str, model: ModuleType, twin: Callable, library: Callable = load_library,
        symbol: str | None = None) -> Callable:
    S, NP = len(model._STATE_NAMES), len(model._PARAM_NAMES)

    def step(states: torch.Tensor, v: torch.Tensor, index: torch.Tensor, t: float, dt: float,
             table: torch.Tensor, blocks: torch.Tensor | None = None) -> torch.Tensor:
        if states.device.type == "cpu":
            if blocks is None:
                return twin(states, v, index, t, dt, table)
            nodes = torch.nonzero(index != OTHER_MODEL).flatten()
            _twin_on_nodes(twin, states[:S], v, index, nodes, t, dt, table)
            return states
        require_cuda_f32(states=states, v=v, table=table)
        require_cuda_i32(index=index, **({} if blocks is None else {"blocks": blocks}))
        n = states.shape[1]
        rows_ok = states.shape[0] == S if blocks is None else states.shape[0] >= S
        if not rows_ok or v.shape != (n,) or index.shape != (n,):
            raise _shape_error("need (S, n) (S_max >= S rows in the mixed form), (n,) and (n,)", model,
                               states=states.shape, v=v.shape, index=index.shape)
        if table.dim() != 2 or table.shape[1] != NP or table.shape[0] < 1:
            raise _shape_error("need the (NM, NP) table", model, table=table.shape)
        if blocks is not None and (blocks.dim() != 1 or blocks.numel() < 1):
            raise ValueError(f"blocks {tuple(blocks.shape)}: need a non-empty list of block ids")
        err = getattr(library().lib, symbol or name)(
            states.data_ptr(), v.data_ptr(), index.data_ptr(), n, float(t), float(dt),
            table.data_ptr(), table.shape[0], None if blocks is None else blocks.data_ptr(),
            0 if blocks is None else blocks.numel(), stream_ptr(states),
        )
        check(err, name)
        step.launches += 1
        return states

    step.__doc__ = (f"B7: one multi-marker GRL step of ``states`` ({S}, n), in make_multi_ode's storage "
                    f"layout, in place: ``v`` (n,) replaces row 0 of every node first (``v`` may be that "
                    f"row itself); node k "
                    f"steps with parameter set ``table[index[k]]`` (``table`` is (NM, {NP})), or "
                    f"keeps its states when ``index[k]`` is outside [0, NM).  On the card "
                    f"``index`` is int32 and ``table`` float32, both on the states' device.  The mixed "
                    f"form (``blocks``, int32 block ids on the device): ``states`` is the union "
                    f"(S_max, n) of several models, of which this launch steps its {S} rows over the "
                    f"listed {BLOCK_NODES}-node blocks only, and a node of index ``OTHER_MODEL`` "
                    f"keeps its states without V.")
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

torord_land_grl_step_v_twin = _b1_twin(land)
torord_land_grl_multi_step_v_twin = _b7_twin(land)
torord_land_grl_step_v = _b1("torord_land_grl_step_v", land, torord_land_grl_step_v_twin)
torord_land_grl_node_step_v = _b1_node("torord_land_grl_node_step_v", land, torord_land_grl_step_v_twin)
torord_land_grl_multi_step_v = _b7("torord_land_grl_multi_step_v", land, torord_land_grl_multi_step_v_twin)

# forward Euler of the three hand-written models: the same sources' _fe_
# entries (the node bodies' compile-time scheme switch), the models'
# forward_euler as their twins
tp06_fe_step_v_twin = _b1_twin(tp06, tp06.forward_euler)
tp06_fe_multi_step_v_twin = _b7_twin(tp06, tp06.forward_euler)
tp06_fe_step_v = _b1("tp06_fe_step_v", tp06, tp06_fe_step_v_twin)
tp06_fe_node_step_v = _b1_node("tp06_fe_node_step_v", tp06, tp06_fe_step_v_twin)
tp06_fe_multi_step_v = _b7("tp06_fe_multi_step_v", tp06, tp06_fe_multi_step_v_twin)

torord_fe_step_v_twin = _b1_twin(torord, torord.forward_euler)
torord_fe_multi_step_v_twin = _b7_twin(torord, torord.forward_euler)
torord_fe_step_v = _b1("torord_fe_step_v", torord, torord_fe_step_v_twin)
torord_fe_node_step_v = _b1_node("torord_fe_node_step_v", torord, torord_fe_step_v_twin)
torord_fe_multi_step_v = _b7("torord_fe_multi_step_v", torord, torord_fe_multi_step_v_twin)

torord_land_fe_step_v_twin = _b1_twin(land, land.forward_euler)
torord_land_fe_multi_step_v_twin = _b7_twin(land, land.forward_euler)
torord_land_fe_step_v = _b1("torord_land_fe_step_v", land, torord_land_fe_step_v_twin)
torord_land_fe_node_step_v = _b1_node("torord_land_fe_node_step_v", land, torord_land_fe_step_v_twin)
torord_land_fe_multi_step_v = _b7("torord_land_fe_multi_step_v", land, torord_land_fe_multi_step_v_twin)

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
    def num_states(self) -> int:
        return len(self.module._STATE_NAMES)

    @property
    def num_params(self) -> int:
        return len(self.module._PARAM_NAMES)

    @property
    def v_index(self) -> int:
        """The model's voltage row, where B1's forms inject V."""
        return voltage_row(self.module)


IONIC_MODELS = {
    fun: m
    for fun, m in (
        (tp06.generalized_rush_larsen,
         IonicModel("tp06", tp06, tp06_grl_step_v, tp06_grl_node_step_v, tp06_grl_multi_step_v,
                    tp06_grl_step_v_twin, tp06_grl_multi_step_v_twin)),
        (torord.generalized_rush_larsen,
         IonicModel("torord_dyncl", torord, torord_grl_step_v, torord_grl_node_step_v,
                    torord_grl_multi_step_v, torord_grl_step_v_twin, torord_grl_multi_step_v_twin)),
        (land.generalized_rush_larsen,
         IonicModel("torord_dyncl_land", land, torord_land_grl_step_v, torord_land_grl_node_step_v,
                    torord_land_grl_multi_step_v, torord_land_grl_step_v_twin, torord_land_grl_multi_step_v_twin)),
        (tp06.forward_euler,
         IonicModel("tp06_fe", tp06, tp06_fe_step_v, tp06_fe_node_step_v, tp06_fe_multi_step_v,
                    tp06_fe_step_v_twin, tp06_fe_multi_step_v_twin)),
        (torord.forward_euler,
         IonicModel("torord_dyncl_fe", torord, torord_fe_step_v, torord_fe_node_step_v,
                    torord_fe_multi_step_v, torord_fe_step_v_twin, torord_fe_multi_step_v_twin)),
        (land.forward_euler,
         IonicModel("torord_dyncl_land_fe", land, torord_land_fe_step_v, torord_land_fe_node_step_v,
                    torord_land_fe_multi_step_v, torord_land_fe_step_v_twin, torord_land_fe_multi_step_v_twin)),
        (fhn.generalized_rush_larsen,
         IonicModel("fhn", fhn, fhn_step_v, fhn_node_step_v, fhn_multi_step_v, fhn_step_v_twin,
                    fhn_multi_step_v_twin)),
    )
}


def register_model(module: ModuleType, name: str) -> None:
    """Register a model that :func:`~..odefile.load_ode` generated: for its
    ``generalized_rush_larsen`` and its ``forward_euler``, an
    :class:`IonicModel` (``<name>_grl`` and ``<name>_fe``) whose three
    kernels launch the model's own library on the card
    (:func:`~.._build.load_model_library` of ``module.cuda_source``, built
    at the first launch) and run the module's steps as their twins on the
    CPU."""
    body = module.cuda_source
    sym = model_symbol(body)

    def library():
        return load_model_library(body)

    for scheme, fun in (("grl", module.generalized_rush_larsen), ("fe", module.forward_euler)):
        base = f"{name}_{scheme}"
        b1_twin, b7_twin = _b1_twin(module, fun), _b7_twin(module, fun)
        IONIC_MODELS[fun] = IonicModel(
            base, module,
            _b1(f"{base}_step_v", module, b1_twin, library, f"{sym}_{scheme}_step_v"),
            _b1_node(f"{base}_node_step_v", module, b1_twin, library, f"{sym}_{scheme}_node_step_v"),
            _b7(f"{base}_multi_step_v", module, b7_twin, library, f"{sym}_{scheme}_multi_step_v"),
            b1_twin, b7_twin,
        )


def ionic_model(fun: Callable) -> IonicModel:
    """The ported model whose ionic step is ``fun``;
    ``NotImplementedError`` for any other step."""
    try:
        return IONIC_MODELS[fun]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"{getattr(fun, '__module__', '?')}.{getattr(fun, '__name__', fun)}: the port's ionic "
            "kernels run the generalized Rush-Larsen or forward-Euler step of "
            + " or ".join(f"models.{m.__name__.rsplit('.', 1)[-1]}" for m in (tp06, torord, land, fhn))
            + " (FitzHugh-Nagumo's two are one), or either step of a model that odefile.load_ode "
            "generated; other models are not ported yet (ROADMAP A4, A8)"
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


@dataclass(frozen=True)
class MixedGroup:
    """One model's B7 launch: every marker that runs ``model``.  Beside
    other models it covers its own blocks of the union ``[S_max, n]``
    states (the block-list form); alone it covers every node (the plain
    form, ``blocks`` and ``nodes`` None)."""

    model: IonicModel
    index: torch.Tensor  # (n,) int32: the node's row of ``table``, -1 (no marker: V injected) or OTHER_MODEL
    table: torch.Tensor  # (NM_model, NP) parameter sets on the device, in the states' dtype
    table_host: np.ndarray  # the same values in float64 on the host (the twin's)
    blocks: torch.Tensor | None  # int32 ids of the BLOCK_NODES-node blocks that hold a node of this launch
    nodes: torch.Tensor | None  # int64 ids of those nodes (index != OTHER_MODEL), the twin's columns


def mixed_groups(masks: np.ndarray, models: list, params: list, device, dtype) -> list[MixedGroup]:
    """B7's launches for marker layers: ``masks`` [NM, n] as
    :func:`~..odesolver.make_multi_ode` builds them, ``models[i]`` the
    :class:`IonicModel` and ``params[i]`` the parameter vector of mask i.
    One group per model that selects a node, in the order of its first
    marker: each node goes to the model of the mask that selects it (the
    last one where masks overlap, :func:`model_index_from_masks`), so each
    node is stepped by one launch and the launches' order changes no
    result.  The first group's launch also injects V into the nodes of no
    marker.  With several groups each one's block list is the JAX kernel's
    ``active`` table row (``pallas_ode.py:375-383``) compacted; a single
    group runs B7's plain form over every node."""
    winner = model_index_from_masks(masks)
    n = winner.shape[0]
    order = []
    for i, spec in enumerate(models):
        if (winner == i).any() and all(spec is not o for o in order):
            order.append(spec)
    order = order or list(models[:1])  # no node has a model: one launch injects V
    groups = []
    for g, spec in enumerate(order):
        rows = [i for i, m in enumerate(models) if m is spec]
        index = np.full(n, OTHER_MODEL, dtype=np.int32)
        for local, i in enumerate(rows):
            index[winner == i] = local
        if g == 0:
            index[winner < 0] = -1
        table = torch.as_tensor(np.stack([np.asarray(params[i], dtype=np.float64) for i in rows]),
                                device=device).to(dtype)
        blocks = nodes = None
        if len(order) > 1:
            ids = np.nonzero(index != OTHER_MODEL)[0]
            blocks = torch.as_tensor(np.unique(ids // BLOCK_NODES).astype(np.int32), device=device)
            nodes = torch.as_tensor(ids, device=device)
        groups.append(MixedGroup(model=spec, index=torch.as_tensor(index, device=device), table=table,
                                 table_host=table.double().cpu().numpy(), blocks=blocks, nodes=nodes))
    return groups


@dataclass(frozen=True)
class FieldGroup:
    """One marker of a dict ``ode_fun`` whose parameters are a node-aligned
    ``[NP, n]`` field: B1's per-node form of its model steps that marker's
    nodes alone (:func:`field_step`), gathered from the union states into
    the model's own row order and scattered back, so no other node's
    states are read (the JAX composition's semantics)."""

    model: IonicModel
    nodes: torch.Tensor  # int64 ids of the marker's nodes, on the device
    field: torch.Tensor  # (NP, len(nodes)): the field's columns of those nodes, in the states' dtype


def field_group(mask: np.ndarray, model: IonicModel, field, device, dtype) -> FieldGroup:
    """The :class:`FieldGroup` of the marker whose nodes ``mask`` selects,
    from its model and its ``[NP, n]`` parameter field."""
    field = np.asarray(field, dtype=np.float64)
    if field.shape != (model.num_params, mask.shape[0]):
        raise ValueError(f"node-aligned parameters of shape {field.shape}: {model.name} needs "
                         f"({model.num_params}, {mask.shape[0]})")
    ids = np.flatnonzero(mask)
    return FieldGroup(model=model, nodes=torch.as_tensor(ids, device=device),
                      field=torch.as_tensor(np.ascontiguousarray(field[:, ids]), device=device).to(dtype))


def field_step(states: torch.Tensor, v: torch.Tensor, g: FieldGroup, t: float, dt: float,
               use_kernels: bool = True) -> torch.Tensor:
    """One step of a :class:`FieldGroup`'s nodes in the union states
    ``(S_max, n)`` of ``make_multi_ode``'s storage layout, in place: their
    columns of the model's rows gathered (rows 0 and V exchanged back to
    the model's order), B1's per-node form on them with ``v``'s entries
    injected (its twin with ``use_kernels=False``, and on the CPU), and
    the result scattered back.  Costs two extra passes over the marker's
    states (the gather and the scatter) beside the kernel's."""
    m, S, vi = g.model, g.model.num_states, g.model.v_index
    sub = _swap_rows(states[:S].index_select(1, g.nodes), vi).contiguous()
    (m.node_step if use_kernels else m.step_twin)(sub, v.index_select(0, g.nodes), t, dt, g.field)
    states[:S].index_copy_(1, g.nodes, _swap_rows(sub, vi))
    return states


def mixed_multi_step_twin(states: torch.Tensor, v: torch.Tensor, groups: list[MixedGroup], t: float,
                          dt: float) -> torch.Tensor:
    """Plain PyTorch twin of :func:`mixed_multi_step`: each group's B7 twin
    on its own nodes' columns of its own rows (a single group: on every
    node), group after group, in place (the kernels' semantics)."""
    for g in groups:
        if g.nodes is None:
            g.model.multi_step_twin(states, v, g.index, t, dt, g.table_host)
        else:
            _twin_on_nodes(g.model.multi_step_twin, states[: g.model.num_states], v, g.index, g.nodes, t, dt,
                           g.table_host)
    return states


def mixed_multi_step(states: torch.Tensor, v: torch.Tensor, groups: list[MixedGroup], t: float,
                     dt: float) -> torch.Tensor:
    """B7 over :func:`mixed_groups`: one step of the union states
    ``(S_max, n)`` in ``make_multi_ode``'s storage layout, in place, ``v``
    (n,) injected into row 0 (``v`` may be that row itself).  On the card,
    one launch of each group's B7 kernel (over its block list where
    models mix), counted on that model's ``multi_step.launches``; on the
    CPU, :func:`mixed_multi_step_twin`."""
    if states.device.type == "cpu":
        return mixed_multi_step_twin(states, v, groups, t, dt)
    for g in groups:
        g.model.multi_step(states, v, g.index, t, dt, g.table, blocks=g.blocks)
    return states
