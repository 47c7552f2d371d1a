"""Setup shared by the splitting solvers (:mod:`.fused`, :mod:`.bidomain`).

- :func:`check_ionic_scope`: the ported ionic model a solver's arguments
  run, refused before any assembly;
- :func:`ionic_layer`: which kernel of the model's entry in
  :data:`~.ops.cuda_ode.IONIC_MODELS` steps the states (B1 for one
  parameter vector, B1's per-node form for a node-aligned ``[NP, n]``
  field, B7 for marker layers: one launch per model, in its block-list
  form where the markers mix models, and B1's per-node form on the nodes
  of each marker that takes a field), or its twin.

The stimulus loads and the diffusion step are :mod:`.theta_system`'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .odesolver import MarkerModels, check_multi_models, make_multi_ode
from .ops import cuda_ode

__all__ = ["IonicLayer", "check_ionic_scope", "ionic_layer"]


def check_ionic_scope(ode_fun, ode_markers, init_states, parameters,
                      v_index) -> cuda_ode.IonicModel | MarkerModels:
    """The ported model a solver's ionic arguments run
    (:data:`~.ops.cuda_ode.IONIC_MODELS`), or, for a dict ``ode_fun``,
    its models grouped by marker (:class:`~.odesolver.MarkerModels`, whose
    ``name`` joins theirs); raises ``NotImplementedError`` for what is not
    ported and ``ValueError`` for arguments that do not fit the model.
    Needs no mesh, so a solver refuses before it assembles."""
    if isinstance(ode_fun, dict):
        models = check_multi_models(ode_fun)
        if ode_markers is None:
            raise ValueError("dict-valued ode_fun requires ode_markers")
        for name, value in (("init_states", init_states), ("parameters", parameters), ("v_index", v_index)):
            if not isinstance(value, dict):
                raise ValueError(f"a dict ode_fun takes {name} as a dict keyed by marker")
        if any(q is None or np.ndim(q) not in (1, 2) for q in parameters.values()):
            raise NotImplementedError(
                f"each marker's {models.name} model needs its parameter vector (B7's table) or a "
                "node-aligned parameter field (B1's per-node form)"
            )
        return models
    ionic = cuda_ode.ionic_model(ode_fun)
    if v_index != ionic.v_index:
        raise ValueError(f"{ionic.name} keeps V in row {ionic.v_index}, got v_index={v_index}")
    if parameters is None or np.ndim(parameters) not in (1, 2):
        raise NotImplementedError(f"{ionic.name} needs its parameter vector or a node-aligned parameter field")
    return ionic


@dataclass
class IonicLayer:
    """The ionic layer of a splitting solver: the initial states and their
    voltage row, and ``step(states, v, t, dt)``, which injects ``v`` and
    steps ``states`` in place through one kernel of the model's entry (or
    its twin).  For marker layers ``groups`` holds B7's launches, one
    :class:`~.ops.cuda_ode.MixedGroup` per model over the markers that take
    a parameter vector (its per-node index and parameter table on the
    device), and ``fields`` one :class:`~.ops.cuda_ode.FieldGroup` per
    marker that takes a field; marker layers keep their states in
    ``make_multi_ode``'s storage layout, V in row 0."""

    init_states: np.ndarray  # (S,) or (S, n)
    v_index: int
    step: Callable[[torch.Tensor, torch.Tensor, float, float], torch.Tensor]
    groups: list[cuda_ode.MixedGroup] | None = None
    fields: list[cuda_ode.FieldGroup] | None = None


def ionic_layer(ionic: cuda_ode.IonicModel | MarkerModels, ode_fun, ode_markers, init_states, parameters,
                v_index, n: int, device: torch.device, dtype: torch.dtype, use_kernels: bool) -> IonicLayer:
    """Build the :class:`IonicLayer` of arguments that
    :func:`check_ionic_scope` accepted, for ``n`` nodes.  A dict ``ode_fun``
    composes through :func:`~.odesolver.make_multi_ode` (the JAX solvers'
    contract, ``fenicsx_beat_tpu/fused.py:104-136``), whose masks become B7's
    per-node model index (one model) or B7's mixed form's groups
    (:func:`~.ops.cuda_ode.mixed_groups`); 2-D ``parameters`` take B1's
    per-node form, and so does a marker whose parameters are a field
    (:func:`~.ops.cuda_ode.field_step` on its nodes, after B7's launches;
    its nodes are in no B7 group, so B7 only injects V there)."""
    k = use_kernels
    if isinstance(ode_fun, dict):
        markers = ode_markers.x.array if hasattr(ode_markers, "x") else ode_markers
        markers = np.asarray(markers).astype(np.int64)
        if markers.shape[0] != n:
            raise ValueError(f"ode_markers has {markers.shape[0]} entries, expected {n}")
        multi_fun, init, masks, vi = make_multi_ode(markers, ode_fun, init_states, parameters, v_index)
        models = [cuda_ode.ionic_model(f) for f in multi_fun.multi["funs"]]
        params = multi_fun.multi["params"]
        by_field = [i for i, q in enumerate(params) if np.ndim(q) == 2]
        by_table = [i for i in range(len(params)) if i not in by_field]
        fields = [cuda_ode.field_group(masks[i], models[i], params[i], device, dtype) for i in by_field]
        groups = cuda_ode.mixed_groups(masks[by_table], [models[i] for i in by_table],
                                       [params[i] for i in by_table], device, dtype) if by_table else []
        free = None
        if not groups and not masks.any(axis=0).all():  # no B7 launch injects V at the nodes of no marker
            free = torch.as_tensor(np.flatnonzero(~masks.any(axis=0)), device=device)
        multi = cuda_ode.mixed_multi_step if k else cuda_ode.mixed_multi_step_twin

        def step(states, v, t, dt):
            if groups:
                multi(states, v, groups, t, dt)
            elif free is not None:
                states[0].index_copy_(0, free, v.index_select(0, free))
            for g in fields:
                cuda_ode.field_step(states, v, g, t, dt, k)
            return states

        return IonicLayer(init, vi, step, groups=groups, fields=fields)
    params = np.asarray(parameters, dtype=np.float64)
    if params.ndim == 2:
        if params.shape != (ionic.num_params, n):
            raise ValueError(
                f"node-aligned parameters of shape {params.shape}: {ionic.name} needs ({ionic.num_params}, {n})"
            )
        field = torch.as_tensor(params, device=device).to(dtype).contiguous()
        step = ionic.node_step if k else ionic.step_twin
        return IonicLayer(init_states, v_index, lambda states, v, t, dt: step(states, v, t, dt, field))
    step = ionic.step if k else ionic.step_twin
    return IonicLayer(init_states, v_index, lambda states, v, t, dt: step(states, v, t, dt, params))
