"""Marker-partitioned ionic models composed into one step.

Port of ``make_multi_ode`` from ``fenicsx_beat_tpu/odesolver.py`` (the
``DolfinMultiODESolver`` semantics the fused solver needs): one model per
marker value, each stepping the nodes that carry its marker.  The rest of
that module (the OO ODE solvers) is not ported yet.

Each marker runs one step of a ported model
(:data:`~.ops.cuda_ode.IONIC_MODELS`: TP06, ToR-ORd dynCl, ToR-ORd dynCl +
Land, FitzHugh-Nagumo, or a model that ``odefile.load_ode`` generated); on
the card the markers of one model are that model's multi-marker ionic
kernel (B7, found through :func:`~.ops.cuda_ode.ionic_model`), and markers
that mix models run B7's mixed form, one launch per model
(:func:`~.ops.cuda_ode.mixed_multi_step`).  Other models raise
``NotImplementedError`` until they are ported (ROADMAP A4, A8).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .ops.cuda_ode import IonicModel, ionic_model

__all__ = ["make_multi_ode", "check_multi_models", "MarkerModels"]

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class MarkerModels:
    """The ported models of a dict ``ode_fun``, grouped by marker: one
    ``(model, markers)`` pair per model, in the order of its first marker."""

    groups: tuple[tuple[IonicModel, tuple], ...]

    @property
    def name(self) -> str:
        """Every model's name, ``+``-joined (``"tp06+torord_dyncl_land"``)."""
        return "+".join(spec.name for spec, _ in self.groups)


def check_multi_models(fun: dict) -> MarkerModels:
    """The ported model (:class:`~.ops.cuda_ode.IonicModel`) of each
    marker of ``fun``, grouped by model; raises ``NotImplementedError`` for
    a step that is not ported."""
    groups: list[tuple[IonicModel, list]] = []
    for marker in sorted(fun):
        spec = ionic_model(fun[marker])
        for g_spec, markers in groups:
            if g_spec is spec:
                markers.append(marker)
                break
        else:
            groups.append((spec, [marker]))
    return MarkerModels(tuple((spec, tuple(markers)) for spec, markers in groups))


def make_multi_ode(
    markers: np.ndarray,
    fun: dict[int, Callable],
    init_states: dict[int, np.ndarray],
    parameters: dict[int, np.ndarray | None],
    v_index: dict[int, int],
):
    """Compose marker-partitioned ionic models into one step.

    Every model steps the full node axis on a union state array
    ``[S_max, n]`` and a per-marker mask selects which nodes keep its
    result; nodes whose marker has no model keep their states.

    Returns ``(ode_fun, init_union [S_max, n], masks [nm, n] bool,
    v_index_common)`` where ``ode_fun(states, t, parameters, dt)`` takes the
    masks as its ``parameters`` argument; per-marker parameter vectors are
    bound into it.  Each model's rows are stored with its voltage swapped to
    row 0, so ``v_index_common`` is always 0.  ``ode_fun.multi`` carries the
    decomposition (``funs``, ``params``, ``sizes``, ``swaps``,
    ``trivial_swap``) in marker order, as the JAX package's does.  The
    composed step runs in the dtype of the states it is given.
    """
    check_multi_models(fun)
    marker_values = tuple(sorted(fun.keys()))
    for d, name in ((init_states, "init_states"), (parameters, "parameters"), (v_index, "v_index")):
        if set(d.keys()) != set(marker_values):
            raise ValueError(f"{name} keys {set(d.keys())} != fun keys {set(marker_values)}")

    markers = np.asarray(markers)
    n = markers.shape[0]
    masks = np.stack([markers == m for m in marker_values])
    sizes, swaps = {}, {}
    init_union = None
    for i, m in enumerate(marker_values):
        init_m = np.asarray(init_states[m], dtype=np.float64)
        S_m = init_m.shape[0]
        sizes[m] = S_m
        swap = np.arange(S_m)
        v_m = int(v_index[m])
        swap[[0, v_m]] = [v_m, 0]  # involution: storage <-> model layout
        swaps[m] = swap
        if init_union is None or S_m > init_union.shape[0]:
            grown = np.zeros((S_m, n))
            if init_union is not None:
                grown[: init_union.shape[0]] = init_union
            init_union = grown
        nodes = masks[i]
        if init_m.ndim == 1:
            init_union[:S_m, nodes] = init_m[swap][:, None]
        else:
            init_union[:S_m, nodes] = init_m[swap][:, nodes]
    S_max = init_union.shape[0]

    funs = [fun[m] for m in marker_values]
    params = [None if parameters[m] is None else np.asarray(parameters[m]) for m in marker_values]
    model_sizes = [sizes[m] for m in marker_values]
    model_swaps = [swaps[m] for m in marker_values]
    trivial_swap = [int(v_index[m]) == 0 for m in marker_values]

    if len(marker_values) > 4:
        logger.warning(
            "make_multi_ode with %d markers: the composed step runs every model "
            "over all nodes (%dx the single-model ionic work) on the plain path",
            len(marker_values),
            len(marker_values),
        )

    def ode_fun(states: torch.Tensor, t, parameters, dt) -> torch.Tensor:
        if not isinstance(parameters, torch.Tensor):
            parameters = torch.as_tensor(np.asarray(parameters))
        node_masks = parameters.to(device=states.device, dtype=torch.bool)
        out = states
        for i, (f, p, S_m) in enumerate(zip(funs, params, model_sizes)):
            s_model = states[:S_m]
            perm = torch.as_tensor(model_swaps[i], device=states.device)
            if not trivial_swap[i]:
                s_model = s_model[perm]
            y = f(s_model, t, p, dt)
            if not trivial_swap[i]:
                y = y[perm]
            if S_m < S_max:
                y = torch.cat([y, states[S_m:]], dim=0)
            out = torch.where(node_masks[i][None, :], y, out)
        return out

    ode_fun.multi = {
        "funs": funs,
        "params": params,
        "sizes": model_sizes,
        "swaps": model_swaps,
        "trivial_swap": trivial_swap,
    }
    return ode_fun, init_union, masks, 0
