"""Cellwise ionic ODE stepping, PDE<->ODE transfer adapters, and
marker-partitioned models composed into one step.

Port of ``fenicsx_beat_tpu/odesolver.py`` (the reference's
``src/beat/odesolver.py``).  The contract is the JAX package's: a user
stepper ``fun(states, t, parameters, dt) -> new_states`` over an ``(S, n)``
state array, and adapters that move the voltage row between the state
array and the ODE-space function, and between the ODE and PDE spaces
(``to_dolfin`` / ``from_dolfin`` / ``ode_to_pde`` / ``pde_to_ode``; the
ODE may live on any space, its points a Lagrange space's dofs or a
Quadrature space's points, and a transfer between spaces of different
sizes is one B8 product on the solver's device).

The states are a torch tensor on the solver's device (the card unless the
CPU is named), updated in place; the functions keep their values in host
numpy arrays, as in the JAX package, so ``to_dolfin`` and ``from_dolfin``
move the voltage row across (one crossing each, counted in
``host_transfers``).  A ``fun`` of a ported model
(:func:`~.ops.cuda_ode.ionic_model`: TP06, ToR-ORd dynCl, ToR-ORd dynCl +
Land, FitzHugh-Nagumo, or a model ``odefile.load_ode`` generated) steps
through that model's B1 kernel on a CUDA tensor (its per-node form for a
node-aligned ``[NP, n]`` parameter field) and its twin on the CPU, the
voltage row passed as itself; any other callable runs as given, on the
torch tensor (on the CPU a numpy stepper works too).
:class:`DolfinMultiODESolver` keeps one ``[S_m, n_m]`` tensor per marker
and steps each with one launch.

:func:`make_multi_ode` composes the markers into one step for the fused
and bidomain solvers instead (one union ``[S_max, n]`` state array); on
the card its models run B7 (:func:`~.ops.cuda_ode.mixed_multi_step`).
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import fem
from .config import default_dtype, resolve_device
from .ops.cuda_ode import IONIC_MODELS, IonicModel, ionic_model
from .telemetry import BaseMonitor, NullMonitor

__all__ = [
    "ODEResults",
    "solve",
    "ODESystemSolver",
    "BaseDolfinODESolver",
    "DolfinODESolver",
    "DolfinMultiODESolver",
    "make_multi_ode",
    "check_multi_models",
    "MarkerModels",
]

EPS = 1e-12
logger = logging.getLogger(__name__)


class ODEResults(NamedTuple):
    y: np.ndarray
    t: np.ndarray


def solve(
    fun,
    t_bound: float,
    states,
    V,
    V_index: int,
    dt: float,
    parameters,
    t0: float = 0.0,
    extra: dict | None = None,
):
    """Step ``fun`` in place from ``t0`` until ``t_bound``, recording the
    voltage row into successive rows of ``V`` after each step (reference
    ``odesolver.py:24-43``; a step is taken only while the *next* time
    still lies strictly inside the horizon)."""
    kwargs = dict(extra) if extra else {}
    t, row = t0, 0
    while t + dt < t_bound:
        fun(states=states, t=t, parameters=parameters, dt=dt, **kwargs)
        V[row, :] = states[V_index, :]
        row += 1
        t += dt


def _state_tensor(states, device, dtype) -> torch.Tensor:
    """The ``[S, n]`` working tensor: a tensor as it is; a numpy array on
    ``device`` (the card when None) in ``dtype`` (its working dtype when
    None), sharing the array's memory where it can (a float64 array on the
    CPU: the caller's views stay live, as in the JAX package)."""
    if isinstance(states, torch.Tensor):
        return states
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    arr = np.asarray(states)
    if dev.type == "cpu" and arr.dtype == np.float64 and dtype == torch.float64 and arr.flags.c_contiguous:
        return torch.from_numpy(arr)
    return torch.tensor(arr, dtype=dtype, device=dev)


class ODESystemSolver:
    """Pointwise ODE stepper over a ``[S, n]`` state tensor, updated in
    place so views of ``states`` stay valid (reference
    ``odesolver.py:46-79``).

    A ``fun`` of a ported model (:data:`~.ops.cuda_ode.IONIC_MODELS`) steps
    through its B1 kernel on the card, with the state's own voltage row as
    the injected voltage; ``parameters`` is its vector, or a node-aligned
    ``[NP, n]`` field (B1's per-node form), and ``use_kernels=False`` runs
    the twin.  Any other ``fun`` is called as given (the gotranx
    convention ``fun(states, t, parameters, dt[, missing_variables])``) and
    its result copied into the states."""

    def __init__(
        self,
        fun: Callable,
        states,
        parameters,
        missing_variables: np.ndarray | None = None,
        monitor: BaseMonitor | None = None,
        device=None,
        dtype: torch.dtype | None = None,
        use_kernels: bool = True,
    ):
        self.fun = fun
        self.states = _state_tensor(states, device, dtype)
        self.parameters = parameters
        self.missing_variables = missing_variables
        self.monitor = monitor or NullMonitor()
        self.ionic: IonicModel | None = IONIC_MODELS.get(fun) if callable(fun) else None
        self._kernel_step = None
        if self.ionic is not None:
            self._kernel_step = self._bind_model(self.ionic, use_kernels)

    def _bind_model(self, ionic: IonicModel, use_kernels: bool) -> Callable:
        if self.missing_variables is not None:
            raise NotImplementedError(f"{ionic.name} takes no missing variables")
        if self.states.shape[0] != ionic.num_states:
            raise ValueError(f"{ionic.name} has {ionic.num_states} states, got {tuple(self.states.shape)}")
        params = np.asarray(self.parameters, dtype=np.float64)
        vi = ionic.v_index
        if params.ndim == 2:
            if params.shape != (ionic.num_params, self.num_points):
                raise ValueError(
                    f"node-aligned parameters of shape {params.shape}: {ionic.name} needs "
                    f"({ionic.num_params}, {self.num_points})"
                )
            fieldt = torch.as_tensor(params, device=self.states.device).to(self.states.dtype).contiguous()
            step = ionic.node_step if use_kernels else ionic.step_twin
            return lambda s, t, dt: step(s, s[vi], t, dt, fieldt)
        step = ionic.step if use_kernels else ionic.step_twin
        return lambda s, t, dt: step(s, s[vi], t, dt, params)

    @property
    def num_states(self) -> int:
        return int(self.states.shape[0])

    @property
    def num_points(self) -> int:
        return int(self.states.shape[1])

    def step(self, t0: float, dt: float) -> None:
        opt = {}
        if self.missing_variables is not None:
            opt["missing_variables"] = self.missing_variables
        with self.monitor.track_time("ode_total_step"):
            with self.monitor.track_time("ode_function_call"):
                if self._kernel_step is not None:
                    self._kernel_step(self.states, float(t0), float(dt))
                    advanced = None
                else:
                    advanced = self.fun(states=self.states, t=t0, parameters=self.parameters, dt=dt, **opt)
            with self.monitor.track_time("ode_state_update"):
                # in place so views handed out via .values stay live
                if advanced is not None and advanced is not self.states:
                    if not isinstance(advanced, torch.Tensor):
                        advanced = torch.as_tensor(np.asarray(advanced))
                    self.states.copy_(advanced)


class BaseDolfinODESolver(abc.ABC):
    """Transfer adapter between ``[S, n]`` state tensors and FE functions
    (name kept for API parity with reference ``odesolver.py:82-132``; the
    four-transfer contract -- ``to_dolfin``/``from_dolfin`` between states
    and v_ode, ``ode_to_pde``/``pde_to_ode`` between spaces -- is the
    spec).  ``host_transfers`` counts the voltage's crossings between the
    device and the host; a transfer between spaces of different sizes runs
    on the adapter's ``device``."""

    v_ode: fem.Function
    v_pde: fem.Function

    @property
    def _metadata(self) -> dict[str, Any] | None:
        """Assembly metadata for the ODE space (quadrature degree when the
        ODE lives at quadrature points, else None)."""
        el = self.v_ode.function_space.element
        return {"quadrature_degree": el.degree} if el.family == "Quadrature" else None

    @abc.abstractmethod
    def to_dolfin(self) -> None:
        """states[v_index] -> v_ode"""

    @abc.abstractmethod
    def from_dolfin(self) -> None:
        """v_ode -> states[v_index]"""

    def _project(self, src: fem.Function, dst: fem.Function) -> None:
        """``utils.local_project`` from ``src`` into ``dst``: a host copy
        between spaces of one size; else the transfer on the adapter's
        device (B8, or its twin with ``use_kernels=False``), whose upload
        of ``src`` and download into ``dst`` are two crossings."""
        from .utils import local_project

        local_project(src, dst.function_space, dst, device=self.device, use_kernels=self.use_kernels)
        if src.x.array.size != dst.x.array.size:
            self.host_transfers += 2

    def ode_to_pde(self) -> None:
        """v_ode -> v_pde (projection when the spaces differ)."""
        self._project(self.v_ode, self.v_pde)

    def pde_to_ode(self) -> None:
        """v_pde -> v_ode (projection when the spaces differ)."""
        self._project(self.v_pde, self.v_ode)

    @abc.abstractmethod
    def step(self, t0: float, dt: float) -> None: ...

    @property
    @abc.abstractmethod
    def full_values(self) -> torch.Tensor: ...

    @abc.abstractmethod
    def assign_all_states(self, functions: list[fem.Function]) -> None: ...

    def states_to_dolfin(self, names: list[str] | None = None) -> list[fem.Function]:
        """Materialize every state row as a named FE function in the ODE
        space (for IO/postprocessing)."""
        S = self._n_state_rows()
        if names is None:
            names = [f"state_{i}" for i in range(S)]
        elif len(names) != S:
            raise ValueError(f"got {len(names)} names for {S} state rows")
        out = [fem.Function(self.v_ode.function_space, name=nm) for nm in names]
        self.assign_all_states(out)
        return out

    @abc.abstractmethod
    def _n_state_rows(self) -> int:
        """Number of state rows (uniform across markers where applicable)."""


def _tile_initial_states(init, shape: tuple[int, int]) -> np.ndarray:
    """``[S, n]`` working array from either a single ``[S]`` state vector
    (broadcast to every node) or an already-full ``[S, n]`` array."""
    init = np.asarray(init, dtype=np.float64)
    if init.shape == shape:
        return init.copy()
    return np.ascontiguousarray(np.broadcast_to(init[:, None], shape))


@dataclass
class DolfinODESolver(BaseDolfinODESolver):
    """Single-ionic-model adapter: one stepper over every node (reference
    ``odesolver.py:135-225``).  ``device``, ``dtype`` and ``use_kernels``
    as :class:`ODESystemSolver` takes them."""

    v_ode: fem.Function
    v_pde: fem.Function
    init_states: np.ndarray
    parameters: np.ndarray | None
    fun: Callable
    num_states: int
    v_index: int = 0
    missing_variables: np.ndarray | None = None
    num_missing_variables: int = 0
    monitor: BaseMonitor = field(default_factory=NullMonitor)
    device: Any = None
    dtype: Any = None
    use_kernels: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dtype = self.dtype or default_dtype(self.device)
        self._values = _state_tensor(_tile_initial_states(self.init_states, self.shape), self.device, self.dtype)
        self._ode = ODESystemSolver(
            fun=self.fun,
            states=self._values,
            parameters=self.parameters,
            missing_variables=self.missing_variables,
            monitor=self.monitor,
            use_kernels=self.use_kernels,
        )
        self.host_transfers = 0

    # -- sizes ----------------------------------------------------------
    @property
    def num_points(self) -> int:
        return self.v_ode.x.array.size

    @property
    def num_parameters(self) -> int:
        return len(self.parameters)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_states, self.num_points)

    @property
    def shape_missing_values(self) -> tuple[int, int]:
        return (self.num_missing_variables, self.num_points)

    def _n_state_rows(self) -> int:
        return self._values.shape[0]

    # -- state access ---------------------------------------------------
    @property
    def values(self) -> torch.Tensor:
        return self._values

    @property
    def full_values(self) -> torch.Tensor:
        return self._values

    # -- stepping & transfer --------------------------------------------
    def step(self, t0: float, dt: float):
        self._ode.step(t0=t0, dt=dt)

    def to_dolfin(self) -> None:
        self.v_ode.x.array[:] = self._values[self.v_index].cpu().numpy()
        self.host_transfers += 1

    def from_dolfin(self) -> None:
        self._values[self.v_index].copy_(torch.from_numpy(self.v_ode.x.array))
        self.host_transfers += 1

    def assign_all_states(self, functions: list[fem.Function]) -> None:
        if len(functions) != self._values.shape[0]:
            raise ValueError(
                f"got {len(functions)} functions for {self._values.shape[0]} state rows"
            )
        for row, f in zip(self._values.cpu().numpy(), functions):
            f.x.array[:] = row


class _MarkerBlock(NamedTuple):
    """One marker's slice of a multi-model system: the nodes it labels (a
    host mask), its own ``[S_m, n_m]`` state tensor, and the stepper bound
    to it."""

    nodes: np.ndarray  # bool mask over the ODE-space dofs
    index: torch.Tensor  # the nodes' dof numbers, int64 on the device
    states: torch.Tensor
    stepper: ODESystemSolver


@dataclass
class DolfinMultiODESolver(BaseDolfinODESolver):
    """Heterogeneous-tissue adapter: the ``markers`` function partitions
    the nodes, and each marker value runs its own ionic model / parameters
    / initial states on its partition (reference ``odesolver.py:228-354``),
    one ``[S_m, n_m]`` tensor and one kernel launch per marker.  A transfer
    moves every marker's voltage across in one piece.  ``device``,
    ``dtype`` and ``use_kernels`` as :class:`ODESystemSolver` takes them."""

    v_ode: fem.Function
    v_pde: fem.Function
    markers: fem.Function
    init_states: dict[int, np.ndarray]
    parameters: dict[int, np.ndarray]
    fun: dict[int, Callable]
    num_states: dict[int, int]
    v_index: dict[int, int]
    monitor: BaseMonitor = field(default_factory=NullMonitor)
    device: Any = None
    dtype: Any = None
    use_kernels: bool = True

    def __post_init__(self):
        labels = self.markers.x.array
        if labels.size != self.v_ode.x.array.size:
            raise RuntimeError("Marker and voltage need to be in the same function space")
        self.device = resolve_device(self.device)
        self.dtype = self.dtype or default_dtype(self.device)

        self._blocks: dict[int, _MarkerBlock] = {}
        for m in self.init_states:
            nodes = labels == m
            states = _state_tensor(
                _tile_initial_states(self.init_states[m], (self.num_states[m], int(nodes.sum()))),
                self.device,
                self.dtype,
            )
            self._blocks[m] = _MarkerBlock(
                nodes=nodes,
                index=torch.as_tensor(np.flatnonzero(nodes), device=self.device),
                states=states,
                stepper=ODESystemSolver(
                    fun=self.fun[m],
                    states=states,
                    parameters=self.parameters[m],
                    monitor=self.monitor,
                    use_kernels=self.use_kernels,
                ),
            )
        # every marker's voltage row, one after another: one crossing a transfer
        self._host_order = np.concatenate(
            [np.flatnonzero(b.nodes) for b in self._blocks.values()] or [np.zeros(0, dtype=np.int64)]
        )
        self._split = [int(b.nodes.sum()) for b in self._blocks.values()]
        self.host_transfers = 0

        rows = set(self.num_states.values())
        self._uniform_rows = rows.pop() if len(rows) == 1 else None

    # -- sizes ----------------------------------------------------------
    def num_points(self, marker: int) -> int:
        return self._blocks[marker].states.shape[1]

    def num_parameters(self, marker: int) -> int:
        return len(self.parameters[marker])

    def shape(self, marker: int) -> tuple[int, int]:
        return tuple(self._blocks[marker].states.shape)

    def _n_state_rows(self) -> int:
        if self._uniform_rows is None:
            raise RuntimeError(
                f"state counts differ across markers ({self.num_states}); "
                "materialize per marker via .values(marker)"
            )
        return self._uniform_rows

    # -- state access ---------------------------------------------------
    def values(self, marker: int) -> torch.Tensor:
        return self._blocks[marker].states

    @property
    def full_values(self) -> torch.Tensor:
        """The ``[S, n]`` union of the markers' states (zero at nodes of no
        marker), a new tensor on the device."""
        if self._uniform_rows is None:
            raise RuntimeError(
                f"state counts differ across markers ({self.num_states}); "
                "no single full array exists — use .values(marker)"
            )
        union = torch.zeros(self._uniform_rows, self.markers.x.array.size, dtype=self.dtype, device=self.device)
        for blk in self._blocks.values():
            union.index_copy_(1, blk.index, blk.states)
        return union

    # -- stepping & transfer --------------------------------------------
    def step(self, t0: float, dt: float):
        with self.monitor.track_time("total_ode_step"):
            for m, blk in self._blocks.items():
                with self.monitor.track_time(f"marker_{m}_ode_step"):
                    blk.stepper.step(t0=t0, dt=dt)

    def to_dolfin(self) -> None:
        rows = [blk.states[self.v_index[m]] for m, blk in self._blocks.items()]
        self.v_ode.x.array[self._host_order] = torch.cat(rows).cpu().numpy()
        self.host_transfers += 1

    def from_dolfin(self) -> None:
        v = torch.from_numpy(self.v_ode.x.array[self._host_order]).to(device=self.device, dtype=self.dtype)
        self.host_transfers += 1
        for (m, blk), part in zip(self._blocks.items(), torch.split(v, self._split)):
            blk.states[self.v_index[m]].copy_(part)

    def assign_all_states(self, functions: list[fem.Function]) -> None:
        if len(functions) != self._n_state_rows():
            raise ValueError(
                f"got {len(functions)} functions for {self._n_state_rows()} state rows"
            )
        for blk in self._blocks.values():
            host = blk.states.cpu().numpy()
            for i, f in enumerate(functions):
                f.x.array[blk.nodes] = host[i]


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
