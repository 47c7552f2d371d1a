"""Abstract parabolic PDE stepper (theta rule) on device operators.

Port of ``fenicsx_beat_tpu/base_model.py`` (the reference's
``src/beat/base_model.py``): ``Status``, ``Results`` and ``BaseModel``.
The operators are assembled once on the host and live on the device in a
:class:`~.theta_system.ThetaSystem`, the diffusion step the fused solver
runs too: ``A = C_m M + theta dt K`` is formed by value for each dt (a dt
change costs one combination, nothing more), the right-hand side adds
the stimulus loads (a TimeWindow's load assembled once on the host, a
general expression's at the quadrature points on the device each step),
and the solve is the Jacobi-PCG from the previous state: on structured
meshes the fused-kernel PCG (B2·B4 and B3), on unstructured ones
``ops.cg.cg_solve`` around B8.

As in the JAX package, the model's functions (``state``, ``v_``) keep
their values in host numpy arrays (``.x.array``): a step reads ``v_``
onto the device and writes the solution back, two voltage crossings,
counted in :attr:`BaseModel.host_transfers` (CG iterations in
:attr:`BaseModel.cg_iterations`, exit tests read back in ``_pde.host_syncs``).  The model runs on the card
unless ``device`` names the CPU; float32 on the card, float64 on the CPU
(:mod:`.config`), and in float32 the tolerances are clamped to what that
type resolves (:meth:`BaseModel._solver_tolerances`).
"""

from __future__ import annotations

import abc
import logging
from enum import Enum, auto
from time import perf_counter
from typing import Any, Literal, NamedTuple

import numpy as np
import torch

from . import fem
from .config import default_dtype, resolve_device
from .mesh import Mesh
from .ops.cg import CGInfo
from .stimulation import Measure, _as_expr, _transform_I_s  # noqa: F401  (JAX's module names)
from .stimulation import dx as dx_measure
from .telemetry import BaseMonitor, NullMonitor
from .theta_system import ThetaSystem, stimulus_loads

logger = logging.getLogger(__name__)

__all__ = ["Status", "Results", "BaseModel"]


class Status(str, Enum):
    OK = auto()
    NOT_CONVERGING = auto()


class Results(NamedTuple):
    state: fem.Function
    status: Status


class BaseModel(abc.ABC):
    """Base class for theta-rule parabolic models.

    Parameters mirror the reference (``base_model.py:73-124``): ``time`` is
    a mutable :class:`fem.Constant`, ``I_s`` a Stimulus / sequence /
    callable, ``params`` override :meth:`default_parameters`.  Beyond the
    JAX package's: ``device`` (the card when None), ``dtype`` (float32 on
    the card, float64 on the CPU) and ``use_kernels`` (False runs the
    kernels' plain PyTorch twins).
    """

    def __init__(
        self,
        time: fem.Constant,
        mesh: Mesh,
        dx: Measure | None = None,
        params: dict[str, Any] | None = None,
        I_s=None,
        monitor: BaseMonitor | None = None,
        device=None,
        dtype: torch.dtype | None = None,
        use_kernels: bool = True,
        **kwargs: Any,
    ) -> None:
        if kwargs:
            logger.warning(
                "Unused keyword arguments: %s",
                ", ".join(f"{k}={v}" for k, v in kwargs.items()),
            )

        self._mesh = mesh
        self.time = time
        self.dx = dx or dx_measure(mesh)
        self.monitor = monitor or NullMonitor()
        self.device = resolve_device(device)
        self._dtype = dtype or default_dtype(self.device)
        if self.device.type == "cuda" and self._dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self._dtype}")
        self._np_dtype = np.float32 if self._dtype == torch.float32 else np.float64
        self.use_kernels = use_kernels
        self.host_transfers = 0  # voltage crossings between host and device
        self.cg_iterations = 0  # over every step

        self.parameters = type(self).default_parameters()
        if params is not None:
            self.parameters.update(params)

        self._I_s = _transform_I_s(I_s, dZ=self.dx)
        self.setup_s: dict[str, float] = {}  # host setup seconds by part
        tic = perf_counter()
        self._setup_state_space()
        self.setup_s["space"] = perf_counter() - tic
        self._timestep = fem.Constant(self.parameters["default_timestep"])
        self._setup_solver()

    # ------------------------------------------------------------------
    @abc.abstractmethod
    def _setup_state_space(self) -> None: ...

    @property
    @abc.abstractmethod
    def state(self) -> fem.Function: ...

    @abc.abstractmethod
    def assign_previous(self) -> None: ...

    @abc.abstractmethod
    def _operators(self):
        """Return (mass, stiff, C_m) for the theta system: two host
        stencil or ELL operators of one pattern and the capacitance."""
        ...

    # ------------------------------------------------------------------
    @staticmethod
    def default_parameters(
        solver_type: Literal["iterative", "direct"] = "direct",
    ) -> dict[str, Any]:
        """Defaults mirroring reference ``base_model.py:136-168``.

        ``petsc_options`` keys are interpreted by the port's CG solver:
        direct -> very tight CG tolerances (LU-equivalent accuracy);
        iterative -> the reference's CG profile.
        """
        if solver_type == "iterative":
            petsc_options = {"ksp_type": "cg", "ksp_rtol": 1e-8, "ksp_atol": 1e-12}
        else:
            petsc_options = {"ksp_type": "preonly", "pc_type": "lu"}
        return {
            "theta": 0.5,
            "degree": 1,
            "family": "Lagrange",
            "default_timestep": 1.0,
            "jit_options": {},
            "form_compiler_options": {},
            "petsc_options": petsc_options,
            "quadrature_degree": 4,
            "log_timings": False,
            "timing_log_frequency": 1,
        }

    # ------------------------------------------------------------------
    def _solver_tolerances(self) -> tuple[float, float, int]:
        """``(rtol, atol, maxiter)`` of the CG from ``petsc_options``; in
        float32 clamped to ``rtol >= 1e-6``, ``atol >= 1e-8`` (the "direct"
        profile's 1e-13 is below float32's rounding: the CG would never
        meet it and run ``maxiter`` iterations every step)."""
        opts = self.parameters.get("petsc_options") or {}
        if opts.get("ksp_type", "preonly") == "preonly" or opts.get("pc_type") == "lu":
            rtol, atol = 1e-13, 1e-14
        else:
            rtol = float(opts.get("ksp_rtol", 1e-8))
            atol = float(opts.get("ksp_atol", 1e-12))
        maxiter = int(opts.get("ksp_max_it", 10_000))
        if self._dtype == torch.float32:
            rtol = max(rtol, 1e-6)
            atol = max(atol, 1e-8)
        return rtol, atol, maxiter

    def _stimulus_amplitudes(self) -> np.ndarray:
        """Live amplitude vector (1.0 slots for non-TimeWindow exprs), read
        each step: ``Stimulus.assign`` takes effect at the next step."""
        amps = [float(stim.expr.amplitude) if stim is not None else 1.0 for _, _, stim in self._stim_quads]
        return np.asarray(amps or [0.0], dtype=self._np_dtype)

    def _setup_solver(self) -> None:
        """The theta system and the stimulus loads, timed by part in
        :attr:`setup_s`: ``assembly`` (:meth:`_operators`), ``packing`` (the
        operators on the device, CSR packing included) and ``stimulus``."""
        tic = perf_counter()
        mass, stiff, C_m = self._operators()
        self.setup_s["assembly"] = perf_counter() - tic
        self._C_m = float(C_m)
        rtol, atol, maxiter = self._solver_tolerances()
        tic = perf_counter()
        self._pde = ThetaSystem(mass, stiff, self._C_m, float(self.parameters["theta"]), rtol, atol, maxiter,
                                self.device, self._dtype, self.use_kernels)
        self.setup_s["packing"] = perf_counter() - tic
        qdeg = int(self.parameters.get("quadrature_degree", 4))
        tic = perf_counter()
        self._stim_quads, self._stim_terms, self._b_units = stimulus_loads(
            self.V, self._I_s, self._mesh, qdeg, self.device, self._dtype
        )
        self.setup_s["stimulus"] = perf_counter() - tic

    def _update_matrices(self) -> None:
        """No-op: the operators of a new dt are combined at its first solve
        (the reference re-assembles here, ``base_model.py:188-194``)."""

    def _update_rhs(self) -> None:
        """No-op: the right-hand side is assembled in the solve."""

    # ------------------------------------------------------------------
    def step(self, interval) -> None:
        """Perform a single theta-rule step on (t0, t1)
        (mirrors reference ``base_model.py:208-245``)."""
        t0, t1 = interval
        dt = t1 - t0
        theta = self.parameters["theta"]
        t = t0 + theta * dt

        with self.monitor.track_time("pde_total_step"):
            with self.monitor.track_time("pde_set_time"):
                self.time.value = t

            timestep_unchanged = abs(dt - float(self._timestep)) < 1.0e-12
            if not timestep_unchanged:
                self._timestep.value = dt
                with self.monitor.track_time("pde_update_matrices"):
                    self._update_matrices()

            with self.monitor.track_time("pde_update_rhs"):
                self._update_rhs()

            with self.monitor.track_time("pde_linear_solve"):
                w = self._np_dtype
                v_prev = torch.tensor(self.v_.x.array, dtype=self._dtype, device=self.device)
                self.host_transfers += 1
                ops = self._pde.operators(float(w(dt)))
                b = self._pde.rhs(ops[1], v_prev, self._stim_terms, self._b_units, w(t), float(w(dt)),
                                  self._stimulus_amplitudes())
                x, iters, rr, converged = self._pde.solve(ops, b, v_prev)

            self.cg_iterations += iters
            info = CGInfo(iterations=iters, residual_norm=float(torch.sqrt(rr)), converged=converged)
            self.monitor.record_ksp(info)
            self._last_solve_converged = converged
            if not converged:
                logger.warning(
                    "CG stopped at maxiter without meeting tolerance at "
                    "t=(%g, %g): residual norm %.3e after %d iterations",
                    t0,
                    t1,
                    info.residual_norm,
                    iters,
                )

            with self.monitor.track_time("pde_scatter_forward"):
                self.state.x.array[:] = x.cpu().numpy()
                self.host_transfers += 1

        self.monitor.advance_step(t0, t1)

    def solve(self, interval, dt: float | None = None) -> Results:
        """Solve on (T0, T); exact loop semantics of reference
        ``base_model.py:250-297`` (including no ``assign_previous`` after
        the final step -- the splitting tests depend on it)."""
        T0, T = interval
        if dt is None:
            dt = T - T0
        t0 = T0
        t1 = T0 + dt

        all_converged = True
        while True:
            logger.debug("Solving on t = (%g, %g)", t0, t1)
            self.step((t0, t1))
            all_converged &= getattr(self, "_last_solve_converged", True)
            if (t1 + dt) > (T + 1e-12):
                break
            self.assign_previous()
            t0 = t1
            t1 = t0 + dt

        status = Status.OK if all_converged else Status.NOT_CONVERGING
        return Results(state=self.state, status=status)
