"""Operator-splitting coupler for the monodomain system.

Port of ``fenicsx_beat_tpu/monodomain_solver.py`` (the reference's
``src/beat/monodomain_solver.py:26-116``): :class:`MonodomainSplittingSolver`
with ``step`` / ``solve`` over a duck-typed :class:`ODESolver`, so user
scripts translate one to one.  The ionic states and the diffusion
operators live on the device; the voltage crosses to the host in the
transfer hooks and in the PDE step, as in the JAX package (the fused
solver, :mod:`.fused`, runs the same schedule with no crossing at all;
``tests/test_torch_monodomain_solver.py`` holds the two together).
:attr:`MonodomainSplittingSolver.host_transfers` counts the crossings.

Splitting schedule for one step of width ``dt`` with splitting parameter
``theta`` (Godunov when ``theta == 1``, Strang when ``theta == 0.5``):

1. advance the ionic ODEs by ``theta * dt`` from ``t0``;
2. move the ODE voltage into the PDE space and diffuse over the full
   ``[t0, t1]`` window;
3. push the diffused voltage back into the ODE state;
4. for ``theta < 1`` only, advance the ODEs again by the remaining
   ``(1 - theta) * dt`` and re-sync the PDE's previous-state buffer.

Monitor section names are part of the observable contract (the reference's
``PerformanceMonitor`` summaries key on them) and are kept verbatim.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Protocol, Tuple

from .monodomain_model import MonodomainModel
from .telemetry import BaseMonitor, NullMonitor

logger = logging.getLogger(__name__)

#: Tolerance used to decide whether another whole step fits in the interval.
EPS = 1e-12

__all__ = ["ODESolver", "MonodomainSplittingSolver"]


class ODESolver(Protocol):
    """Anything the splitting solver can drive as its reaction stage.

    Matches the adapters in :mod:`.odesolver` (``DolfinODESolver`` /
    ``DolfinMultiODESolver``): a per-node integrator plus the four transfer
    hooks between the state tensor, the ODE-space field, and the PDE
    space.
    """

    def to_dolfin(self) -> None: ...

    def from_dolfin(self) -> None: ...

    def ode_to_pde(self) -> None: ...

    def pde_to_ode(self) -> None: ...

    def step(self, t0: float, dt: float) -> None: ...


@dataclass
class MonodomainSplittingSolver:
    """Theta-rule operator splitting between an ODE stage and a PDE stage.

    Parameters mirror the reference constructor: ``pde`` is a
    :class:`~.monodomain_model.MonodomainModel`, ``ode`` any
    :class:`ODESolver`, ``theta`` the splitting weight (distinct from the
    PDE's own time-discretization theta), and ``monitor`` receives
    per-section timings.
    """

    pde: MonodomainModel
    ode: ODESolver
    theta: float = 1.0
    monitor: BaseMonitor = field(default_factory=NullMonitor)

    def __post_init__(self) -> None:
        # Seed the PDE from the ODE initial conditions: state tensor ->
        # ODE-space field -> PDE space -> previous-state buffer.
        self.ode.to_dolfin()
        self.ode.ode_to_pde()
        self.pde.assign_previous()

    @property
    def host_transfers(self) -> int:
        """Voltage crossings between the device and the host so far: the
        ODE adapter's and the PDE model's."""
        return getattr(self.ode, "host_transfers", 0) + getattr(self.pde, "host_transfers", 0)

    def solve(self, interval: Tuple[float, float], dt: float | None) -> None:
        """March ``step`` across ``interval`` in increments of ``dt``.

        ``dt=None`` collapses the whole interval into a single step, like
        the reference's ``solve`` entry.
        """
        start, stop = interval
        if dt is None:
            dt = stop - start
        lo = start
        while lo + dt < stop + EPS:
            hi = lo + dt
            logger.debug("splitting step over [%g, %g]", lo, hi)
            self.step((lo, hi))
            lo = hi

    # -- one splitting step ------------------------------------------------

    def _timed(self, section: str):
        return self.monitor.track_time(section)

    def _sync_voltage_to_pde(self, prefix: str = "") -> None:
        """ODE state -> ODE-space field -> PDE space (cross-space transfer)."""
        with self._timed(prefix + "ode_to_dolfin"):
            self.ode.to_dolfin()
        with self._timed(prefix + "ode_to_pde"):
            self.ode.ode_to_pde()

    def step(self, interval: Tuple[float, float]) -> None:
        lo, hi = interval
        dt = hi - lo
        theta = self.theta
        t_mid = lo + theta * dt
        logger.debug("step [%g, %g], splitting theta=%g", lo, hi, theta)

        with self._timed("total_step"):
            # (1) reaction: tentative ionic step over theta*dt.
            with self._timed("ode_step"):
                self.ode.step(t0=lo, dt=theta * dt)

            # (2) diffusion over the full window, fed by the ODE voltage.
            self._sync_voltage_to_pde()
            with self._timed("pde_assign_previous_before"):
                self.pde.assign_previous()
            with self._timed("pde_step"):
                self.pde.step((lo, hi))

            # (3) diffused voltage back into the ODE state.
            with self._timed("pde_to_ode"):
                self.ode.pde_to_ode()
            with self._timed("ode_from_dolfin"):
                self.ode.from_dolfin()

            # (4) Godunov stops here; Strang finishes the remaining
            # (1-theta)*dt of reaction and re-syncs the PDE buffer.
            if math.isclose(theta, 1.0):
                with self._timed("pde_assign_previous_after"):
                    self.pde.assign_previous()
            else:
                logger.debug(
                    "corrective ionic step: t0=%.5f dt=%.5f",
                    t_mid,
                    (1.0 - theta) * dt,
                )
                with self._timed("corrective_ode_step"):
                    self.ode.step(t_mid, (1.0 - theta) * dt)
                self._sync_voltage_to_pde(prefix="corrective_")
                with self._timed("corrective_pde_assign_previous"):
                    self.pde.assign_previous()

        self.monitor.advance_step(lo, hi)
