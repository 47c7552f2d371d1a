r"""Monodomain diffusion model.

Port of ``fenicsx_beat_tpu/monodomain_model.py`` (the reference's
``src/beat/monodomain_model.py``): solves

.. math::

    C_m \frac{\partial v}{\partial t} - \nabla \cdot (M \nabla v) - I_{stim} = 0

with the theta rule.  The reference builds the variational form
symbolically (``monodomain_model.py:68-98``); here the form is the linear
system ``(C_m*Mass + theta*dt*K) v = C_m*Mass v_ - (1-theta)*dt*K v_ +
dt*b_stim(t)`` over operators assembled once on the host (a stencil on
structured meshes, ELL otherwise) and stepped on the device
(:class:`~.base_model.BaseModel`).
"""

from __future__ import annotations

from . import fem
from .base_model import BaseModel
from .conductivities import as_cell_tensors
from .mesh import Mesh

__all__ = ["MonodomainModel"]


class MonodomainModel(BaseModel):
    def __init__(
        self,
        time: fem.Constant,
        mesh: Mesh,
        M,
        I_s=None,
        params=None,
        C_m: float = 1.0,
        dx=None,
        **kwargs,
    ) -> None:
        self._M = M
        self.C_m = float(C_m)
        super().__init__(mesh=mesh, time=time, params=params, I_s=I_s, dx=dx, **kwargs)

    def _setup_state_space(self) -> None:
        k = self.parameters["degree"]
        family = self.parameters["family"]
        self.V = fem.functionspace(self._mesh, (family, k))
        self.v_ = fem.Function(self.V, name="v_")
        self._state = fem.Function(self.V, name="v")

    @property
    def state(self) -> fem.Function:
        return self._state

    def assign_previous(self) -> None:
        self.v_.x.array[:] = self.state.x.array[:]

    @staticmethod
    def default_parameters():
        params = super(MonodomainModel, MonodomainModel).default_parameters()
        params["use_custom_preconditioner"] = True
        return params

    def _operators(self):
        M_cells = as_cell_tensors(self._M, self._mesh)
        mass, stiff = fem.assemble_mass_stiffness_auto(self.V, M_cells)
        return mass, stiff, self.C_m

    def variational_forms(self, dt):
        """Kept for API parity with reference ``monodomain_model.py:68-98``:
        instead of the UFL forms ``(a, L)`` of a step of ``dt``, the theta
        system's device operators ``C_m M + theta dt K`` and
        ``C_m M - (1 - theta) dt K`` (:meth:`~.theta_system.ThetaSystem.operators`)."""
        return self._pde.operators(float(dt))[:2]
