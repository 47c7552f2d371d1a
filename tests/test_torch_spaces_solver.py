"""The object-oriented splitting path on spaces beyond P1, the port against
the JAX package, in float64 on the CPU:

- the manufactured solution of ``tests/test_monodomain_solver.py:47-73``
  (the harmonic (v, s) pair, I_s = 8 pi^2 cos cos sin t) at N=8, 10 steps
  of dt 0.01, with the ODE on P_1, P_2, DG_1 or Quadrature_2 and the PDE
  at degree 1 or 2: v and the ODE states within 1e-10 of their largest
  magnitude;
- the JAX cross-space adapter test (``tests/test_odesolver.py:106-129``,
  ODE on P2, PDE on P1) on the port, with its voltage crossings counted;
- the Niederer slab at dx=0.5 with the PDE on P2, and with the ODE at the
  Quadrature_2 points (TP06 through B1's twin, Strang, dt 0.05): 20 steps
  against JAX's OO run, through ``benchmarks/niederer.build_niederer_oo``.
"""

import numpy as np
import pytest
import torch

import fenicsx_beat_tpu as jbeat
import fenicsx_beat_tpu_torch as tbeat
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import odesolver as tode

SIDES = {"jax": (jbeat, jfem, jmesh, {}), "port": (tbeat, tfem, tmesh, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread: its tensors here are small, and in
    the parallel test run, where every worker's threads compete for the
    cores, a process whose parallel regions wait on all its threads runs
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def simple_ode_forward_euler(states, t, dt, parameters):
    """The JAX test's stepper, for numpy arrays and torch tensors alike."""
    v, s = states
    values = states * 0.0
    values[0] = v - s * dt
    values[1] = s + v * dt
    return values


def s_exact_func(x, t):
    return -np.cos(2 * np.pi * x[0]) * np.cos(2 * np.pi * x[1]) * np.cos(t)


def ac_jax(x, t):
    import jax.numpy as jnp

    return 8 * jnp.pi**2 * jnp.cos(2 * jnp.pi * x[0]) * jnp.cos(2 * jnp.pi * x[1]) * jnp.sin(t)


def ac_torch(x, t):
    return 8 * np.pi**2 * torch.cos(2 * np.pi * x[0]) * torch.cos(2 * np.pi * x[1]) * torch.sin(t)


def mms_solver(side, odespace, degree, N=8, theta=1.0):
    """``tests/test_monodomain_solver.py:_make_solver`` in either package,
    the PDE at ``degree``."""
    pkg, fem_, mm, kw = SIDES[side]
    mesh = mm.create_unit_square(None, N, N)
    pde = pkg.MonodomainModel(time=fem_.Constant(0.0), mesh=mesh, M=1.0, I_s=ac_jax if side == "jax" else ac_torch,
                              params={"degree": degree}, **kw)
    V_ode = pkg.utils.space_from_string(odespace, mesh, dim=1)
    s = fem_.Function(V_ode)
    s.interpolate(lambda x: s_exact_func(x, 0.0))
    init_states = np.zeros((2, s.x.array.size))
    init_states[1, :] = s.x.array
    ode = pkg.odesolver.DolfinODESolver(v_ode=fem_.Function(V_ode), v_pde=pde.state, fun=simple_ode_forward_euler,
                                        init_states=init_states, parameters=None, num_states=2, v_index=0, **kw)
    return pkg.MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("odespace", ["P_1", "P_2", "DG_1", "Quadrature_2"])
def test_mms_matches_jax(odespace, degree):
    out = {}
    for side in ("jax", "port"):
        solver = mms_solver(side, odespace, degree)
        solver.solve((0.0, 0.1), dt=0.01)
        states = solver.ode.values
        out[side] = (np.array(solver.pde.state.x.array), np.array(states.numpy() if side == "port" else states))
    for port, ref in zip(out["port"], out["jax"]):
        assert np.abs(port - ref).max() <= 1e-10 * np.abs(ref).max()
    assert np.abs(out["port"][0]).max() > 1e-3  # the source drove v
    if odespace == "Quadrature_2":
        assert solver.ode._metadata == {"quadrature_degree": 2}
    else:
        assert solver.ode._metadata is None


def test_dolfin_ode_solver_cross_space():
    """``tests/test_odesolver.py:106-129`` on the port: ODE on P2, PDE on P1;
    each cross-space transfer is two voltage crossings (up, down)."""
    mesh = tmesh.create_unit_square(None, 4, 4)
    v_pde = tfem.Function(tfem.functionspace(mesh, ("P", 1)))
    V_ode = tfem.functionspace(mesh, ("P", 2))
    v_ode = tfem.Function(V_ode)
    ode = tode.DolfinODESolver(v_ode=v_ode, v_pde=v_pde, init_states=np.array([1.0, 2.0]),
                               parameters=np.array([1, 1]), fun=simple_ode_forward_euler, num_states=2, v_index=0,
                               device="cpu")
    assert ode.num_points == V_ode.ndofs
    ode.to_dolfin()
    ode.ode_to_pde()
    assert np.allclose(v_pde.x.array, 1.0)
    v_pde.x.array[:] = 3.0
    ode.pde_to_ode()
    assert np.allclose(v_ode.x.array, 3.0)
    assert ode.host_transfers == 1 + 2 + 2


@pytest.mark.parametrize("config, n_steps", [("p2", 20), ("q", 10)])
def test_niederer_p2_matches_jax(config, n_steps):
    """The dx=0.5 Niederer slab, TP06 through B1's twin, Strang, from rest
    (the stimulus on): with the PDE on P2 (30,537 dofs), 20 steps, and with
    the PDE on P1 and the ODE at the Quadrature_2 points (161,280), 10
    steps: v at every PDE dof against JAX's OO run on the same
    configuration (both at the "direct" CG profile's rtol 1e-13)."""
    from fenicsx_beat_tpu_torch.benchmarks.niederer import build_niederer_oo
    from torch_spaces_reference import CONFIGS, jax_niederer_oo

    port = build_niederer_oo(0.5, device="cpu", **CONFIGS[config]).solver
    ref = jax_niederer_oo(0.5, **CONFIGS[config])
    for k in range(n_steps):
        for s in (port, ref):
            s.step((k * 0.05, (k + 1) * 0.05))
    v, vj = port.pde.state.x.array, np.asarray(ref.pde.state.x.array)
    assert port.pde.V.ndofs == vj.size == {"p2": 30537, "q": 4305}[config]
    assert port.ode.num_points == {"p2": 30537, "q": 161280}[config]
    assert v.max() > -75.0  # the stimulus depolarized the corner (rest: -85.23 mV)
    assert np.abs(v - vj).max() <= 1e-10 * np.abs(vj).max()
