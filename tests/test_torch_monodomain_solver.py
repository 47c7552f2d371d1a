"""The port's object-oriented splitting path (``MonodomainModel`` +
``DolfinODESolver`` / ``DolfinMultiODESolver`` +
``MonodomainSplittingSolver``) against the JAX package's OO path and
against the port's fused solver.

- TP06 on ``tests/test_fused.py:_setup``'s problem (the unit square,
  N=16, a 2 ms corner stimulus), Godunov and Strang, 5 ms: the port's OO
  run against JAX's OO run, atol 1e-8 (both at the "direct" profile's
  rtol 1e-13 in float64);
- the port's OO run against its fused solver on the same problem, one
  marker (``test_fused.py:30-76``) and two (``:236-288``);
- the monitor's section names and step count equal to JAX's, the monitor
  given to the model, the ODE adapter and the splitting solver;
- ``benchmarks/verification.py`` at N=24 (the demo's quick form): the
  errors equal to JAX's demo, Godunov's rate within 0.8-1.2 and Strang's
  at least 1.8 (the JAX demo itself gives 3.03 here: Strang converges
  faster than second order on this problem, whose ODE step is exact).
"""

import numpy as np
import pytest
import torch

import fenicsx_beat_tpu as jbeat
import fenicsx_beat_tpu_torch as tbeat
from demos import verification as jverification
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import telemetry as jtel
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import telemetry as ttel
from fenicsx_beat_tpu_torch.benchmarks import verification as tverification
from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp

T, DT, M = 5.0, 0.05, 0.001
SIDES = {"jax": (jbeat, jfem, jmesh, jtp, {}), "port": (tbeat, tfem, tmesh, ttp, {"device": "cpu"})}


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


def setup(side, N=16):
    """``tests/test_fused.py:_setup`` in either package."""
    pkg, fem_, mm, _, _ = SIDES[side]
    mesh = mm.create_unit_square(None, N, N)
    cells = mm.locate_entities(mesh, mesh.tdim, lambda x: np.logical_and(x[0] <= 0.3, x[1] <= 0.3))
    tags = mm.meshtags(mesh, mesh.tdim, cells, 1)
    dx = pkg.stimulation.dx(mesh, subdomain_data=tags)
    expr = pkg.stimulation.TimeWindow(amplitude=80.0, start=0.0, duration=2.0)
    return mesh, pkg.Stimulus(expr=expr, dZ=dx, marker=1), dx


def oo_solver(side, theta, N=16, markers=None, monitor=None):
    """The OO path on ``setup``'s problem: TP06 on every node, or on two
    markers (x < 0.5 pre-depolarized) with ``markers``."""
    pkg, fem_, _, tp, kw = SIDES[side]
    mesh, I_s, dx = setup(side, N)
    mon = {} if monitor is None else {"monitor": monitor}
    pde = pkg.MonodomainModel(time=fem_.Constant(0.0), mesh=mesh, M=M, I_s=I_s, dx=dx, **kw, **mon)
    V = fem_.functionspace(mesh, ("P", 1))
    params = tp.init_parameter_values(stim_amplitude=0.0)
    vi = tp.state_index("V")
    if markers is None:
        init = tp.init_state_values()
        ode = pkg.odesolver.DolfinODESolver(v_ode=fem_.Function(V), v_pde=pde.state, fun=tp.generalized_rush_larsen,
                                            init_states=init, parameters=params, num_states=len(init), v_index=vi,
                                            **kw, **mon)
    else:
        inits = {1: tp.init_state_values(), 2: tp.init_state_values(V=-60.0)}
        mfn = fem_.Function(V)
        mfn.x.array[:] = np.where(V.tabulate_dof_coordinates()[:, 0] < 0.5, 1, 2)
        ode = pkg.odesolver.DolfinMultiODESolver(
            v_ode=fem_.Function(V), v_pde=pde.state, markers=mfn, init_states=inits,
            parameters={1: params, 2: params}, fun={m: tp.generalized_rush_larsen for m in (1, 2)},
            num_states={m: len(s) for m, s in inits.items()}, v_index={1: vi, 2: vi}, **kw, **mon)
    return pkg.MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta, **mon)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_oo_matches_jax_oo(theta):
    v = {}
    for side in ("jax", "port"):
        s = oo_solver(side, theta)
        s.solve((0.0, T), dt=DT)
        v[side] = np.array(s.pde.state.x.array)
    assert v["port"].max() > 0.0  # the stimulus depolarized the corner
    np.testing.assert_allclose(v["port"], v["jax"], rtol=0, atol=1e-8)


def fused(theta, markers=None, N=16):
    mesh, I_s, _ = setup("port", N)
    params = ttp.init_parameter_values(stim_amplitude=0.0)
    kw = dict(ode_fun=ttp.generalized_rush_larsen, init_states=ttp.init_state_values(), parameters=params, v_index=0)
    if markers is not None:
        kw = dict(ode_fun={m: ttp.generalized_rush_larsen for m in (1, 2)},
                  init_states={1: ttp.init_state_values(), 2: ttp.init_state_values(V=-60.0)},
                  parameters={1: params, 2: params}, v_index={1: 0, 2: 0}, ode_markers=markers)
    return FusedMonodomainSolver(mesh=mesh, M=M, I_s=I_s, theta=theta, device="cpu",
                                 params={"ksp_rtol": 1e-13, "ksp_atol": 1e-14}, **kw)


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_oo_matches_fused(theta):
    oo = oo_solver("port", theta)
    oo.solve((0.0, T), dt=DT)
    fs = fused(theta)
    fs.solve((0.0, T), dt=DT)
    np.testing.assert_allclose(fs.v.numpy(), oo.pde.state.x.array, rtol=0, atol=1e-7)
    # every state row of the adapter: the same ionic trajectories
    np.testing.assert_allclose(fs.states.numpy(), oo.ode.full_values.numpy(), rtol=1e-6, atol=1e-6)


def test_oo_multi_marker_matches_fused():
    N = 12
    oo = oo_solver("port", 1.0, N=N, markers=True)
    oo.solve((0.0, 2.0), dt=DT)
    marker_arr = oo.ode.markers.x.array.astype(np.int64)
    fs = fused(1.0, markers=marker_arr, N=N)
    fs.solve((0.0, 2.0), dt=DT)
    np.testing.assert_allclose(fs.v.numpy(), oo.pde.state.x.array, rtol=0, atol=1e-7)


def test_monitor_sections_match_jax():
    """The same monitor on the model, the ODE adapter and the splitting
    solver, two markers, Strang, a dt change: the section names and the
    step count equal to JAX's."""
    out = {}
    for side, tel in (("jax", jtel), ("port", ttel)):
        mon = tel.PerformanceMonitor(log_frequency=0)
        s = oo_solver(side, 0.5, N=6, markers=True, monitor=mon)
        s.solve((0.0, 0.15), dt=DT)
        s.step((0.15, 0.25))
        out[side] = (set(mon.timings), mon.step_counter)
    assert out["port"] == out["jax"]
    assert {"total_ode_step", "marker_1_ode_step", "corrective_ode_to_pde", "pde_linear_solve",
            "pde_update_matrices", "ode_function_call"} <= out["port"][0]


def test_verification_rates_match_jax_demo():
    port = tverification.rates(quick=True, device="cpu")
    mesh = jmesh.create_unit_square(None, 24, 24)
    for theta, name in ((1.0, "Godunov"), (0.5, "Strang")):
        ref = jverification.run(mesh, theta, dt=1 / 128)
        errors = [float(np.sqrt(np.mean((jverification.run(mesh, theta, dt=dt) - ref) ** 2))) for dt in (1 / 8, 1 / 16)]
        np.testing.assert_allclose(port[name][0], errors, rtol=1e-8)
    (godunov,) = port["Godunov"][1]
    (strang,) = port["Strang"][1]
    assert 0.8 <= godunov <= 1.2
    assert strang >= 1.8
