"""The port's ODE layer (``fenicsx_beat_tpu_torch.odesolver``) against the
JAX package's, on the same seeded numpy inputs: ``solve``,
``ODESystemSolver``, ``DolfinODESolver`` and ``DolfinMultiODESolver`` on a
simple two-state ODE (a numpy stepper, run as given on the port's CPU
tensors) and on TP06's generalized Rush-Larsen step (the port through B1's
twin, JAX through its jnp model); the transfer hooks, ``states_to_dolfin``,
the errors JAX raises, models with different state counts per marker, and
``local_project`` between spaces of different sizes raising where JAX's
does.  float64 on
the CPU."""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import utils as jutils
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import odesolver as tode
from fenicsx_beat_tpu_torch import utils as tutils
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.telemetry import PerformanceMonitor


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
    """JAX's test stepper, written for numpy arrays and torch tensors alike."""
    v, s = states
    a, b = parameters
    values = states * 0.0
    values[0] = v - a * s * dt
    values[1] = s + b * v * dt
    return values


def as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spaces(N=5):
    jm, tm = jmesh.create_unit_square(None, N, N), tmesh.create_unit_square(None, N, N)
    return (jm, jfem.functionspace(jm, ("P", 1))), (tm, tfem.functionspace(tm, ("P", 1)))


def test_solve_matches_jax():
    """``solve`` records the voltage row after each in-place step while
    the next time lies inside the horizon; the port's runs the stepper on
    whatever the caller passes (numpy here, a tensor below)."""

    def rotate(states, t, parameters, dt):
        v, s = states.copy() if isinstance(states, np.ndarray) else states.clone()
        states[0] = v - parameters[0] * s * dt
        states[1] = s + parameters[1] * v * dt

    init = np.random.default_rng(0).standard_normal((2, 6))
    out = {}
    for name, mod, states in (("jax", jode, init.copy()), ("port", tode, init.copy()),
                              ("port_tensor", tode, torch.tensor(init))):
        V = torch.zeros(12, 6, dtype=torch.float64) if name == "port_tensor" else np.zeros((12, 6))
        mod.solve(rotate, 1.0, states, V, 0, 0.1, np.array([1.0, 0.5]))
        out[name] = (as_np(V), as_np(states))
    for k in ("port", "port_tensor"):
        np.testing.assert_array_equal(out[k][0], out["jax"][0])
        np.testing.assert_array_equal(out[k][1], out["jax"][1])
    # a step while t + dt < 1.0 in float64 sums: ten (0.9 + 0.1 falls short of 1.0)
    assert np.count_nonzero(out["jax"][0].any(axis=1)) == 10


def test_odesystemsolver_first_order_and_matches_jax():
    x = np.arange(0.1, 1.1, 0.1)
    sol = np.vstack((np.cos(x), np.sin(x))).T
    errors = []
    for dt in (0.1, 0.01, 0.001):
        y = np.zeros((len(x), 2))
        states = np.zeros((2, 1))
        states.T[:] = [1, 0]
        ode = tode.ODESystemSolver(fun=simple_ode_forward_euler, states=states, parameters=np.array([1, 1]),
                                   device="cpu")
        j, t = 0, 0.0
        for _ in range(int(1.0 / dt)):
            ode.step(t, dt)
            t += dt
            if np.isclose(t, x[j]):
                y[j] = ode.states[:, 0].numpy()
                j += 1
        errors.append(np.linalg.norm(sol - y))
        np.testing.assert_array_equal(states, ode.states.numpy())  # the caller's array updated in place
    rates = [np.log(e1 / e2) / np.log(10) for e1, e2 in zip(errors[:-1], errors[1:])]
    assert np.allclose(rates, 1, atol=0.02)

    init = np.random.default_rng(1).standard_normal((2, 7))
    js = jode.ODESystemSolver(fun=simple_ode_forward_euler, states=init.copy(), parameters=np.array([1.0, 2.0]))
    ts = tode.ODESystemSolver(fun=simple_ode_forward_euler, states=init.copy(), parameters=np.array([1.0, 2.0]),
                              device="cpu")
    for k in range(5):
        js.step(0.1 * k, 0.1)
        ts.step(0.1 * k, 0.1)
    np.testing.assert_allclose(ts.states.numpy(), js.states, rtol=0, atol=1e-14)
    assert ts.ionic is None and (ts.num_states, ts.num_points) == (2, 7)


def test_odesystemsolver_tp06_twin_matches_jax():
    """A ported model's step through B1's twin (vector and node-aligned
    field) against JAX's jnp model on the same perturbed states."""
    rng = np.random.default_rng(2)
    n = 9
    init = np.tile(ttp.init_state_values()[:, None], (1, n)) * (1 + 0.01 * rng.standard_normal((19, n)))
    init[0] = rng.uniform(-85.0, 20.0, n)
    params = ttp.init_parameter_values(stim_amplitude=0.0)
    js = jode.ODESystemSolver(fun=jtp.generalized_rush_larsen, states=init.copy(), parameters=params)
    vec = tode.ODESystemSolver(fun=ttp.generalized_rush_larsen, states=init.copy(), parameters=params, device="cpu")
    fld = tode.ODESystemSolver(fun=ttp.generalized_rush_larsen, states=init.copy(),
                               parameters=np.tile(params[:, None], (1, n)), device="cpu")
    assert vec.ionic.name == "tp06"
    for k in range(10):
        for s in (js, vec, fld):
            s.step(0.05 * k, 0.05)
    np.testing.assert_allclose(vec.states.numpy(), js.states, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(fld.states.numpy(), vec.states.numpy(), rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="node-aligned"):
        tode.ODESystemSolver(fun=ttp.generalized_rush_larsen, states=init.copy(), parameters=np.zeros((54, 3)),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="missing variables"):
        tode.ODESystemSolver(fun=ttp.generalized_rush_larsen, states=init.copy(), parameters=params,
                             missing_variables=np.zeros(3), device="cpu")


def test_dolfin_ode_solver_transfers_match_jax():
    (jm, jV), (tm, tV) = spaces()
    v0, s0, dt = 1.0, 2.0, 0.1
    run = {}
    for name, fem_, mod, V, kw in (("jax", jfem, jode, jV, {}), ("port", tfem, tode, tV, {"device": "cpu"})):
        v_ode, v_pde = fem_.Function(V), fem_.Function(V)
        ode = mod.DolfinODESolver(v_ode=v_ode, v_pde=v_pde, init_states=np.array([v0, s0]),
                                  parameters=np.array([1, 1]), fun=simple_ode_forward_euler, num_states=2, v_index=0,
                                  **kw)
        assert tuple(ode.full_values.shape) == (2, V.ndofs) and ode.num_parameters == 2
        ode.step(0.0, dt)
        assert np.allclose(v_ode.x.array, 0.0)  # not yet transferred
        ode.to_dolfin()
        ode.ode_to_pde()
        trace = [v_ode.x.array.copy(), v_pde.x.array.copy()]
        v_pde.x.array[:] = np.linspace(0.0, 1.0, V.ndofs)
        ode.pde_to_ode()
        ode.from_dolfin()
        states = ode.states_to_dolfin()
        run[name] = trace + [as_np(ode.values).copy()] + [f.x.array.copy() for f in states] + [
            [f.name for f in ode.states_to_dolfin(names=["v", "s"])]]
        with pytest.raises(ValueError):
            ode.states_to_dolfin(names=["only_one"])
        with pytest.raises(ValueError):
            ode.assign_all_states([fem_.Function(V)])
        if name == "port":
            assert ode.host_transfers == 2
    for a, b in zip(run["port"], run["jax"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(run["port"][0], v0 - s0 * dt)


def test_dolfin_ode_solver_tp06_matches_jax():
    """TP06 over every node from per-node initial states: the port's B1
    twin against JAX's model, through the transfer hooks."""
    (jm, jV), (tm, tV) = spaces(4)
    n = tV.ndofs
    rng = np.random.default_rng(3)
    init = np.tile(ttp.init_state_values()[:, None], (1, n))
    init[0] += rng.uniform(0.0, 60.0, n)
    params = ttp.init_parameter_values(stim_amplitude=0.0)
    out = {}
    for name, fem_, mod, V, fun, kw in (("jax", jfem, jode, jV, jtp.generalized_rush_larsen, {}),
                                        ("port", tfem, tode, tV, ttp.generalized_rush_larsen, {"device": "cpu"})):
        ode = mod.DolfinODESolver(v_ode=fem_.Function(V), v_pde=fem_.Function(V), init_states=init, parameters=params,
                                  fun=fun, num_states=19, v_index=0, **kw)
        for k in range(8):
            ode.step(0.05 * k, 0.05)
            ode.to_dolfin()
            ode.v_ode.x.array[:] *= 0.999  # a stand-in for diffusion
            ode.from_dolfin()
        out[name] = as_np(ode.full_values).copy()
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-12, atol=1e-11)


def two_marker_pair(funs_params, N=5):
    (jm, jV), (tm, tV) = spaces(N)
    solvers = {}
    for name, fem_, mod, V, kw in (("jax", jfem, jode, jV, {}), ("port", tfem, tode, tV, {"device": "cpu"})):
        markers = fem_.Function(V)
        markers.interpolate(lambda x: np.where(x[0] < 0.5, 1.0, 2.0))
        fun, init, params, vi = funs_params(name)
        solvers[name] = mod.DolfinMultiODESolver(
            v_ode=fem_.Function(V), v_pde=fem_.Function(V), markers=markers, init_states=init, parameters=params,
            fun=fun, num_states={m: len(s) for m, s in init.items()}, v_index=vi, **kw,
        )
    return solvers


def test_dolfin_multi_ode_solver_matches_jax():
    def simple(_):
        return ({1: simple_ode_forward_euler, 2: simple_ode_forward_euler},
                {1: np.array([1.0, 2.0]), 2: np.array([3.0, 4.0])},
                {1: np.array([1, 1]), 2: np.array([2, 2])}, {1: 0, 2: 0})

    s = two_marker_pair(simple)
    mon = PerformanceMonitor(log_frequency=0)
    s["port"].monitor = mon
    for blk in s["port"]._blocks.values():
        blk.stepper.monitor = mon
    out = {}
    for name, ode in s.items():
        assert tuple(ode.full_values.shape) == (2, ode.markers.x.array.size)
        assert tuple(ode.values(1).shape) == ode.shape(1) == (2, int((ode.markers.x.array == 1).sum()))
        assert ode.num_points(2) == int((ode.markers.x.array == 2).sum()) and ode.num_parameters(1) == 2
        ode.step(0.0, 0.1)
        ode.to_dolfin()
        ode.ode_to_pde()
        trace = [ode.v_ode.x.array.copy(), ode.v_pde.x.array.copy()]
        ode.v_pde.x.array[:] = np.linspace(-1.0, 1.0, ode.v_pde.x.array.size)
        ode.pde_to_ode()
        ode.from_dolfin()
        out[name] = trace + [as_np(ode.values(m)).copy() for m in (1, 2)] + [as_np(ode.full_values).copy()] + [
            f.x.array.copy() for f in ode.states_to_dolfin()]
        with pytest.raises(ValueError):
            ode.assign_all_states([])
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    assert {"total_ode_step", "marker_1_ode_step", "marker_2_ode_step", "ode_total_step"} <= set(mon.timings)
    assert s["port"].host_transfers == 2


def test_dolfin_multi_ode_solver_mixed_models_match_jax():
    """TP06 and FitzHugh-Nagumo side by side: different state counts and
    voltage rows, each marker's model stepped on its own nodes (the port:
    B1's twins); no full array exists, as in JAX."""

    def mixed(name):
        tp, fh = (jtp, jfhn) if name == "jax" else (ttp, tfhn)
        return ({1: tp.generalized_rush_larsen, 2: fh.generalized_rush_larsen},
                {1: tp.init_state_values(), 2: fh.init_state_values()},
                {1: tp.init_parameter_values(stim_amplitude=0.0), 2: fh.init_parameter_values()},
                {1: tp.state_index("V"), 2: fh.state_index("v")})

    s = two_marker_pair(mixed)
    for ode in s.values():
        ode.v_ode.x.array[:] = np.linspace(-85.0, 30.0, ode.v_ode.x.array.size)
        ode.from_dolfin()
        for k in range(6):
            ode.step(0.05 * k, 0.05)
        ode.to_dolfin()
        with pytest.raises(RuntimeError, match="differ"):
            ode.full_values
        with pytest.raises(RuntimeError, match="differ"):
            ode.states_to_dolfin()
    for m in (1, 2):
        np.testing.assert_allclose(as_np(s["port"].values(m)), s["jax"].values(m), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s["port"].v_ode.x.array, s["jax"].v_ode.x.array, rtol=1e-12, atol=1e-12)


def test_markers_outside_the_ode_space_raise_as_in_jax():
    (jm, jV), (tm, tV) = spaces(4)
    tother = tfem.functionspace(tmesh.create_unit_square(None, 3, 3), ("P", 1))
    jother = jfem.functionspace(jmesh.create_unit_square(None, 3, 3), ("P", 1))
    for fem_, mod, V, W, kw in ((jfem, jode, jV, jother, {}), (tfem, tode, tV, tother, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="same function space"):
            mod.DolfinMultiODESolver(
                v_ode=fem_.Function(V), v_pde=fem_.Function(V), markers=fem_.Function(W),
                init_states={0: np.zeros(2)}, parameters={0: np.zeros(2)}, fun={0: simple_ode_forward_euler},
                num_states={0: 2}, v_index={0: 0}, **kw)


def test_cross_space_transfer_raises():
    """Projection between spaces of different sizes raises only where the
    JAX package's does: between functions on two different meshes (the
    target's owner cells index the source's mesh, an IndexError in both).
    On one mesh, P2, DG and Quadrature spaces transfer (the adapter's two
    crossings a transfer), and ``space_from_string`` builds them."""
    jcoarse = jfem.functionspace(jmesh.create_unit_square(None, 3, 3), ("P", 1))
    jfine = jfem.functionspace(jmesh.create_unit_square(None, 4, 4), ("P", 1))
    coarse = tfem.functionspace(tmesh.create_unit_square(None, 3, 3), ("P", 1))
    fine = tfem.functionspace(tmesh.create_unit_square(None, 4, 4), ("P", 1))
    with pytest.raises(IndexError):
        jutils.local_project(jfem.Function(jcoarse), jfine)
    with pytest.raises(IndexError):
        tutils.local_project(tfem.Function(coarse), fine, device="cpu")
    mesh = tmesh.create_unit_square(None, 3, 3)
    V1, V2 = tfem.functionspace(mesh, ("P", 1)), tfem.functionspace(mesh, ("P", 2))
    ode = tode.DolfinODESolver(v_ode=tfem.Function(V2), v_pde=tfem.Function(V1), init_states=np.array([1.0, 2.0]),
                               parameters=np.array([1, 1]), fun=simple_ode_forward_euler, num_states=2, device="cpu")
    ode.to_dolfin()
    ode.ode_to_pde()
    np.testing.assert_allclose(ode.v_pde.x.array, 1.0, rtol=1e-14)
    assert ode.host_transfers == 3
    assert tutils.space_from_string("DG_1", mesh).ndofs == 3 * mesh.num_cells
    same = tutils.local_project(tfem.Function(fine), fine)
    assert same.x.array.size == fine.ndofs
