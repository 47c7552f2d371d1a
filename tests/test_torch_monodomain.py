"""The port's object-oriented monodomain model (``MonodomainModel`` on
``BaseModel``) against the JAX package's, and on its own against the
manufactured solution of ``tests/test_monodomain.py``.

Parity: the unit square (N=8) and the 4x4x4 cube, a scalar and an
anisotropic tensor M, a marked ``TimeWindow`` stimulus and the general
space-time source of the MMS problem, five steps and then a dt change;
both sides at the "direct" profile's rtol 1e-13 in float64, the states
within 1e-10.  The port steps through the theta system the fused solver
uses (on the CPU its kernels' twins), the general source assembled on the
device through B8's twin.  MMS: the P1 cases of ``test_monodomain_analytic``
and the P1 spatial (order 2) and temporal (Crank-Nicolson, order 2)
rates, with the reference's thresholds; a capped CG reports
``Status.NOT_CONVERGING``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fenicsx_beat_tpu as jbeat
import fenicsx_beat_tpu_torch as tbeat
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.base_model import Status

PARITY_ATOL = 1e-10


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


def jax_source(x, t):
    return jnp.cos(2 * jnp.pi * x[0]) * jnp.cos(2 * jnp.pi * x[1]) * (jnp.cos(t) + 8 * jnp.pi**2 * jnp.sin(t))


def torch_source(x, t, k=8.0):
    return torch.cos(2 * torch.pi * x[0]) * torch.cos(2 * torch.pi * x[1]) * (torch.cos(t) + k * torch.pi**2 * torch.sin(t))


def exact(x, t):
    return np.cos(2 * np.pi * x[0]) * np.cos(2 * np.pi * x[1]) * np.sin(t)


def l2_error(state, T):
    form = tfem.function_integral(state, lambda x, u: (u - exact(x, T)) ** 2, degree=8)
    return np.sqrt(tfem.assemble_scalar(form))


def build_pair(mesh_kind, M_kind, stim_kind):
    """The same model in both packages: ``(jax_model, port_model)``."""
    if mesh_kind == "square":
        jm, tm = jmesh.create_unit_square(None, 8, 8), tmesh.create_unit_square(None, 8, 8)
    else:
        jm, tm = jmesh.create_unit_cube(None, 4, 4, 4), tmesh.create_unit_cube(None, 4, 4, 4)
    g = tm.gdim
    if M_kind == "scalar":
        M = 0.7
    else:
        A = np.random.default_rng(1).standard_normal((g, g)) * 0.2
        M = np.diag(np.linspace(1.0, 0.4, g)) + A @ A.T
    models = []
    for pkg, m, fem_ in ((jbeat, jm, jfem), (tbeat, tm, tfem)):
        mm = jmesh if pkg is jbeat else tmesh
        kw = {} if pkg is jbeat else {"device": "cpu"}
        if stim_kind == "window":
            cells = mm.locate_entities(m, m.tdim, lambda x: np.logical_and(x[0] <= 0.3, x[1] <= 0.3))
            tags = mm.meshtags(m, m.tdim, cells, 1)
            dx = pkg.stimulation.dx(m, subdomain_data=tags)
            expr = pkg.stimulation.TimeWindow(amplitude=80.0, start=0.0, duration=0.0025)
            I_s = pkg.Stimulus(expr=expr, dZ=dx, marker=1)
        else:
            I_s = jax_source if pkg is jbeat else torch_source
        models.append(pkg.MonodomainModel(time=fem_.Constant(0.0), mesh=m, M=M, I_s=I_s, **kw))
    return models


@pytest.mark.parametrize(
    "mesh_kind, M_kind, stim_kind",
    [("square", "scalar", "window"), ("square", "tensor", "general"),
     ("cube", "scalar", "general"), ("cube", "tensor", "window")],
)
def test_model_matches_jax(mesh_kind, M_kind, stim_kind):
    jm, tm = build_pair(mesh_kind, M_kind, stim_kind)
    dt, dt2 = 1e-3, 2.5e-3
    for model in (jm, tm):
        res = model.solve((0.0, 5 * dt), dt=dt)
        assert res.status.name == "OK"
    assert tm.host_transfers == 10  # v_ in and the solution out, each step
    np.testing.assert_allclose(tm.state.x.array, jm.state.x.array, rtol=0, atol=PARITY_ATOL)
    assert np.abs(tm.state.x.array).max() > 1e-4  # the stimulus reached the state
    # a dt change: the operators of the new dt, the window off or the source on
    for model in (jm, tm):
        model.assign_previous()
        model.solve((5 * dt, 5 * dt + 2 * dt2), dt=dt2)
    np.testing.assert_allclose(tm.state.x.array, jm.state.x.array, rtol=0, atol=PARITY_ATOL)
    assert float(tm.time.value) == pytest.approx(float(jm.time.value), abs=1e-15)


def stencil_matvec(S, x):
    """``S x`` for the JAX package's ``StencilMatrix`` (values ``[n, K]``,
    row i reading ``x[i + offset]``), in numpy."""
    vals, y, n = np.asarray(S.vals), np.zeros_like(x), x.size
    for k, d in enumerate(S.offsets):
        lo, hi = max(0, -d), min(n, n - d)
        y[lo:hi] += vals[lo:hi, k] * x[lo + d:hi + d]
    return y


@pytest.mark.parametrize("mesh_kind", ["square", "cube"])
def test_variational_forms_are_the_theta_system_operators(mesh_kind):
    """The port's ``variational_forms(dt)`` (the theta system's device
    operators) applied to a vector equal JAX's mass and stiffness combined
    by the theta rule."""
    jm, tm = build_pair(mesh_kind, "tensor", "window")
    dt, th = 0.05, float(tm.parameters["theta"])
    mass, stiff = jm.variational_forms(dt)
    A, B = tm.variational_forms(dt)
    x = np.random.default_rng(3).standard_normal(tm.V.ndofs)
    Mx, Kx = stencil_matvec(mass, x), stencil_matvec(stiff, x)
    for op, want in ((A, tm.C_m * Mx + th * dt * Kx), (B, tm.C_m * Mx - (1.0 - th) * dt * Kx)):
        np.testing.assert_allclose(tm._pde.apply(op, torch.tensor(x)).numpy(), want, rtol=0, atol=1e-12)


def test_general_load_matches_jax_assembly():
    """``CellQuadData.assemble_load`` of a general expression on the port's
    device path (B8's twin as the cell-to-dof sum) against JAX's
    scatter-add, cells and facets, at two times."""
    jm, tm = jmesh.create_unit_cube(None, 3, 3, 3), tmesh.create_unit_cube(None, 3, 3, 3)
    jV, tV = jfem.functionspace(jm, ("P", 1)), tfem.functionspace(tm, ("P", 1))
    np.testing.assert_array_equal(tV.tabulate_dof_coordinates(), jV.tabulate_dof_coordinates())
    for jq, tq in ((jfem.cell_quadrature(jV, degree=4), tfem.cell_quadrature(tV, degree=4)),
                   (jfem.facet_quadrature(jV, jm.exterior_facets(), degree=4),
                    tfem.facet_quadrature(tV, tm.exterior_facets(), degree=4))):
        for t in (0.3, 1.7):
            bj = np.asarray(jq.assemble_load(lambda x, t: jnp.sin(t + x[0]) * x[1] + x[2] ** 2, t))
            bt = tq.assemble_load(lambda x, t: torch.sin(t + x[0]) * x[1] + x[2] ** 2, t, device="cpu")
            np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-14)


@pytest.mark.parametrize(
    "M, k, err",
    ((0.0, 0.0, 1e-4), (1.0, 8.0, 2e-4), (2.0, 16.0, 2e-4)),
)
def test_monodomain_analytic(M, k, err):
    N, dt = 15, 0.001
    T = 10 * dt
    model = tbeat.MonodomainModel(
        time=tfem.Constant(0.0), mesh=tmesh.create_unit_square(None, N, N), M=M,
        I_s=lambda x, t: torch_source(x, t, k), params=dict(theta=0.5, linear_solver_type="direct"), device="cpu",
    )
    res = model.solve((0, T), dt=dt)
    assert res.status == Status.OK
    assert l2_error(res.state, T) < err


def test_monodomain_spatial_convergence():
    dt = 0.001
    T = 10 * dt
    errors = []
    for N in (4, 8, 16, 32):
        model = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=tmesh.create_unit_square(None, N, N), M=1.0,
                                      I_s=torch_source, params=dict(theta=0.5), device="cpu")
        errors.append(l2_error(model.solve((0, T), dt=dt).state, T))
    rates = [np.log(e1 / e2) / np.log(2) for e1, e2 in zip(errors[:-1], errors[1:])]
    assert all(rate >= 2.0 for rate in rates), (rates, errors)


def test_monodomain_temporal_convergence():
    T, N = 1.0, 100
    mesh = tmesh.create_unit_square(None, N, N)
    errors = []
    for dt in (1.0, 0.5, 0.25, 0.125):
        model = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, I_s=torch_source,
                                      params=dict(theta=0.5), device="cpu")
        errors.append(l2_error(model.solve((0, T), dt=dt).state, T))
    rates = [np.log(e1 / e2) / np.log(2) for e1, e2 in zip(errors[:-1], errors[1:])]
    assert all(rate >= 2.0 for rate in rates), (rates, errors)


def test_solve_returns_not_converging_when_cg_capped():
    mesh = tmesh.create_unit_square(None, 8, 8)

    def ones(x, t):
        return torch.ones_like(x[0])

    capped = tbeat.MonodomainModel(
        time=tfem.Constant(0.0), mesh=mesh, M=1.0, I_s=ones,
        params={"petsc_options": {"ksp_rtol": 1e-14, "ksp_atol": 1e-16, "ksp_max_it": 1}}, device="cpu",
    )
    assert capped.solve((0.0, 0.2), dt=0.1).status == Status.NOT_CONVERGING
    healthy = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, I_s=ones, device="cpu")
    assert healthy.solve((0.0, 0.2), dt=0.1).status == Status.OK


def test_solver_tolerances_and_unused_kwargs(caplog):
    """The "direct" profile's rtol 1e-13 in float64; in float32 clamped to
    rtol 1e-6 and atol 1e-8 (unclamped, the CG never meets it and runs
    ksp_max_it iterations a step); unknown keywords warn."""
    mesh = tmesh.create_unit_square(None, 4, 4)
    f64 = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, device="cpu", bogus=1)
    assert "bogus=1" in caplog.text
    assert f64._solver_tolerances() == (1e-13, 1e-14, 10_000)
    f32 = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, device="cpu", dtype=torch.float32)
    assert f32._solver_tolerances() == (1e-6, 1e-8, 10_000)
    res = f32.solve((0.0, 0.3), dt=0.1)
    assert res.status == Status.OK and f32._pde.host_syncs < 3 * 100
    it = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, device="cpu", dtype=torch.float32,
                               params={"petsc_options": {"ksp_type": "cg", "ksp_rtol": 1e-9, "ksp_max_it": 50}})
    assert it._solver_tolerances() == (1e-6, 1e-8, 50)


def test_unstructured_mesh_runs_the_csr_path():
    """A mesh whose operator is no stencil (the cube's nodes shuffled)
    takes the CSR path (B8's twin) and gives the structured run's states."""
    mesh = tmesh.create_unit_cube(None, 4, 4, 4)
    perm = np.random.default_rng(0).permutation(mesh.num_vertices)
    inv = np.argsort(perm)
    shuffled = tmesh.Mesh(coords=mesh.coords[perm], cells=inv[mesh.cells].astype(mesh.cells.dtype),
                          cell_type=mesh.cell_type)
    runs = []
    for m in (mesh, shuffled):
        model = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=m, M=1.0, I_s=torch_source, device="cpu")
        model.solve((0.0, 0.003), dt=0.001)
        runs.append((model._pde.structured, model.state.x.array.copy()))
    assert runs[0][0] and not runs[1][0]
    np.testing.assert_allclose(runs[1][1][inv], runs[0][1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("shuffled", [False, True])
def test_theta_system_products_can_be_rerouted(shuffled):
    """The solve calls the theta system's products through its attributes
    (``spmv`` / ``spmv_dir_dot`` on the stencil path with the twins,
    ``csr_spmv`` on the CSR path), so a check that routes them through
    another summation order (``chip_smoke.py``, ``kernel_check``) takes
    effect."""
    mesh = tmesh.create_unit_cube(None, 3, 3, 3)
    if shuffled:
        perm = np.random.default_rng(1).permutation(mesh.num_vertices)
        mesh = tmesh.Mesh(coords=mesh.coords[perm], cells=np.argsort(perm)[mesh.cells].astype(mesh.cells.dtype),
                          cell_type=mesh.cell_type)
    model = tbeat.MonodomainModel(time=tfem.Constant(0.0), mesh=mesh, M=1.0, I_s=torch_source, device="cpu",
                                  use_kernels=False)
    pde, calls = model._pde, []
    names = ("csr_spmv",) if shuffled else ("spmv", "spmv_dir_dot")
    for name in names:
        fn = getattr(pde, name)
        setattr(pde, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    model.solve((0.0, 0.002), dt=0.001)
    assert pde.structured == (not shuffled) and set(calls) == set(names)


def test_random_activation_matches_jax():
    """``generate_random_activation`` evaluated on torch tensors against
    the JAX pattern at the mesh's nodes over its delayed windows, ``near``
    on both array kinds, mismatched inputs raising as in JAX, and a model
    driven by the pattern against JAX's."""
    rng = np.random.default_rng(4)
    mesh_j, mesh_t = jmesh.create_unit_square(None, 8, 8), tmesh.create_unit_square(None, 8, 8)
    points = mesh_t.coords[rng.choice(mesh_t.num_vertices, 5, replace=False)]
    delays = rng.uniform(0.0, 0.004, 5)
    kw = dict(points=points, delays=delays, stim_start=0.001, stim_duration=0.002, stim_amplitude=30.0)
    jpat = jbeat.stimulation.generate_random_activation(mesh_j, None, **kw)
    tpat = tbeat.stimulation.generate_random_activation(mesh_t, None, **kw)
    x = np.zeros((3, mesh_t.num_vertices))
    x[:2] = mesh_t.coords.T
    on = 0.001 + delays.min() + 1e-4  # inside the earliest point's window
    for t in (0.0, on, 0.003, 0.006):
        want = np.asarray(jpat(jnp.asarray(x), t))
        got = tpat(torch.tensor(x), torch.tensor(t, dtype=torch.float64)).numpy()
        np.testing.assert_array_equal(got, want)
    assert tpat(torch.tensor(x), torch.tensor(on, dtype=torch.float64)).sum() > 0
    with pytest.raises(AssertionError):
        tbeat.stimulation.generate_random_activation(mesh_t, None, points=points, delays=delays[:3])
    a = np.array([0.0, 1e-13, 0.1])
    np.testing.assert_array_equal(tbeat.stimulation.near(torch.tensor(a), 0.0).numpy(), [True, True, False])
    np.testing.assert_array_equal(tbeat.stimulation.near(a, 0.0), [True, True, False])
    # at the quadrature points (never a node) the pattern needs a tolerance of a cell's size
    wide = dict(kw, tol=0.1)
    jpat = jbeat.stimulation.generate_random_activation(mesh_j, None, **wide)
    tpat = tbeat.stimulation.generate_random_activation(mesh_t, None, **wide)
    models = [pkg.MonodomainModel(time=fem_.Constant(0.0), mesh=m, M=1.0, I_s=pat, **k)
              for pkg, fem_, m, pat, k in ((jbeat, jfem, mesh_j, jpat, {}), (tbeat, tfem, mesh_t, tpat, {"device": "cpu"}))]
    for model in models:
        model.solve((0.0, 0.005), dt=0.001)
    np.testing.assert_allclose(models[1].state.x.array, models[0].state.x.array, rtol=0, atol=PARITY_ATOL)
    assert np.abs(models[1].state.x.array).max() > 0
