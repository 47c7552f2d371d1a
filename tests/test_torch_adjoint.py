"""The differentiable monodomain solver: ``fenicsx_beat_tpu_torch.adjoint``
against the JAX package's ``adjoint`` in float64 on the CPU (the port on
B8's twin where it takes the lane path).

- ``cg_implicit``: the solution and its gradients with respect to the
  right-hand side and an operator scale, against JAX's; the deprecated
  ``atol`` alias warns and gives the same bits.
- ``build_diff_simulator`` with FitzHugh-Nagumo on the 8x8 unit square,
  30 steps, Godunov and Strang: traces within 1e-9 of max|JAX|, gradients
  with respect to ``g``, ``ionic`` and ``stim_amplitude`` within 1e-6
  relative; the same for fiber/transverse components, the pseudo-ECG
  output, a facet stimulus and a RandomActivation stimulus, and the LV at
  psize 0.8 with its COO tail, on the plain ELL product and on B8's
  combination (twin), both against JAX's ELL path.
- The forward pass equals the port's ``FusedMonodomainSolver`` (theta 1
  and 0.5) to CG tolerance, as JAX's own test holds its simulator to its
  solver.
- Nested checkpointing gives the flat scheme's values and gradients.
- TP06's GRL through the simulator on the dx=1.0 slab for a few steps.
- B8's combination Function: forward, ``dx`` and ``dw`` against the dense
  product, on the twin (no launch counted).

The JAX side of each comparison is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import adjoint as jadj
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.conductivities import as_cell_tensors as j_cell_tensors
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as j_lv
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu_torch import adjoint as tadj
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors as t_cell_tensors
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as t_lv
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.ops import cuda_ell

TRACE_TOL = 1e-9  # of max|JAX trace|: the two frameworks sum in other orders
GRAD_RTOL = 1e-6
F64 = torch.float64


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread: its tensors here are small, and in
    the parallel test run a process whose parallel regions wait on all its
    threads runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDES = {
    "jax": dict(mesh=jmesh, stim=jstim, adj=jadj, fhn=jfhn, cell_tensors=j_cell_tensors),
    "torch": dict(mesh=tmesh, stim=tstim, adj=tadj, fhn=tfhn, cell_tensors=t_cell_tensors),
}


def _square(side: str, nx: int = 8, corner: float = 0.3):
    m = SIDES[side]["mesh"]
    mesh = m.create_unit_square(None, nx, nx)
    cells = m.locate_entities(mesh, 2, lambda x: (x[0] < corner) & (x[1] < corner))
    return mesh, m.meshtags(mesh, 2, cells, 1)


def _window(side: str, mesh, tags, amplitude: float = 30.0, ds: bool = False):
    s = SIDES[side]["stim"]
    measure = s.ds if ds else s.dx
    return s.Stimulus(expr=s.TimeWindow(amplitude=amplitude, start=0.0, duration=1.0),
                      dZ=measure(mesh, subdomain_data=tags), marker=1)


def _build(side: str, mesh, I_s, probes, **kw):
    fhn = SIDES[side]["fhn"]
    extra = {"device": "cpu"} if side == "torch" else {}
    return SIDES[side]["adj"].build_diff_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
        v_index=fhn.state_index("v"), I_s=I_s, probe_points=probes, **kw, **extra)


def _jax_value_and_grad(sim, params: dict, target, key=None):
    def loss(p):
        out = sim(p)
        out = out if key is None else out[key]
        return jnp.mean((out - target) ** 2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    v, g = jax.value_and_grad(loss)(jp)
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _torch_value_and_grad(sim, params: dict, target, key=None):
    tp = {k: torch.tensor(np.asarray(v, dtype=np.float64), requires_grad=True) for k, v in params.items()}
    out = sim(tp)
    out = out if key is None else out[key]
    loss = torch.mean((out - torch.as_tensor(np.array(target))) ** 2)
    loss.backward()
    return float(loss.detach()), {k: x.grad.numpy() for k, x in tp.items()}


def _traces(sim, params: dict, key=None):
    if sim.__module__ == tadj.__name__:
        out = sim({k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in params.items()})
        out = out if key is None else out[key]
        return out.detach().numpy()
    out = sim({k: jnp.asarray(v) for k, v in params.items()})
    return np.asarray(out if key is None else out[key])


def _assert_traces(t, j):
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=TRACE_TOL * np.abs(j).max())


def _assert_grads(tg: dict, jg: dict):
    for k in jg:
        scale = np.abs(jg[k]).max()
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale, err_msg=k)


def _compare(builder, params: dict, perturbed: dict, key=None):
    """Traces at ``params`` and value and gradients at ``perturbed`` of the
    MSE to those traces, port against JAX."""
    sj, st = builder("jax"), builder("torch")
    jt = _traces(sj, params, key)
    _assert_traces(_traces(st, params, key), jt)
    jv, jg = _jax_value_and_grad(sj, perturbed, jt, key)
    tv, tg = _torch_value_and_grad(st, perturbed, jt, key)
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    _assert_grads(tg, jg)
    return tg


# ---------------------------------------------------------------------------


def test_cg_implicit_value_and_gradients_match_jax():
    mesh_j, _ = _square("jax", 6)
    mesh_t, _ = _square("torch", 6)
    mj, kj = jfem.assemble_mass_stiffness_auto(jfem.functionspace(mesh_j, ("P", 1)), 1.0)
    mt, kt = tfem.assemble_mass_stiffness_auto(tfem.functionspace(mesh_t, ("P", 1)), 1.0)
    rng = np.random.default_rng(0)
    n = mj.shape[0]
    b0, w = rng.standard_normal(n), rng.standard_normal(n)

    def jloss(g, b):
        A = mj.with_values(jnp.asarray(mj.vals) + g * jnp.asarray(kj.vals))
        return jnp.vdot(jnp.asarray(w), jadj.cg_implicit(lambda u: A @ u, b, precond_diag=A.diagonal()))

    jx = np.asarray(jadj.cg_implicit(lambda u: mj.with_values(jnp.asarray(mj.vals) + 0.37 * jnp.asarray(kj.vals)) @ u,
                                     jnp.asarray(b0)))
    jdg, jdb = jax.grad(jloss, argnums=(0, 1))(0.37, jnp.asarray(b0))

    g = torch.tensor(0.37, dtype=F64, requires_grad=True)
    b = torch.tensor(b0, requires_grad=True)
    A = mt.with_values(mt.vals + g * kt.vals)
    x = tadj.cg_implicit(lambda u: A @ u, b, precond_diag=A.diagonal())
    np.testing.assert_allclose(x.detach().numpy(), jx, rtol=0, atol=1e-10 * np.abs(jx).max())
    torch.dot(torch.as_tensor(w), x).backward()
    np.testing.assert_allclose(float(g.grad), float(jdg), rtol=GRAD_RTOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb), rtol=0, atol=GRAD_RTOL * np.abs(jdb).max())


def test_cg_implicit_atol_deprecated_alias():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((6, 6))
    A = torch.as_tensor(A @ A.T + 6 * np.eye(6))
    b = torch.as_tensor(rng.standard_normal(6))
    x_new = tadj.cg_implicit(lambda u: A @ u, b, atol_scaled=1e-13)
    with pytest.warns(DeprecationWarning, match="atol_scaled"):
        x_old = tadj.cg_implicit(lambda u: A @ u, b, atol=1e-13)
    assert torch.equal(x_old, x_new)
    np.testing.assert_allclose(x_new.numpy(), np.linalg.solve(A.numpy(), b.numpy()), rtol=1e-8)


def test_cg_implicit_counts_solves_and_syncs():
    A = torch.diag(torch.arange(1.0, 9.0, dtype=F64))
    counts = tadj.CGCounts()
    b = torch.ones(8, dtype=F64, requires_grad=True)
    x = tadj.cg_implicit(lambda u: A @ u, b, precond_diag=torch.diagonal(A), counts=counts)
    x.sum().backward()
    assert counts.forward_solves == 1 and counts.adjoint_solves == 1
    # Jacobi on a diagonal operator converges in one iteration: two exit tests a solve
    assert counts.forward_iterations == 1 and counts.adjoint_iterations == 1 and counts.host_syncs == 4
    np.testing.assert_allclose(b.grad.numpy(), 1.0 / np.arange(1.0, 9.0), rtol=1e-14)


@pytest.mark.parametrize("theta", [1.0, 0.5], ids=["godunov", "strang"])
def test_simulator_matches_jax(theta):
    def builder(side):
        mesh, tags = _square(side)
        return _build(side, mesh, _window(side, mesh, tags), np.array([[0.15, 0.15], [0.7, 0.7]]),
                      dt=0.1, n_steps=30, theta=theta)

    ionic = jfhn.init_parameter_values()
    tg = _compare(builder, {"g": 0.003, "ionic": ionic, "stim_amplitude": 30.0},
                  {"g": 0.002, "ionic": ionic * 1.05, "stim_amplitude": 28.0})
    assert all(np.abs(tg[k]).max() > 0 for k in ("g", "ionic", "stim_amplitude"))


def test_anisotropic_components_match_jax():
    f = np.array([1.0, 0.0])
    K_l = np.outer(f, f)
    K_t = np.eye(2) - K_l

    def builder(side):
        mesh, tags = _square(side)
        return _build(side, mesh, _window(side, mesh, tags), np.array([[0.7, 0.2], [0.2, 0.7]]),
                      dt=0.1, n_steps=20, stiffness_components=[K_l, K_t])

    ionic = jfhn.init_parameter_values()
    tg = _compare(builder, {"g": [0.004, 0.001], "ionic": ionic}, {"g": [0.003, 0.0015], "ionic": ionic})
    assert tg["g"].shape == (2,) and np.all(tg["g"] != 0)


def test_ecg_output_matches_jax():
    def builder(side):
        mesh, tags = _square(side)
        return _build(side, mesh, _window(side, mesh, tags), np.array([[0.5, 0.5]]),
                      electrode_points=np.array([[2.0, 0.5], [-1.0, -1.0]]), dt=0.1, n_steps=20)

    ionic = jfhn.init_parameter_values()
    st = builder("torch")
    out = st({"g": 0.003, "ionic": ionic})
    assert out["probes"].shape == (20, 1) and out["ecg"].shape == (20, 2)
    _compare(builder, {"g": 0.003, "ionic": ionic}, {"g": 0.002, "ionic": ionic}, key="ecg")


def test_facet_stimulus_matches_jax():
    def builder(side):
        m = SIDES[side]["mesh"]
        mesh = m.create_unit_square(None, 8, 8)
        facets = mesh.exterior_facets()
        mids = mesh.coords[mesh.entities(1)[facets]].mean(axis=1)
        tags = m.meshtags(mesh, 1, facets[mids[:, 0] < 1e-10], 1)
        return _build(side, mesh, _window(side, mesh, tags, 40.0, ds=True), np.array([[0.1, 0.5], [0.6, 0.5]]),
                      dt=0.1, n_steps=20)

    ionic = jfhn.init_parameter_values()
    _compare(builder, {"g": 0.004, "ionic": ionic, "stim_amplitude": 40.0},
             {"g": 0.003, "ionic": ionic, "stim_amplitude": 36.0})


def test_random_activation_matches_jax():
    def builder(side):
        m, s = SIDES[side]["mesh"], SIDES[side]["stim"]
        mesh = m.create_unit_square(None, 8, 8)
        tags = m.meshtags(mesh, 2, np.arange(mesh.num_cells), 1)
        expr = s.generate_random_activation(
            mesh=mesh, time=None, points=np.array([[0.25, 0.25], [0.75, 0.75]]), delays=np.array([0.0, 0.5]),
            stim_start=0.0, stim_duration=1.0, stim_amplitude=50.0, tol=0.15)
        I_s = s.Stimulus(expr=expr, dZ=s.dx(mesh, subdomain_data=tags), marker=1)
        return _build(side, mesh, I_s, np.array([[0.25, 0.25], [0.75, 0.75]]), dt=0.1, n_steps=20)

    ionic = jfhn.init_parameter_values()
    tg = _compare(builder, {"g": 0.003, "ionic": ionic, "stim_amplitude": 50.0},
                  {"g": 0.003, "ionic": ionic, "stim_amplitude": 44.0})
    assert float(tg["stim_amplitude"]) != 0.0


# ---------------------------------------------------------------------------
# The LV with its COO tail: the plain ELL product and B8's combination


def _lv_builder(side: str, use_lane_ops: bool = False):
    geo = j_lv(psize_ref=0.8, cache=False) if side == "jax" else t_lv(psize_ref=0.8)
    m = SIDES[side]["mesh"]
    m3 = geo.mesh
    zmin = m3.coords[:, 2].min()
    tags = m.meshtags(m3, 3, m.locate_entities(m3, 3, lambda x: x[2] <= zmin + 2.0), 1)
    s = SIDES[side]["stim"]
    I_s = s.Stimulus(expr=s.TimeWindow(amplitude=50.0, start=0.0, duration=1.0),
                     dZ=s.dx(m3, subdomain_data=tags), marker=1)
    f = np.asarray(geo.f0)
    f = f[m3.cells].mean(axis=1)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    Kf = np.einsum("ci,cj->cij", f, f)
    Kt = np.eye(3)[None] - Kf
    ct = SIDES[side]["cell_tensors"]
    kw = dict(dt=0.1, n_steps=10, stiffness_components=[ct(Kf, m3), ct(Kt, m3)], cg_rtol=1e-11, cg_atol=1e-13)
    if side == "torch":
        kw["use_lane_ops"] = use_lane_ops
    return _build(side, m3, I_s, m3.coords[:: max(1, m3.num_vertices // 5)][:4], **kw)


@pytest.fixture(scope="module")
def lv_jax():
    """JAX's ELL path on the LV: traces at the truth, and the value and
    gradients of the MSE to 0.9 times them at the same parameters."""
    sim = _lv_builder("jax")
    ionic = jfhn.init_parameter_values(stim_amplitude=0.0)
    params = {"g": np.array([0.003, 0.001]), "ionic": ionic}
    traces = _traces(sim, params)
    return params, traces, _jax_value_and_grad(sim, params, traces * 0.9)


@pytest.mark.parametrize("lane", [False, True], ids=["plain_ell", "b8_combination"])
def test_lv_hybrid_tail_matches_jax(lv_jax, lane):
    params, jt, (jv, jg) = lv_jax
    sim = _lv_builder("torch", use_lane_ops=lane)
    assert (sim.lane_combo is not None) == lane
    launches = cuda_ell.csr_spmv.launches
    _assert_traces(_traces(sim, params), jt)
    tv, tg = _torch_value_and_grad(sim, params, jt * 0.9)
    assert cuda_ell.csr_spmv.launches == launches  # CPU tensors: B8's twin, no launch
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    _assert_grads(tg, jg)


def test_lane_ops_refused_on_a_structured_mesh():
    mesh, tags = _square("torch")
    with pytest.raises(ValueError, match="unstructured"):
        _build("torch", mesh, _window("torch", mesh, tags), np.array([[0.5, 0.5]]), dt=0.1, n_steps=2,
               use_lane_ops=True)


def test_lane_combo_function_matches_dense():
    """B8's combination: forward, dx and dw of ``(sum_i w_i K_i) x`` on the
    twin, against the dense product."""
    geo = t_lv(psize_ref=0.8)
    V = tfem.functionspace(geo.mesh, ("P", 1))
    mass, k1 = tfem.assemble_mass_stiffness_auto(V, 1.0)
    _, k2 = tfem.assemble_mass_stiffness_auto(V, np.diag([1.0, 0.2, 0.5]))
    combo = tadj.LaneCombo.pack((mass, k1, k2), torch.device("cpu"), F64)
    dense = torch.stack([torch.as_tensor(_dense(A)) for A in (mass, k1, k2)])
    rng = np.random.default_rng(7)
    n = dense.shape[1]
    w = torch.tensor([2.0, 0.3, 0.05], dtype=F64, requires_grad=True)
    x = torch.tensor(rng.standard_normal(n), requires_grad=True)
    yb = torch.as_tensor(rng.standard_normal(n))
    y = combo.mv(w, x)
    ref = torch.tensordot(w.detach(), dense, dims=1) @ x.detach()
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=0, atol=1e-13 * ref.abs().max().item())
    y.backward(yb)
    wd = w.detach()
    np.testing.assert_allclose(x.grad.numpy(), (torch.tensordot(wd, dense, dims=1).T @ yb).numpy(),
                               rtol=0, atol=1e-13 * float(x.grad.abs().max()))
    np.testing.assert_allclose(w.grad.numpy(), np.array([float(yb @ (K @ x.detach())) for K in dense]), rtol=1e-12)
    np.testing.assert_allclose(combo.diag(wd).numpy(), torch.diagonal(torch.tensordot(wd, dense, dims=1)).numpy(),
                               rtol=1e-15)


def _dense(A) -> np.ndarray:
    from fenicsx_beat_tpu_torch.ops.sparse import operator_to_csr

    return operator_to_csr(A).toarray()


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [1.0, 0.5], ids=["godunov", "strang"])
def test_forward_matches_fused_solver(theta):
    """The simulator's forward pass is the production solver's: probe traces
    equal the port's FusedMonodomainSolver step for step, to CG tolerance."""
    from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver

    mesh, tags = _square("torch", 10)
    probes = np.array([[0.15, 0.15], [0.6, 0.6]])
    n_steps, dt, g = 25, 0.1, 0.003
    params = tfhn.init_parameter_values(stim_amplitude=0.0)
    sim = _build("torch", mesh, _window("torch", mesh, tags), probes, dt=dt, n_steps=n_steps, theta=theta,
                 pde_theta=0.5)
    diff = sim({"g": g, "ionic": params}).numpy()
    solver = FusedMonodomainSolver(
        mesh=mesh, M=g, ode_fun=tfhn.forward_euler, init_states=tfhn.init_state_values(), parameters=params,
        v_index=tfhn.state_index("v"), I_s=_window("torch", mesh, tags), theta=theta, pde_theta=0.5,
        device="cpu", use_kernels=False)
    dofs, wts = tfem.point_evaluation_tables(solver.V, probes)
    fused = []
    solver.solve((0.0, n_steps * dt), dt=dt, save_freq=1,
                 save_callback=lambda t, v: fused.append((v[dofs] * wts).sum(axis=1)))
    np.testing.assert_allclose(diff, np.asarray(fused), rtol=1e-6, atol=1e-6)


def test_nested_checkpointing_matches_flat():
    mesh, tags = _square("torch", 6, 0.4)
    kw = dict(dt=0.1, n_steps=20)
    I_s = _window("torch", mesh, tags)
    flat = _build("torch", mesh, I_s, np.array([[0.2, 0.2]]), **kw)
    nested = _build("torch", mesh, I_s, np.array([[0.2, 0.2]]), checkpoint_segments=4, **kw)
    ionic = tfhn.init_parameter_values()
    grads = []
    for sim in (flat, nested):
        g = torch.tensor(0.003, dtype=F64, requires_grad=True)
        out = sim({"g": g, "ionic": ionic})
        (out**2).sum().backward()
        grads.append((out.detach(), float(g.grad)))
    assert torch.equal(grads[0][0], grads[1][0])
    np.testing.assert_allclose(grads[1][1], grads[0][1], rtol=1e-10)
    with pytest.raises(ValueError, match="divide"):
        _build("torch", mesh, I_s, np.array([[0.2, 0.2]]), checkpoint_segments=7, **kw)({"g": 0.003, "ionic": ionic})


def test_tp06_grl_slab_matches_jax():
    """TP06's GRL (19 states) through the simulator on the dx=1.0 slab, 8
    steps of 0.05 ms, fiber/transverse components."""
    from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as j_slab
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
    from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry as t_slab
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp

    f0 = np.array([1.0, 0.0, 0.0])
    comps = [np.outer(f0, f0), np.eye(3) - np.outer(f0, f0)]

    def builder(side):
        m, s = SIDES[side]["mesh"], SIDES[side]["stim"]
        tp = jtp if side == "jax" else ttp
        geo = (j_slab if side == "jax" else t_slab)(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
        mesh = geo.mesh
        cells = m.locate_entities(mesh, 3, lambda x: (x[0] <= 1.5) & (x[1] <= 1.5) & (x[2] <= 1.5))
        I_s = s.Stimulus(expr=s.TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
                         dZ=s.dx(mesh, subdomain_data=m.meshtags(mesh, 3, cells, 1)), marker=1)
        extra = {"device": "cpu"} if side == "torch" else {}
        return SIDES[side]["adj"].build_diff_simulator(
            mesh, ode_fun=tp.generalized_rush_larsen, init_states=tp.init_state_values(),
            v_index=tp.state_index("V"), I_s=I_s, probe_points=np.array([[1.0, 1.0, 1.0], [4.0, 3.0, 1.0]]),
            dt=0.05, n_steps=8, stiffness_components=comps, **extra)

    ionic = jtp.init_parameter_values(stim_amplitude=0.0)
    _compare(builder, {"g": [0.002, 0.0006], "ionic": ionic}, {"g": [0.0015, 0.0008], "ionic": ionic})
