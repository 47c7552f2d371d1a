"""The biventricle (A9's rest) against the JAX package, f64 on the CPU.

- ``get_biv_ellipsoid_geometry`` at psize 0.8: coordinates, cells and facet
  tags equal, ``f0``, ``s0`` and ``n0`` within 1e-8; and at psize 0.35
  (9,506 nodes), where the fibers' Laplace solve takes SA-AMG;
- ``laplace_solve`` on ``"auto"`` on the N=80 unit square (6,561 dofs,
  JAX's ``tests/test_utils.py:200-228``): AMG engages and the solution is
  within 1e-8 of JAX's;
- ``expand_layer_biv`` at psize 0.35 (both solves on AMG): labels equal;
- the geometry cache: a second call reads the first's file, equal bit for
  bit, in the port's own cache directory;
- ``CheckpointWriter`` files read by the other package's
  ``load_checkpoint``, both ways;
- ``demos/biv_endocardial.py``'s choreography at its ``--quick`` mesh
  (psize 0.7, 5 activation points), built through JAX's API as the demo
  builds it (lines 49-197) and through the port's
  ``benchmarks/biv_endocardial.py``, both started from the same ToR-ORd
  states (each layer's ``init_state_values()``: the test's time allows no
  pre-pacing, which is a beat of 20,000 single-cell steps per layer), over
  10 ms (every picked node fires): the voltage at each 1 ms checkpoint
  within 1e-6 mV, the 12 leads within 1e-6 of their largest magnitude and
  every node's activation time within one dt.
"""

import numpy as np
import pytest
import torch

import fenicsx_beat_tpu as jbeat
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import io as jio
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import utils as jutils
from fenicsx_beat_tpu.geometry import get_biv_ellipsoid_geometry as j_biv
from fenicsx_beat_tpu.models import torord_dyncl as jtorord
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import io as tio
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import utils as tutils
from fenicsx_beat_tpu_torch.benchmarks import biv_endocardial as tdemo
from fenicsx_beat_tpu_torch.geometry import get_biv_ellipsoid_geometry as t_biv
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as t_lv
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttorord

DT = 0.05
DEMO_T = 10.0
V_ATOL = 1e-6  # mV, at each checkpoint
LEAD_REL = 1e-6  # of each lead's largest magnitude


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def solves(monkeypatch):
    """The :class:`LaplaceInfo` of every Laplace solve the port makes."""
    infos, solve = [], tutils._laplace_solve

    def recording(*args, **kwargs):
        u, info = solve(*args, **kwargs)
        infos.append(info)
        return u, info

    monkeypatch.setattr(tutils, "_laplace_solve", recording)
    return infos


def assert_same_geometry(j, t, fiber_tol=1e-8):
    np.testing.assert_array_equal(t.mesh.coords, j.mesh.coords)
    np.testing.assert_array_equal(t.mesh.cells, j.mesh.cells)
    np.testing.assert_array_equal(t.ffun.indices, j.ffun.indices)
    np.testing.assert_array_equal(t.ffun.values, j.ffun.values)
    assert t.markers == j.markers == {"BASE": (5, 2), "LV": (6, 2), "RV": (7, 2), "EPI": (8, 2)}
    for name in ("f0", "s0", "n0"):
        assert np.abs(getattr(t, name) - getattr(j, name)).max() <= fiber_tol, name


@pytest.mark.parametrize("psize, precond", [(0.8, "jacobi"), (0.35, "amg")])
def test_biv_geometry_equals_jax(psize, precond, solves):
    j = j_biv(psize_ref=psize, cache=False)
    t = t_biv(psize_ref=psize, cache=False, device="cpu")
    assert [(i.precond, i.converged) for i in solves] == [(precond, True)]
    assert_same_geometry(j, t)
    assert set(np.unique(t.ffun.values)) == {5, 6, 7, 8}


def test_laplace_auto_takes_amg_on_the_unit_square():
    """JAX's ``test_laplace_solve_amg_matches_jacobi`` setup: x = 0 held at
    0, x = 1 at 1; "auto" takes AMG at 6,561 dofs, the solution within
    1e-8 of JAX's and of the port's Jacobi solve, and linear in x."""
    sides = {}
    for name, mm, fem, ut in (("jax", jmesh, jfem, jutils), ("port", tmesh, tfem, tutils)):
        mesh = mm.create_unit_square(None, 80, 80)
        lo = mm.locate_entities_boundary(mesh, 1, lambda x: x[0] <= 1e-8)
        hi = mm.locate_entities_boundary(mesh, 1, lambda x: x[0] >= 1 - 1e-8)
        V = fem.functionspace(mesh, ("P", 1))
        bcs = [fem.dirichletbc(0.0, fem.locate_dofs_topological(V, 1, lo), V),
               fem.dirichletbc(1.0, fem.locate_dofs_topological(V, 1, hi), V)]
        sides[name] = (mesh, V, bcs, ut)
    ref = jutils.laplace_solve(sides["jax"][1], sides["jax"][2])
    mesh, V, bcs, _ = sides["port"]
    got, info = tutils._laplace_solve(V, bcs, device="cpu")
    assert info.precond == "amg" and info.converged and info.amg_levels >= 2
    np.testing.assert_array_equal(tutils.laplace_solve(V, bcs, device="cpu"), got)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    jac, info = tutils._laplace_solve(V, bcs, precond="jacobi", device="cpu")
    assert info.precond == "jacobi"
    np.testing.assert_allclose(got, jac, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, mesh.coords[:, 0], rtol=0, atol=1e-6)


def test_expand_layer_biv_labels_equal_jax(solves):
    j = j_biv(psize_ref=0.35, cache=False)
    t = t_biv(psize_ref=0.35, cache=False, device="cpu")
    del solves[:]
    kw = dict(endo_lv_marker=6, endo_rv_marker=7, epi_marker=8, endo_size=0.3, epi_size=0.3,
              output_mid_marker=0, output_endo_marker=1, output_epi_marker=2)
    jl = jutils.expand_layer_biv(V=jfem.functionspace(j.mesh, ("P", 1)), ft=j.ffun, **kw)
    tl = tutils.expand_layer_biv(tfem.functionspace(t.mesh, ("P", 1)), t.ffun, device="cpu", **kw)
    assert [i.precond for i in solves] == ["amg", "amg"]
    assert tl.dtype == np.int32
    np.testing.assert_array_equal(tl, np.asarray(jl.x.array).astype(np.int32))
    assert set(np.unique(tl)) == {0, 1, 2}


def test_geometry_cache_roundtrip(tmp_path, monkeypatch):
    """``cache=True`` stores the BiV and the LV under the port's cache
    directory and a second call reads them back, equal bit for bit to a
    build without the cache."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    slots = tmp_path / "fenicsx_beat_tpu_torch" / "geometry"
    for build, kw in ((t_biv, dict(psize_ref=0.8, device="cpu")), (t_lv, dict(psize_ref=0.83, fiber_angle_endo=50.0))):
        cold = build(cache=False, **kw)
        n = len(list(slots.glob("*.npz"))) if slots.is_dir() else 0
        build(**kw)  # populates
        assert len(list(slots.glob("*.npz"))) == n + 1
        warm = build(**kw)
        for name in ("f0", "s0", "n0"):
            assert np.array_equal(getattr(cold, name), getattr(warm, name))
        assert np.array_equal(cold.mesh.coords, warm.mesh.coords)
        assert np.array_equal(cold.mesh.cells, warm.mesh.cells)
        assert np.array_equal(cold.ffun.indices, warm.ffun.indices)
        assert np.array_equal(cold.ffun.values, warm.ffun.values)
        assert cold.markers == warm.markers and warm.mesh.cell_type == cold.mesh.cell_type


def test_checkpoints_cross_read(tmp_path):
    """Each package's ``CheckpointWriter`` file read by the other's
    ``load_checkpoint``: times, float32 values, mesh arrays, cell type."""
    rng = np.random.default_rng(4)
    for write_mm, write_io, read_io in ((tmesh, tio, jio), (jmesh, jio, tio)):
        mesh = write_mm.create_unit_square(None, 3, 3)
        frames = [rng.standard_normal(mesh.num_vertices) for _ in range(3)]
        path = tmp_path / f"v_{write_io.__name__.split('.')[0]}"
        with write_io.CheckpointWriter(path, mesh) as w:
            for k, f in enumerate(frames):
                w.write(0.5 * k, f)
        data = read_io.load_checkpoint(path)
        np.testing.assert_array_equal(data.times, [0.0, 0.5, 1.0])
        assert data.values.dtype == np.float32
        np.testing.assert_array_equal(data.values, np.stack(frames).astype(np.float32))
        np.testing.assert_array_equal(data.coords, mesh.coords)
        np.testing.assert_array_equal(data.cells, mesh.cells)
        assert data.cell_type == "triangle"


# ----------------------------------------------------------------------
# the demo's choreography
# ----------------------------------------------------------------------
def jax_demo(psize, n_points, T, steady, outdir):
    """``demos/biv_endocardial.py:49-197`` through JAX's API, from
    ``steady`` (marker -> states), with host activation stamps each step.
    Returns (checkpoint data, leads by name, activation times)."""
    geo = j_biv(psize_ref=psize, cache=False)
    mesh, ffun = geo.mesh, geo.ffun
    V = jfem.functionspace(mesh, ("P", 1))
    layers = jbeat.utils.expand_layer_biv(V=V, ft=ffun, endo_lv_marker=6, endo_rv_marker=7, epi_marker=8,
                                          endo_size=0.3, epi_size=0.3, output_mid_marker=0, output_endo_marker=1,
                                          output_epi_marker=2)
    model = jtorord
    celltypes = {0: 2.0, 1: 0.0, 2: 1.0}
    parameters = {m: model.init_parameter_values(i_Stim_Amplitude=0.0, celltype=ct) for m, ct in celltypes.items()}
    rng = np.random.default_rng(42)
    endo_facets = np.concatenate([ffun.find(6), ffun.find(7)])
    endo_verts = np.unique(mesh.entities(2)[endo_facets].ravel())
    picks = rng.choice(endo_verts, size=min(n_points, endo_verts.size), replace=False)
    delays = rng.uniform(0.0, 4.0, size=len(picks))
    time = jfem.Constant(0.0)
    activation = jbeat.stimulation.generate_random_activation(
        mesh=mesh, time=time, points=mesh.coords[picks], delays=delays, stim_start=0.0, stim_duration=2.0,
        stim_amplitude=50_000.0 / 1400.0, tol=0.7 * psize)
    cells = jmesh.locate_entities(mesh, mesh.tdim, lambda x: np.ones(x.shape[1], dtype=bool))
    dx = jbeat.stimulation.dx(mesh, subdomain_data=jmesh.meshtags(mesh, mesh.tdim, cells, 1))
    I_s = jbeat.Stimulus(expr=activation, dZ=dx, marker=1)
    conds = jbeat.conductivities.default_conductivities("Niederer")
    M = jbeat.conductivities.define_conductivity_tensor(f0=geo.f0, **conds)
    pde = jbeat.MonodomainModel(time=time, mesh=mesh, M=M, I_s=I_s)
    ode = jbeat.odesolver.DolfinMultiODESolver(
        v_ode=jfem.Function(V), v_pde=pde.state, markers=layers,
        num_states={m: len(model.init_state_values()) for m in celltypes},
        fun={m: model.generalized_rush_larsen for m in celltypes}, init_states=steady, parameters=parameters,
        v_index={m: model.state_index("v") for m in celltypes})
    solver = jbeat.MonodomainSplittingSolver(pde=pde, ode=ode)
    act = np.full(V.ndofs, -1.0)
    checkpoint = outdir / "voltage"
    save_every = int(1.0 / DT)
    t, step = 0.0, 0
    with jio.CheckpointWriter(checkpoint, mesh) as writer:
        writer.write(0.0, pde.state.x.array)
        while step < int(round(T / DT)):
            solver.step((t, t + DT))
            v = np.asarray(pde.state.x.array)
            act[(v > 0.0) & (act < 0)] = t
            t += DT
            step += 1
            if step % save_every == 0:
                writer.write(t, pde.state.x.array)
    data = jio.load_checkpoint(checkpoint)
    vfun = jfem.Function(V)
    ecg = jbeat.ECGRecovery(v=vfun, sigma_b=1.0, M=M)
    forms = {k: ecg.eval(p) for k, p in tdemo.LEADS.items()}
    traces = {k: [] for k in tdemo.LEADS}
    for frame in data.values:
        vfun.x.array[:] = frame
        ecg.solve()
        for k, form in forms.items():
            traces[k].append(float(jfem.assemble_scalar(form)))
    leads = jbeat.ecg.Leads12(**{k: np.array(tr) for k, tr in traces.items()})
    return data, {n: getattr(leads, n) for n in tdemo.LEAD_NAMES}, act, picks


def test_biv_demo_matches_jax(tmp_path):
    q = tdemo.QUICK
    steady_j = {m: jtorord.init_state_values() for m in (0, 1, 2)}
    steady_t = {m: ttorord.init_state_values() for m in (0, 1, 2)}
    for m in steady_j:
        np.testing.assert_array_equal(steady_t[m], steady_j[m])
    data_j, leads_j, act_j, picks_j = jax_demo(q["psize"], q["n_activation_points"], DEMO_T, steady_j, tmp_path)

    setup = tdemo.biv_setup(q["psize"], q["n_activation_points"], device="cpu", cache=False)
    np.testing.assert_array_equal(setup.picks, picks_j)
    solver = tdemo.build_biv(setup, steady_t, device="cpu")
    res = tdemo.run_biv(solver, DEMO_T, DT, checkpoint=tmp_path / "port_voltage", verbose=False)
    times, leads, stats = tdemo.biv_ecg(setup.V, setup.M, res.checkpoint, device="cpu")
    data_t = tio.load_checkpoint(res.checkpoint)

    assert res.all_finite and stats["frames"] == data_j.values.shape[0] == int(DEMO_T) + 1
    np.testing.assert_allclose(times, data_j.times, rtol=0, atol=1e-9)
    # the float32 checkpoint files: the port's float64 voltage rounded as JAX's is
    v_t = np.stack([np.asarray(f, np.float64) for f in data_t.values])
    assert np.abs(v_t - data_j.values.astype(np.float64)).max() <= V_ATOL + 2 * np.spacing(np.float32(100.0))
    for name in tdemo.LEAD_NAMES:
        ref = leads_j[name]
        assert np.abs(getattr(leads, name) - ref).max() <= LEAD_REL * np.abs(ref).max(), name
        assert np.isfinite(ref).all() and np.ptp(ref) > 0
    fired = act_j >= 0
    np.testing.assert_array_equal(res.activation >= 0, fired)
    assert np.abs(res.activation[fired] - act_j[fired]).max() <= DT + 1e-9
    assert fired[picks_j].all()  # every picked endocardial node fired by 10 ms
    rv = tdemo.rv_free_wall(setup.geo.mesh.coords)
    assert fired[rv].any() and fired[~rv].any()
