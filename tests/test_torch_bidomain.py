"""The bidomain slice: the port's BidomainSolver against the JAX package's,
in f64 on the CPU (the port on its kernels' twins).

Same inputs on both sides (meshes, conductivities, stimuli and models built
by each package from the same numbers); at every save point ``v`` and
``u_e`` within 1e-8 of their largest magnitude, and the CG iterations of
every chunk's worst step equal:

- FitzHugh-Nagumo on the unit square at nx = 8 and 16, monolithic and
  Gauss-Seidel, Godunov and Strang, the DCT and Jacobi u-block
  preconditioners (the stencil path: B1 and B5's twins);
- the same against the JAX solver on its Pallas ionic kernel (interpret
  mode);
- FHN marker layers (B7's twin) against JAX's masked composition;
- TP06 on the Niederer slab at dx = 1 (``bidomain_scale.slab_solver``,
  672 nodes);
- FHN on the psize 0.8 LV with Jacobi (B8's twin).

Also: the proportional-conductivity reduction to the port's own fused
monodomain solver, a starved CG reporting ``NOT_CONVERGING``, the float32
tolerance floor, and the refusals (``u_precond``, ``scheme``,
``u_solve_every``, ``u_amg_opts``); where the JAX package takes SA-AMG the
port takes it too (``tests/test_torch_bidomain_amg.py`` holds its runs).
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.bidomain import BidomainSolver as JBidomain
from fenicsx_beat_tpu.conductivities import conductivity_tensor as jtensor
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as tbs
from fenicsx_beat_tpu_torch.bidomain import BidomainSolver as TBidomain
from fenicsx_beat_tpu_torch.conductivities import conductivity_tensor as ttensor
from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver as TFused
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as tlv
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.ops import cuda_ode, cuda_stencil
from torch_bidomain_reference import IterMonitor, jax_slab_solver

REL = 1e-8
SIDES = {"jax": (jmesh, jstim, jfhn, JBidomain), "port": (tmesh, tstim, tfhn, TBidomain)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def square(side, nx, amp=30.0, markers=False):
    """FHN on the unit square with unequal anisotropy ratios and a corner
    stimulus; with ``markers``, two FHN layers (x above 0.5 recovers
    faster)."""
    mm, st, fhn, _ = SIDES[side]
    mesh = mm.create_unit_square(None, nx, nx)
    cells = mm.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    I_s = st.Stimulus(expr=st.TimeWindow(amplitude=amp, start=0.0, duration=1.0),
                      dZ=st.dx(mesh, subdomain_data=mm.meshtags(mesh, 2, cells, 1)), marker=1)
    kw = dict(mesh=mesh, M_i=np.diag([0.004, 0.0004]), M_e=np.diag([0.002, 0.0035]), I_s=I_s)
    if markers:
        kw.update(ode_fun={0: fhn.forward_euler, 1: fhn.forward_euler},
                  init_states={m: fhn.init_state_values() for m in (0, 1)},
                  parameters={0: fhn.init_parameter_values(stim_amplitude=0.0),
                              1: fhn.init_parameter_values(stim_amplitude=0.0, b=0.03)},
                  v_index={0: 1, 1: 1}, ode_markers=(mesh.coords[:, 0] > 0.5).astype(np.int64))
    else:
        kw.update(ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
                  parameters=fhn.init_parameter_values(stim_amplitude=0.0), v_index=1)
    return kw


def run(solver, T, dt, save_freq):
    mon = IterMonitor()
    solver.monitor = mon
    saves = []
    status = solver.solve((0.0, T), dt=dt, save_freq=save_freq,
                          save_callback=lambda t, v, u: saves.append((t, np.array(v), np.array(u))))
    return saves, mon.iters, status


def assert_same(jax_run, port_run):
    (sj, ij, stj), (sp, ip, stp) = jax_run, port_run
    assert stp == Status.OK and stj.name == "OK"
    assert ip == ij
    assert len(sp) == len(sj) > 1
    for (tj, vj, uj), (tp, vp, up) in zip(sj, sp):
        assert tp == pytest.approx(tj, abs=1e-12)
        assert np.abs(vp - vj[: vp.size]).max() <= REL * np.abs(vj).max(), tp
        assert np.abs(up - uj).max() <= REL * np.abs(uj).max(), tp


# (nx, scheme, theta, u_precond): every scheme, theta and preconditioner
# pair runs, each at both sizes (a half fraction of the 2^4 design)
SQUARE_CASES = [
    (8, "monolithic", 1.0, "dct"), (16, "monolithic", 1.0, "jacobi"),
    (16, "monolithic", 0.5, "dct"), (8, "monolithic", 0.5, "jacobi"),
    (16, "gs", 1.0, "dct"), (8, "gs", 1.0, "jacobi"),
    (8, "gs", 0.5, "dct"), (16, "gs", 0.5, "jacobi"),
]
# both schemes and both thetas, in two runs, for the other configurations
SCHEME_THETA = [("monolithic", 0.5), ("gs", 1.0)]


@pytest.mark.parametrize("nx, scheme, theta, precond", SQUARE_CASES)
def test_fhn_square_matches_jax(nx, scheme, theta, precond):
    common = dict(theta=theta, scheme=scheme, u_precond=precond, pde_theta=0.5)
    js = JBidomain(use_pallas_ode=False, **square("jax", nx), **common)
    ts = TBidomain(device="cpu", **square("port", nx), **common)
    assert ts._u_dct == js._u_dct == (precond == "dct") and ts._structured
    assert_same(run(js, 1.5, 0.1, 5), run(ts, 1.5, 0.1, 5))


@pytest.mark.parametrize("scheme, theta", SCHEME_THETA)
def test_fhn_square_matches_jax_on_its_pallas_ionic_kernel(scheme, theta):
    """The JAX side on its Pallas ionic kernel (interpret mode, padded
    blocked carry) and its stencil SpMV kernel."""
    common = dict(theta=theta, scheme=scheme, pde_theta=0.5)
    js = JBidomain(use_pallas_ode=True, pallas_spmv_min_nodes=1, **square("jax", 8), **common)
    assert js._pallas_ionic and js._pallas_spmv
    assert_same(run(js, 1.5, 0.1, 5), run(TBidomain(device="cpu", **square("port", 8), **common), 1.5, 0.1, 5))


@pytest.mark.parametrize("scheme, theta", SCHEME_THETA)
def test_fhn_marker_layers_match_jax(scheme, theta):
    """A dict ode_fun with markers: B7's twin against JAX's masked jnp
    composition (both in make_multi_ode's storage layout, V in row 0)."""
    js = JBidomain(use_pallas_ode=False, theta=theta, scheme=scheme, **square("jax", 8, markers=True))
    ts = TBidomain(device="cpu", theta=theta, scheme=scheme, **square("port", 8, markers=True))
    assert ts._ionic_groups is not None and ts.v_index == 0
    assert_same(run(js, 1.5, 0.1, 5), run(ts, 1.5, 0.1, 5))
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states), rtol=0, atol=1e-8 * 100)


@pytest.mark.parametrize("scheme, theta", SCHEME_THETA)
def test_tp06_slab_matches_jax(scheme, theta):
    """TP06 on the Niederer slab at dx = 1 (21 x 8 x 4 nodes, the DCT
    engaged), 10 steps."""
    js = jax_slab_solver(1.0, use_pallas_ode=False, scheme=scheme, theta=theta)
    ts = tbs.slab_solver(1.0, device="cpu", scheme=scheme, theta=theta)
    assert ts._u_dct and ts._n == 672
    assert_same(run(js, 0.5, 0.05, 4), run(ts, 0.5, 0.05, 4))
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states), rtol=1e-8, atol=1e-9)


def _lv(side):
    mm, st, fhn, _ = SIDES[side]
    geo = jlv(psize_ref=0.8, cache=False) if side == "jax" else tlv(psize_ref=0.8)
    tensor = jtensor if side == "jax" else ttensor
    mesh = geo.mesh
    cells = mm.locate_entities(mesh, 3, lambda x: x[0] < mesh.coords[:, 0].min() + 2.0)
    I_s = st.Stimulus(expr=st.TimeWindow(amplitude=80.0, start=0.0, duration=1.0),
                      dZ=st.dx(mesh, subdomain_data=mm.meshtags(mesh, 3, cells, 1)), marker=1)
    return dict(mesh=mesh, M_i=tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0), M_e=tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0),
                I_s=I_s, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
                parameters=fhn.init_parameter_values(stim_amplitude=0.0), v_index=1, u_precond="jacobi")


@pytest.mark.parametrize("scheme, theta", SCHEME_THETA)
def test_fhn_lv_jacobi_matches_jax(scheme, theta):
    """The unstructured LV (CSR twin of B8 on one shared layout), Jacobi,
    both solved to rtol 3e-11: Jacobi-CG to the default 1e-8 leaves the
    two packages' sum orders 5e-8 of v apart, and the monolithic u_e
    (small beside v in the joint residual) 2e-8 apart at 1e-10."""
    common = dict(scheme=scheme, theta=theta, cg_rtol=3e-11, cg_atol=3e-13)
    js = JBidomain(use_pallas_ode=False, **_lv("jax"), **common)
    ts = TBidomain(device="cpu", **_lv("port"), **common)
    assert not ts._structured and not ts._u_dct
    assert_same(run(js, 0.4, 0.1, 2), run(ts, 0.4, 0.1, 2))


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_proportional_conductivities_reduce_to_monodomain(theta):
    """M_e = lam M_i: the bidomain v is the monodomain solution with M =
    lam/(1+lam) M_i step for step, u_e grounded to zero mean (the JAX
    package's gate, tests/test_bidomain.py:40-76, on the port's own two
    solvers)."""
    kw = square("port", 10)
    kw.pop("M_i"), kw.pop("M_e")
    kw.update(theta=theta, pde_theta=0.5, device="cpu")
    lam, g_i = 2.0, 0.004
    bi = TBidomain(M_i=g_i, M_e=lam * g_i, cg_rtol=1e-11, cg_atol=1e-13, **kw)
    bi.solve((0.0, 2.0), dt=0.1)
    mono = TFused(M=(lam / (1.0 + lam)) * g_i, **kw)
    mono.solve((0.0, 2.0), dt=0.1)
    assert float((bi.v - mono.v).abs().max()) < 2e-4
    assert abs(float(bi.u_e.mean())) < 1e-10
    assert float(bi.u_e.abs().max()) > 1e-4


def test_starved_cg_reports_not_converging_and_float32_floor():
    kw = square("port", 8)
    assert TBidomain(device="cpu", cg_maxiter=1, **kw).solve((0.0, 0.2), dt=0.1) == Status.NOT_CONVERGING
    f32 = TBidomain(device="cpu", dtype=torch.float32, **square("port", 8))
    assert (f32.cg_rtol, f32.cg_atol) == (1e-6, 1e-7)
    assert f32.solve((0.0, 1.0), dt=0.1) == Status.OK and f32.host_syncs > f32.cg_iterations


@pytest.mark.parametrize("kw, error, match", [
    ({"u_precond": "spectral-ish"}, ValueError, "u_precond"),
    ({"scheme": "jacobi-outer"}, ValueError, "scheme"),
    ({"u_solve_every": 0, "scheme": "gs"}, ValueError, "u_solve_every"),
    ({"u_solve_every": 2}, ValueError, "u_solve_every"),
    ({"u_solve_every": 2, "scheme": "gs"}, NotImplementedError, "Queue C"),
    ({"u_precond": "amg", "u_amg_opts": {"coarsest": 10}}, TypeError, "coarsest"),
    ({"theta": 0.0}, ValueError, "theta"),
])
def test_refusals(kw, error, match):
    with pytest.raises(error, match=match):
        TBidomain(device="cpu", **{**square("port", 4), **kw})


def test_entry_points_default_to_the_card():
    """No device named: the card, or an error where there is none; never a
    silent run on the CPU."""
    if torch.cuda.is_available():
        assert TBidomain(**square("port", 4)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        TBidomain(**square("port", 4))
    with pytest.raises(RuntimeError, match="cuda"):
        tbs.run_demo(nx=4, T=0.1)


def test_run_slab_times_both_solvers_alike():
    """``bidomain_scale.run_slab`` at dx=1 (672 nodes) on the CPU: the
    bidomain and its matched monodomain run through the one ``timed_solve``
    (each solver's monitor and CG counter), both converged."""
    row = tbs.run_slab(1.0, T_warm=0.5, T_timed=0.5, device="cpu")
    assert row["converged"] and row["finite"] and row["n_nodes"] == 672
    assert row["cg_iters_per_step"] > 0 and len(row["chunk_iters"]) == 2
    assert row["mono_cg_iters_max"] > 0 and row["mono_ms_per_s"] > 0


def test_where_jax_takes_amg_the_port_refuses():
    """Where the JAX package takes SA-AMG off the TPU ('auto' on an
    unstructured or heterogeneous mesh, and 'amg' anywhere) the port takes
    it too, and refuses nothing; 'dct' where the model declines raises
    ValueError, as in JAX."""
    assert TBidomain(device="cpu", **{**_lv("port"), "u_precond": "auto"})._u_amg
    with pytest.raises(ValueError, match="structured"):
        TBidomain(device="cpu", **{**_lv("port"), "u_precond": "dct"})
    kw = square("port", 12)
    assert not TBidomain(device="cpu", **kw)._u_amg  # the DCT applies
    assert TBidomain(device="cpu", u_precond="amg", **kw)._u_amg
    mesh = kw["mesh"]
    mids = mesh.coords[mesh.cells].mean(axis=1)
    scale = np.where((mids[:, 0] > 0.4) & (mids[:, 0] < 0.6), 1e-3, 1.0)
    kw["M_i"] = scale[:, None, None] * (0.004 * np.eye(2))[None]
    hetero = TBidomain(device="cpu", **kw)
    assert hetero._u_amg and not hetero._u_dct
    assert hetero.solve((0.0, 0.3), dt=0.1) == Status.OK
    jacobi = TBidomain(device="cpu", u_precond="jacobi", **kw)
    assert not jacobi._u_dct and not jacobi._u_amg


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["monolithic", "gs"])
def test_demo_on_card_kernels_match_twins(cuda_device, scheme):
    """The demo's configuration for 10 ms on the kernels (FHN's B1, B5)
    and on the twins, on the card."""
    before = (cuda_ode.fhn_step_v.launches, cuda_stencil.stencil_spmv.launches)
    k = tbs.demo_solver(48, device=cuda_device, scheme=scheme)
    k.solve((0.0, 10.0), dt=0.1)
    assert cuda_ode.fhn_step_v.launches > before[0] and cuda_stencil.stencil_spmv.launches > before[1]
    w = tbs.demo_solver(48, device=cuda_device, scheme=scheme, use_kernels=False)
    w.solve((0.0, 10.0), dt=0.1)
    assert float((k.v - w.v).abs().max()) < 0.5
    assert float((k.u_e - w.u_e).abs().max()) < 0.05 * float(w.u_e.abs().max())
