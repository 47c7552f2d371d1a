"""The port's sharded bidomain solver against the JAX package's, f64.

``fenicsx_beat_tpu_torch.parallel.ShardedBidomainSolver`` at 2 and 4 gloo
ranks (one spawn per world size:
``tests/torch_parallel_ranks.py:bidomain_cases``) against JAX's
``ShardedBidomainSolver`` at the same device count on the conftest's
virtual devices, at the tolerances of JAX's
``tests/test_parallel_bidomain.py``: the structured sheet (stencil
partition) in both splittings, the psize 0.8 LV (RCM and the tail-aware
partition) on AMG and on Jacobi, AMG's dense bottom below ``coarse_n``,
its multilevel split past it (the 60 x 60 sheet: sharded level 0,
replicated coarse levels) and two TP06 markers.  The refusals are JAX's.
"""

import os
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmeshmod
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.conductivities import conductivity_tensor as jct
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp06
from fenicsx_beat_tpu.parallel.bidomain import ShardedBidomainSolver as JShardedBi
from fenicsx_beat_tpu.telemetry import PerformanceMonitor
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.parallel import ShardedBidomainSolver, make_device_mesh, spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0  # one spawn of every case (about 13 s here)
JKW = dict(ode_fun=jfhn.forward_euler, init_states=jfhn.init_state_values(),
           parameters=jfhn.init_parameter_values(stim_amplitude=0.0), v_index=jfhn.state_index("v"),
           pde_theta=0.5, cg_rtol=1e-11, cg_atol=1e-13)


@pytest.fixture(scope="module")
def port_runs():
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = spawn_ranks(R.bidomain_cases, world, backend="gloo", timeout=SPAWN_TIMEOUT)[0]
        return cache[world]

    return get


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",))


def jsheet(nx=20):
    mesh = jmeshmod.create_unit_square(None, nx, nx)
    cells = jmeshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    I_s = jstim.Stimulus(expr=jstim.TimeWindow(amplitude=60.0, start=0.0, duration=1.0),
                         dZ=jstim.dx(mesh, subdomain_data=jmeshmod.meshtags(mesh, 2, cells, 1)), marker=1)
    return dict(mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s)


def jlv_setup():
    geo = jlv(psize_ref=0.8)
    mesh = geo.mesh
    apex_x = mesh.coords[:, 0].min()
    cells = jmeshmod.locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    I_s = jstim.Stimulus(expr=jstim.TimeWindow(amplitude=80.0, start=0.0, duration=1.0),
                         dZ=jstim.dx(mesh, subdomain_data=jmeshmod.meshtags(mesh, 3, cells, 1)), marker=1)
    return dict(mesh=mesh, I_s=I_s, M_i=jct(0.17 / 1.4, 0.019 / 1.4, geo.f0), M_e=jct(0.62 / 1.4, 0.24 / 1.4, geo.f0))


def jmulti_marker():
    sheet = jsheet(nx=12)
    V = jfem.functionspace(sheet["mesh"], ("P", 1))
    markers = np.where(V.tabulate_dof_coordinates()[:, 0] < 0.5, 1, 2)
    params = jtp06.init_parameter_values(stim_amplitude=0.0)
    return dict(sheet, ode_fun={1: jtp06.generalized_rush_larsen, 2: jtp06.generalized_rush_larsen},
                init_states={1: jtp06.init_state_values(), 2: jtp06.init_state_values(V=-60.0)},
                parameters={1: params, 2: params}, v_index={1: jtp06.state_index("V"), 2: jtp06.state_index("V")},
                ode_markers=markers, theta=1.0, pde_theta=0.5, cg_rtol=1e-11, cg_atol=1e-13)


class _Iters(PerformanceMonitor):
    def __init__(self):
        super().__init__()
        self.iters = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def _jax_run(kw, world, T, dt, save_freq=None):
    mon = _Iters()
    sb = JShardedBi(device_mesh=_jmesh(world), monitor=mon, **kw)
    sb.solve((0.0, T), dt=dt, save_freq=save_freq)
    return sb, np.asarray(sb.v), np.asarray(sb.u_e), mon.iters


def _check(got, jv, ju, atol):
    assert got["status"] == 1 and np.isfinite(got["v"]).all()
    np.testing.assert_allclose(got["v"], jv, rtol=0, atol=atol)
    np.testing.assert_allclose(got["u_e"], ju, rtol=0, atol=atol)
    assert abs(float(got["u_e"].mean())) < 1e-10


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_sharded_structured_matches_jax(port_runs, theta, world):
    """The 20 x 20 sheet in both splittings: the stencil partition and AMG's
    dense bottom (441 dofs), v and u_e within 2e-6 of JAX's sharded run,
    the same CG iterations."""
    got = port_runs(world)[f"sheet_{theta}"]
    sb, jv, ju, jit = _jax_run(dict(jsheet(), **JKW, theta=theta), world, 1.0, 0.1)
    assert got["stencil"] and sb._offsets is not None and got["amg"] and got["mode"] == "dense"
    _check(got, jv, ju, 2e-6)
    assert got["iters"] == jit


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_unstructured_lv_matches_jax(port_runs, world):
    """The psize 0.8 LV on RCM and the tail-aware partition, on AMG and on
    Jacobi (a chunk a step): v and u_e within 5e-6 of JAX's, AMG's worst
    step at most half of Jacobi's, each within one iteration of JAX's."""
    its = {}
    for precond in ("auto", "jacobi"):
        got = port_runs(world)[f"lv_{precond}"]
        sb, jv, ju, jit = _jax_run(dict(jlv_setup(), **JKW, theta=1.0, u_precond=precond), world, 0.5, 0.1,
                                   save_freq=1)
        assert got["perm"] and not got["stencil"] and got["amg"] == (precond == "auto") == sb._u_amg
        _check(got, jv, ju, 5e-6)
        assert max(abs(a - b) for a, b in zip(got["iters"], jit)) <= 1
        its[precond] = max(got["iters"])
    assert its["auto"] * 2 <= its["jacobi"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_amg_dense_and_multilevel_match_jax(port_runs, world):
    """Below coarse_n (the 8 x 8 sheet) the all-gathered dense bottom; past
    it (60 x 60, 3,721 dofs) the multilevel split: one all-reduce
    restriction per V-cycle, the coarse levels on every rank."""
    got = port_runs(world)["dense"]
    sb, jv, ju, _ = _jax_run(dict(jsheet(nx=8), **JKW, theta=1.0, u_precond="amg"), world, 0.5, 0.1)
    assert got["mode"] == "dense" and not sb._hier.levels
    _check(got, jv, ju, 2e-6)
    got = port_runs(world)["multilevel"]
    sb, jv, ju, jit = _jax_run(dict(jsheet(nx=60), **JKW, theta=1.0), world, 0.3, 0.1)
    assert got["mode"] == "multilevel" and sb._hier.levels
    _check(got, jv, ju, 2e-6)
    assert abs(got["iters"][0] - jit[0]) <= 1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multi_marker_matches_jax(port_runs, world):
    """Two TP06 markers: the node masks follow the partition; within 5e-5."""
    got = port_runs(world)["multi_marker"]
    kw = jmulti_marker()
    sb, jv, ju, _ = _jax_run(kw, world, 8 * 0.05, 0.05)
    assert isinstance(kw["ode_fun"], dict) and sb._params_sharded
    _check(got, jv, ju, 5e-5)


def test_sharded_bidomain_validation():
    """JAX's refusals: an unknown u_precond, a dict ode_fun without markers."""
    mesh, I_s = R.sheet_setup(nx=6)
    kw = dict(mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s, device_mesh=make_device_mesh(device="cpu"),
              ode_fun=tfhn.forward_euler, init_states=tfhn.init_state_values(),
              parameters=tfhn.init_parameter_values(stim_amplitude=0.0), v_index=tfhn.state_index("v"))
    with pytest.raises(ValueError, match="u_precond"):
        ShardedBidomainSolver(u_precond="boomer", **kw)
    with pytest.raises(ValueError, match="ode_markers"):
        ShardedBidomainSolver(**{**kw, "ode_fun": {1: tfhn.forward_euler}})
