"""The port's sharded monodomain solver against the JAX package's, f64.

``fenicsx_beat_tpu_torch.parallel.ShardedMonodomainSolver`` at 2 and 4
gloo ranks (one spawn per world size, every case in it:
``tests/torch_parallel_ranks.py:mono_cases``) against JAX's
``ShardedMonodomainSolver`` at the same device count on the conftest's 8
virtual devices, with JAX's own tolerances (``tests/test_parallel.py``):
the dx=1.0 Niederer slab, a padded partition, the psize 0.6 LV with its
apex tail (RCM, tail-aware partition, B8's twin), a general stimulus, two
markers, checkpoints across solvers and the ECG from the gathered voltage.
World size 1 equals the port's fused solver.  Also the process-group
helpers, the spawn's time limit and refusals.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fenicsx_beat_tpu import Stimulus as JStimulus
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.conductivities import default_conductivities as jconds
from fenicsx_beat_tpu.conductivities import define_conductivity_tensor as jtensor
from fenicsx_beat_tpu.ecg import ECGRecovery as JECG
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as jslab
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.mesh import locate_entities as jlocate
from fenicsx_beat_tpu.mesh import meshtags as jtags
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp06
from fenicsx_beat_tpu.parallel.solver import ShardedMonodomainSolver as JSharded
from fenicsx_beat_tpu.units import ureg as jureg
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch.ecg import ECGRecovery
from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver
from fenicsx_beat_tpu_torch.parallel import (
    ShardedMonodomainSolver,
    initialize_distributed,
    is_coordinator,
    make_device_mesh,
    spawn_ranks,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0  # seconds for one spawn of every case (about 15 s here)
ELECTRODES = [(25.0, 3.5, 1.5), (10.0, 20.0, 1.5)]


@pytest.fixture(scope="module")
def port_runs():
    """Every case at one world size, one spawn each, on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = spawn_ranks(R.mono_cases, world, backend="gloo", timeout=SPAWN_TIMEOUT)[0]
        return cache[world]

    return get


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("x",))


def _jslab_stimulus(mesh, corner=1.5):
    tol = 1e-10
    cells = jlocate(mesh, mesh.tdim,
                    lambda x: (x[0] <= corner + tol) & (x[1] <= corner + tol) & (x[2] <= corner + tol))
    return jstim.define_stimulus(mesh=mesh, chi=jconds("Niederer")["chi"], time=jfem.Constant(0.0),
                                 subdomain_data=jtags(mesh, mesh.tdim, cells, 1), marker=1, mesh_unit="mm",
                                 amplitude=50_000.0, duration=2.0)


def jniederer(Lx=20.0, Ly=7.0, Lz=3.0):
    geo = jslab(None, dx=1.0, Lx=Lx, Ly=Ly, Lz=Lz)
    return dict(
        mesh=geo.mesh, M=jtensor(f0=geo.f0, **jconds("Niederer")), ode_fun=jtp06.generalized_rush_larsen,
        init_states=jtp06.init_state_values(), parameters=jtp06.init_parameter_values(stim_amplitude=0.0),
        v_index=jtp06.state_index("V"), I_s=_jslab_stimulus(geo.mesh), theta=1.0,
        C_m=(1.0 * jureg("uF/cm**2")).to("uF/mm**2").magnitude,
    )


def jlv_setup():
    geo = jlv(None, psize_ref=R.LV_PSIZE)
    mesh = geo.mesh
    x_cut = np.percentile(mesh.coords[:, 0], 20.0)
    tags = jtags(mesh, mesh.tdim, jlocate(mesh, mesh.tdim, lambda x: x[0] <= x_cut), 1)
    I_s = JStimulus(expr=jstim.TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
                    dZ=jstim.dx(mesh, subdomain_data=tags), marker=1)
    return dict(mesh=mesh, M=jtensor(f0=geo.f0, **jconds("Niederer")), ode_fun=jtp06.generalized_rush_larsen,
                init_states=jtp06.init_state_values(), parameters=jtp06.init_parameter_values(stim_amplitude=0.0),
                v_index=jtp06.state_index("V"), I_s=I_s, theta=1.0)


def jgeneral():
    common = jniederer()
    mesh = common["mesh"]
    tol = 1e-10
    cells = jlocate(mesh, mesh.tdim, lambda x: (x[0] <= 3.0 + tol) & (x[1] <= 3.0 + tol) & (x[2] <= 3.0 + tol))

    def expr(x, t):
        return 40.0 * jnp.exp(-((x[0] - 0.5 * t) ** 2)) * jnp.maximum(0.0, 1.0 - t / 4.0)

    dx = jstim.dx(mesh, subdomain_data=jtags(mesh, mesh.tdim, cells, 1))
    return dict(common, I_s=JStimulus(expr=expr, dZ=dx, marker=1))


def jtwo_marker():
    common = jniederer()
    V = jfem.functionspace(common["mesh"], ("P", 1))
    markers = np.where(V.tabulate_dof_coordinates()[:, 0] < 10.0, 1, 2)
    params = jtp06.init_parameter_values(stim_amplitude=0.0)
    return dict(common, ode_fun={1: jtp06.generalized_rush_larsen, 2: jtp06.generalized_rush_larsen},
                init_states={1: jtp06.init_state_values(), 2: jtp06.init_state_values(V=-60.0)},
                parameters={1: params, 2: params},
                v_index={1: jtp06.state_index("V"), 2: jtp06.state_index("V")}, ode_markers=markers)


JAX_SETUPS = {"slab": jniederer, "padding": lambda: jniederer(Ly=6.0, Lz=2.0), "lv": jlv_setup,
              "general": jgeneral, "two_marker": jtwo_marker}


def _jax_run(setup, world, T=R.T_SHORT):
    s = JSharded(device_mesh=_jmesh(world), **setup)
    s.solve((0.0, T), dt=R.DT)
    return s, np.asarray(s.v), s.activation_times()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["slab", "padding", "general", "two_marker"])
def test_sharded_slab_cases_match_jax(port_runs, case, world):
    """The structured cases: v at rtol 1e-8 / atol 1e-7 (the padded, the
    general-stimulus and the two-marker runs at JAX's 1e-7 / 1e-6), the
    activation times at 1e-8; each case takes its path (stencil partition,
    padding, per-rank quadrature, node-aligned masks)."""
    got = port_runs(world)[case]
    setup = JAX_SETUPS[case]()
    js, jv, jact = _jax_run(setup, world)
    assert got["status"] == 1 and got["stencil"] and not got["perm"]
    assert np.isfinite(got["v"]).all() and got["v"].max() > 0.0
    rtol, atol = (1e-8, 1e-7) if case == "slab" else (1e-7, 1e-6)
    np.testing.assert_allclose(got["v"], jv, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["act"], jact, rtol=1e-8, atol=1e-8)
    assert got["n_pad"] == js.part.n_pad
    if case == "padding":
        assert got["n_pad"] > got["v"].size
    assert got["gen"] == len(js._gen_tables) == (1 if case == "general" else 0)
    # the parameters follow the node partition exactly when the case gives them per node
    assert js._params_sharded == (isinstance(setup["ode_fun"], dict) or np.ndim(setup["parameters"]) == 2)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lv_matches_jax(port_runs, world):
    """The psize 0.6 LV: RCM renumbering and the apex rows' COO tail engage
    in both packages; v within 1e-7 / 1e-6, activation times within 1e-8."""
    got = port_runs(world)["lv"]
    js, jv, jact = _jax_run(jlv_setup(), world)
    assert js._perm is not None and js._tail is not None
    assert got["perm"] and got["tail"] and not got["stencil"]
    assert np.isfinite(got["v"]).all() and got["v"].max() > 0.0
    np.testing.assert_allclose(got["v"], jv, rtol=1e-7, atol=1e-6)
    np.testing.assert_allclose(got["act"], jact, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_roundtrip_cross_solver(port_runs, world):
    """Checkpoints in original dof order: a sharded save resumes exactly in a
    new sharded solver, and into the port's fused solver within JAX's
    cross-solver tolerance; the file is the npz the JAX solvers read, and
    JAX's sharded solver resumes from it to the port's run."""
    ck = port_runs(world)["checkpoint"]
    np.testing.assert_allclose(ck["resumed"], ck["ref"], atol=1e-12)
    np.testing.assert_allclose(ck["fused"], ck["ref"], rtol=1e-6, atol=2e-5)
    assert ck["t0"] == 2.0 and set(ck["ckpt"]) == {"states", "activation_time", "t", "v_index"}
    js = JSharded(device_mesh=_jmesh(world), **jniederer())
    js.solve((0.0, 2.0), dt=R.DT)
    np.testing.assert_allclose(ck["ckpt"]["states"], np.asarray(js.states)[:, : js.part.n_global],
                               rtol=1e-7, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ecg_from_sharded_solution_matches_jax(port_runs, world):
    """The ECG recovered from the gathered 5 ms voltage (the port's
    ECGRecovery) equals JAX's recovery from its sharded solution."""
    got = port_runs(world)["ecg"]
    _, jv, _ = _jax_run(jniederer(), world, T=R.T_ECG)
    np.testing.assert_allclose(got["v"], jv, rtol=1e-8, atol=1e-7)
    tmesh = R.niederer_setup()["mesh"]
    jmesh = jniederer()["mesh"]
    tv = tfem.Function(tfem.functionspace(tmesh, ("P", 1)))
    tv.x.array[:] = got["v"]
    jvf = jfem.Function(jfem.functionspace(jmesh, ("P", 1)))
    jvf.x.array[:] = jv
    te, je = ECGRecovery(v=tv, device="cpu"), JECG(v=jvf)
    tforms, jforms = [te.eval(p) for p in ELECTRODES], [je.eval(p) for p in ELECTRODES]
    te.solve()
    je.solve()
    got_phi = [tfem.assemble_scalar(f) for f in tforms]
    want = [jfem.assemble_scalar(f) for f in jforms]
    assert abs(want[0]) > 0
    np.testing.assert_allclose(got_phi, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("case", ["slab", "lv"])
def test_world_one_equals_fused(case):
    """One rank with no process group: the sharded solver is the port's
    fused solver (the same operators, stimulus and PCG recurrences), v and
    activation times within 1e-10."""
    setup = R.niederer_setup() if case == "slab" else R.lv_setup()
    s = ShardedMonodomainSolver(device_mesh=make_device_mesh(device="cpu"), **setup)
    s.solve((0.0, 1.0), dt=R.DT)
    f = FusedMonodomainSolver(device="cpu", **setup)
    f.solve((0.0, 1.0), dt=R.DT)
    np.testing.assert_allclose(s.v.numpy(), f.v.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(s.activation_times(), f.activation_times(), atol=1e-10)
    assert s.comm.counts["halo_bytes"] == 0


def test_make_device_mesh_and_coordinator():
    """Without a process group: a world of one on the named device, rank 0
    the coordinator, more devices than ranks a ValueError, NCCL refused
    without a card (no fallback)."""
    mesh = make_device_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.axis_names) == (0, 1, None, ("x",))
    assert is_coordinator() is True
    with pytest.raises(ValueError):
        make_device_mesh(10_000, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            spawn_ranks(R.mono_cases, 1, backend="nccl")
        with pytest.raises(RuntimeError):
            make_device_mesh()  # the card is the default device


def test_initialize_distributed_single_process_graceful():
    """No cluster environment: a single process, twice (idempotent)."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        assert key not in os.environ
    initialize_distributed()
    initialize_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        initialize_distributed("tcp://127.0.0.1:1", num_processes=2)


def test_spawn_time_limit_and_rank_errors():
    """A rank that outlives the spawn's limit is killed and the spawn raises
    TimeoutError; a rank that raises brings its traceback back."""
    with pytest.raises(TimeoutError):
        spawn_ranks(R.sleeper, 2, backend="gloo", args=(60.0,), timeout=4.0)
    with pytest.raises(RuntimeError, match="rank 1 refuses"):
        spawn_ranks(R.refuser, 2, backend="gloo", timeout=30.0)
