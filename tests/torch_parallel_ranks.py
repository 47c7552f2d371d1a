"""Rank functions of the sharded port's CPU tests.

The tests spawn gloo ranks with
:func:`fenicsx_beat_tpu_torch.parallel.spawn_ranks`; the ranks import
this module, which imports torch and the port only (never JAX), and run
every case of one test file in one spawn.  Rank 0 returns numpy results
keyed by case; the other ranks return None.  The problems mirror the JAX
package's ``tests/test_parallel.py``, ``tests/test_parallel_bidomain.py``
and ``tests/test_adjoint.py``; each ``*_setup`` here has its JAX twin in
the test files.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from fenicsx_beat_tpu_torch import fem, stimulation
from fenicsx_beat_tpu_torch.conductivities import default_conductivities, define_conductivity_tensor
from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.mesh import create_unit_square, locate_entities, meshtags
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
from fenicsx_beat_tpu_torch.parallel import ShardedBidomainSolver, ShardedMonodomainSolver, make_device_mesh
from fenicsx_beat_tpu_torch.stimulation import Stimulus, TimeWindow, define_stimulus
from fenicsx_beat_tpu_torch.units import ureg

CPU = "cpu"
LV_PSIZE = 0.6  # the LV of the monodomain cases (JAX's test_sharded_unstructured_lv_matches_fused)
T_SHORT, T_ECG, DT = 2.0, 5.0, 0.05


def _slab_stimulus(mesh, corner=1.5):
    tol = 1e-10
    cells = locate_entities(
        mesh, mesh.tdim, lambda x: (x[0] <= corner + tol) & (x[1] <= corner + tol) & (x[2] <= corner + tol))
    return define_stimulus(mesh=mesh, chi=default_conductivities("Niederer")["chi"], time=fem.Constant(0.0),
                           subdomain_data=meshtags(mesh, mesh.tdim, cells, 1), marker=1, mesh_unit="mm",
                           amplitude=50_000.0, duration=2.0)


def niederer_setup(Lx=20.0, Ly=7.0, Lz=3.0):
    """JAX's ``tests/test_parallel.py:_niederer_setup`` (dx=1.0) on any slab."""
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=Lx, Ly=Ly, Lz=Lz)
    return dict(
        mesh=geo.mesh,
        M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=_slab_stimulus(geo.mesh),
        theta=1.0,
        C_m=(1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude,
    )


def lv_setup():
    """JAX's LV case: psize 0.6, the apex region below the 20th percentile of x stimulated."""
    geo = get_lv_ellipsoid_geometry(None, psize_ref=LV_PSIZE)
    mesh = geo.mesh
    x_cut = np.percentile(mesh.coords[:, 0], 20.0)
    tags = meshtags(mesh, mesh.tdim, locate_entities(mesh, mesh.tdim, lambda x: x[0] <= x_cut), 1)
    I_s = Stimulus(expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
                   dZ=stimulation.dx(mesh, subdomain_data=tags), marker=1)
    return dict(
        mesh=mesh,
        M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        I_s=I_s,
        theta=1.0,
    )


def general_expr(x, t):
    """A travelling gaussian times a ramp: not separable in space and time."""
    return 40.0 * torch.exp(-((x[0] - 0.5 * t) ** 2)) * torch.clamp(1.0 - t / 4.0, min=0.0)


def general_setup():
    common = niederer_setup()
    mesh = common["mesh"]
    tol = 1e-10
    cells = locate_entities(mesh, mesh.tdim,
                            lambda x: (x[0] <= 3.0 + tol) & (x[1] <= 3.0 + tol) & (x[2] <= 3.0 + tol))
    dx = stimulation.dx(mesh, subdomain_data=meshtags(mesh, mesh.tdim, cells, 1))
    return dict(common, I_s=Stimulus(expr=general_expr, dZ=dx, marker=1))


def two_marker_setup():
    common = niederer_setup()
    V = fem.functionspace(common["mesh"], ("P", 1))
    markers = np.where(V.tabulate_dof_coordinates()[:, 0] < 10.0, 1, 2)
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    return dict(
        common,
        ode_fun={1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
        init_states={1: tp06.init_state_values(), 2: tp06.init_state_values(V=-60.0)},
        parameters={1: params, 2: params},
        v_index={1: tp06.state_index("V"), 2: tp06.state_index("V")},
        ode_markers=markers,
    )


def _run(setup: dict, T: float, rank: int, **kw) -> dict:
    s = ShardedMonodomainSolver(device_mesh=make_device_mesh(device=CPU), **setup, **kw)
    status = s.solve((0.0, T), dt=DT)
    out = {"v": s.v.numpy(), "act": s.activation_times(), "status": int(status.value),
           "perm": s._perm is not None, "tail": s._tail is not None, "stencil": s._offsets is not None,
           "n_pad": s.part.n_pad, "gen": len(s._st.gen_tables),
           "counts": dict(s.comm.counts), "cg": s.cg_iterations}
    return out if rank == 0 else None


def mono_cases(rank: int, world: int) -> dict | None:
    """Every monodomain case of ``tests/test_torch_parallel.py``."""
    out = {
        "slab": _run(niederer_setup(), T_SHORT, rank),
        "padding": _run(niederer_setup(Ly=6.0, Lz=2.0), T_SHORT, rank),
        "lv": _run(lv_setup(), T_SHORT, rank),
        "general": _run(general_setup(), T_SHORT, rank),
        "two_marker": _run(two_marker_setup(), T_SHORT, rank),
        "ecg": _run(niederer_setup(), T_ECG, rank),
    }
    # checkpoints: two chunks straight through, then a save at 2 ms and
    # resumes into a new sharded solver and into the fused solver
    common = niederer_setup()
    mesh_dm = make_device_mesh(device=CPU)
    ref = ShardedMonodomainSolver(device_mesh=mesh_dm, **common)
    ref.solve((0.0, 2.0), dt=DT)
    ref.solve((2.0, 4.0), dt=DT)
    a = ShardedMonodomainSolver(device_mesh=mesh_dm, **common)
    a.solve((0.0, 2.0), dt=DT)
    with tempfile.TemporaryDirectory() as d:
        # rank 0 writes: every rank takes rank 0's directory
        path = a.save_state(Path(_shared_dir(d, a)) / "mid", t=2.0)
        b = ShardedMonodomainSolver(device_mesh=mesh_dm, **common)
        t0 = b.load_state(path)
        b.solve((t0, 4.0), dt=DT)
        v_b = b.v.numpy()
        ck = None
        if rank == 0:
            with np.load(path) as f:
                ck = {k: f[k] for k in f.files}
            c = FusedMonodomainSolver(device=CPU, params={"ksp_rtol": 1e-8, "ksp_atol": 1e-10}, **common)
            c.load_state(path)
            c.solve((t0, 4.0), dt=DT)
            fused_v = c.v.numpy()
        a.comm.barrier()
    out["checkpoint"] = {"ref": ref.v.numpy(), "resumed": v_b, "t0": t0, "ckpt": ck,
                         "fused": fused_v if rank == 0 else None}
    return out if rank == 0 else None


def _shared_dir(local: str, solver) -> str:
    """Rank 0's directory name, broadcast to every rank."""
    import torch.distributed as dist

    if solver.comm.world == 1:
        return local
    obj = [local]
    dist.broadcast_object_list(obj, src=0)
    return obj[0]


# ---------------------------------------------------------------------------
# the bidomain (tests/test_torch_parallel_bidomain.py)

BIDOMAIN_KW = dict(
    ode_fun=fhn.forward_euler,
    init_states=fhn.init_state_values(),
    parameters=fhn.init_parameter_values(stim_amplitude=0.0),
    v_index=fhn.state_index("v"),
    pde_theta=0.5,
    cg_rtol=1e-11,
    cg_atol=1e-13,
)


def sheet_setup(nx=20):
    """JAX's ``tests/test_parallel_bidomain.py:_sheet_setup``."""
    mesh = create_unit_square(None, nx, nx)
    cells = locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    I_s = Stimulus(expr=TimeWindow(amplitude=60.0, start=0.0, duration=1.0),
                   dZ=stimulation.dx(mesh, subdomain_data=meshtags(mesh, 2, cells, 1)), marker=1)
    return mesh, I_s


def bidomain_lv_setup(psize=0.8):
    from fenicsx_beat_tpu_torch.conductivities import conductivity_tensor

    geo = get_lv_ellipsoid_geometry(psize_ref=psize)
    mesh = geo.mesh
    apex_x = mesh.coords[:, 0].min()
    cells = locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    I_s = Stimulus(expr=TimeWindow(amplitude=80.0, start=0.0, duration=1.0),
                   dZ=stimulation.dx(mesh, subdomain_data=meshtags(mesh, 3, cells, 1)), marker=1)
    return dict(mesh=mesh, I_s=I_s, M_i=conductivity_tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0),
                M_e=conductivity_tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0))


def bidomain_multi_marker_setup():
    mesh, I_s = sheet_setup(nx=12)
    V = fem.functionspace(mesh, ("P", 1))
    markers = np.where(V.tabulate_dof_coordinates()[:, 0] < 0.5, 1, 2)
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    return dict(mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s,
                ode_fun={1: tp06.generalized_rush_larsen, 2: tp06.generalized_rush_larsen},
                init_states={1: tp06.init_state_values(), 2: tp06.init_state_values(V=-60.0)},
                parameters={1: params, 2: params},
                v_index={1: tp06.state_index("V"), 2: tp06.state_index("V")},
                ode_markers=markers, theta=1.0, pde_theta=0.5, cg_rtol=1e-11, cg_atol=1e-13)


class _Iters:
    def __init__(self):
        self.iters = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def _bi_run(kw: dict, T: float, dt: float, rank: int, save_freq=None) -> dict:
    mon = _Iters()
    sb = ShardedBidomainSolver(device_mesh=make_device_mesh(device=CPU), monitor=mon, **kw)
    status = sb.solve((0.0, T), dt=dt, save_freq=save_freq)
    out = {"v": sb.v.numpy(), "u_e": sb.u_e.numpy(), "status": int(status.value), "iters": mon.iters,
           "stencil": sb._offsets is not None, "perm": sb._perm is not None, "amg": sb._u_amg,
           "mode": sb._amg_mode}
    return out if rank == 0 else None


def bidomain_cases(rank: int, world: int) -> dict | None:
    mesh, I_s = sheet_setup()
    out = {f"sheet_{th}": _bi_run(dict(mesh=mesh, M_i=0.004, M_e=0.008, I_s=I_s, **BIDOMAIN_KW, theta=th),
                                  1.0, 0.1, rank) for th in (1.0, 0.5)}
    lv = bidomain_lv_setup()
    for precond in ("auto", "jacobi"):
        out[f"lv_{precond}"] = _bi_run(dict(lv, **BIDOMAIN_KW, theta=1.0, u_precond=precond), 0.5, 0.1, rank,
                                       save_freq=1)
    # past coarse_n (2,500 dofs): the multilevel split (sharded level 0, replicated coarse levels)
    mesh60, I_s60 = sheet_setup(nx=60)
    out["multilevel"] = _bi_run(dict(mesh=mesh60, M_i=0.004, M_e=0.008, I_s=I_s60, **BIDOMAIN_KW, theta=1.0),
                                0.3, 0.1, rank)
    mesh8, I_s8 = sheet_setup(nx=8)
    out["dense"] = _bi_run(dict(mesh=mesh8, M_i=0.004, M_e=0.008, I_s=I_s8, **BIDOMAIN_KW, theta=1.0,
                                u_precond="amg"), 0.5, 0.1, rank)
    out["multi_marker"] = _bi_run(bidomain_multi_marker_setup(), 8 * 0.05, 0.05, rank)
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the adjoint (tests/test_torch_parallel_adjoint.py)

ADJ_PROBES = np.array([[1.0, 1.0, 0.5], [4.0, 1.0, 0.5]])
ADJ_G = [0.003, 0.001]


def adjoint_setup(dx=0.5):
    """JAX's ``tests/test_adjoint.py:test_sharded_diff_simulator_matches_single_device``
    slab (6 x 2 x 1 mm), FHN forward Euler, fiber and transverse stiffness components."""
    m3 = get_3D_slab_geometry(None, dx=dx, Lx=6.0, Ly=2.0, Lz=1.0).mesh
    cells = locate_entities(m3, 3, lambda x: x[0] <= 1.0)
    I_s = Stimulus(expr=TimeWindow(amplitude=40.0, start=0.0, duration=1.0),
                   dZ=stimulation.dx(m3, subdomain_data=meshtags(m3, 3, cells, 1)), marker=1)
    f0 = np.array([1.0, 0.0, 0.0])
    Kf = np.outer(f0, f0)
    kw = dict(ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
              I_s=I_s, probe_points=ADJ_PROBES, dt=0.1, n_steps=16, theta=1.0, pde_theta=0.5,
              stiffness_components=[Kf, np.eye(3) - Kf], cg_rtol=1e-11, cg_atol=1e-13, dtype=torch.float64)
    return m3, kw


def adjoint_params(requires_grad=True):
    def t(v):
        return torch.tensor(v, dtype=torch.float64, requires_grad=requires_grad)

    return {"g": t(ADJ_G), "ionic": t(fhn.init_parameter_values(stim_amplitude=0.0).tolist()),
            "stim_amplitude": t(40.0)}


def adjoint_cases(rank: int, world: int, target: np.ndarray) -> dict | None:
    """The value, dL/dparams and traces of ``mean((sim - target)^2)`` through
    the sharded simulator, monolithic and through ``host_segmented_value_and_grad``
    (4 segments of 4 steps)."""
    from fenicsx_beat_tpu_torch.adjoint import host_segmented_value_and_grad
    from fenicsx_beat_tpu_torch.parallel.adjoint import build_sharded_diff_simulator

    m3, kw = adjoint_setup()
    dm = make_device_mesh(device=CPU)
    sim = build_sharded_diff_simulator(m3, dm, **kw)
    tgt = torch.as_tensor(target)
    params = adjoint_params()
    traces = sim(params)
    loss = torch.mean((traces - tgt) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    out = {"value": float(loss.detach()), "traces": traces.detach().numpy(),
           "grads": {k: g.numpy() for k, g in zip(params, grads)}}
    seg = build_sharded_diff_simulator(m3, dm, **dict(kw, n_steps=4))
    value, sgrads = host_segmented_value_and_grad(
        seg, {k: v.detach() for k, v in params.items()}, lambda tr, aux: torch.sum((tr - aux) ** 2) / tgt.numel(),
        [tgt[4 * k : 4 * k + 4] for k in range(4)], segment_ms=0.4, states0=seg.states0)
    out["segmented"] = {"value": value, "grads": {k: g.numpy() for k, g in sgrads.items()}}
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the spawn's own checks


def sleeper(rank: int, world: int, seconds: float):
    import time

    time.sleep(seconds)


def refuser(rank: int, world: int):
    if rank == 1:
        raise ValueError("rank 1 refuses")
    import torch.distributed as dist

    dist.barrier()


# ---------------------------------------------------------------------------
# the card (tests/test_torch_parallel_card.py)


def card_slab(rank: int, world: int) -> dict | None:
    """The dx=1.0 slab sharded on the card (this rank's card), 2 ms: the
    gathered v and activation times and the kernels' launch counts."""
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ode, cuda_stencil

    wrappers = {"b1": cuda_ode.tp06_grl_step_v, "b3": cuda_cg.cg_update, "b4": cuda_cg.axpy,
                "b5": cuda_stencil.stencil_spmv}
    for w in wrappers.values():
        w.launches = 0
    s = ShardedMonodomainSolver(device_mesh=make_device_mesh(), **niederer_setup())
    s.solve((0.0, T_SHORT), dt=DT)
    out = {"v": s.v.double().cpu().numpy(), "act": s.activation_times(), "backend": s.device_mesh.backend,
           "launches": {k: w.launches for k, w in wrappers.items()}, "cg": s.cg_iterations}
    return out if rank == 0 else None
