"""The sharded solvers' census and their full-width runs, one rank per process.

Port of ``fenicsx_beat_tpu/benchmarks/multichip.py``.  The JAX script
counts the collectives in the compiled HLO of one chunk; the port's
ranks run eagerly, so the census reads the communicator's own counters
(:attr:`~..parallel.comm.Communicator.counts`) over a chunk:

* **weak scaling** (:func:`census_rank`, :func:`run_census`): the dx=0.5
  Niederer slab grown with the rank count (``Lx = 10 mm * ranks``), so each
  rank's block stays about the same; per row the ranks, nodes, ``n_local``,
  halo rows, CG iterations a step, halo exchanges and all-reduces per chunk
  and per CG iteration, the halo bytes a rank sends a step against the
  local bytes its kernels stream a step (the JAX script's analytic count,
  ``2 S n_local`` state bytes plus ``(K + 2) n_local`` operator bytes per
  product), and steps per second;
* the full-width runs of ``chip_smoke.py``'s phase 23 (:func:`phase_rank`):
  the dx=0.1 Niederer main path (:func:`niederer_rank`), the psize 0.1 LV
  (:func:`lv_rank`), the bidomain LV on AMG (:func:`bidomain_rank`) and the
  sharded adjoint (:func:`adjoint_rank`), each with its kernels' launch
  counts.

Ranks are spawned with :func:`~..parallel.distributed.spawn_ranks` (gloo on
the CPU, NCCL on cards; ``--backend gloo`` with ``--device cuda`` stages
the transfers through host memory, for several ranks on one card).  The
results are printed as one JSON line (and written to ``--out`` when
given)::

    python -m fenicsx_beat_tpu_torch.benchmarks.multichip --device cpu --worlds 1 2 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import fem
from ..conductivities import default_conductivities, define_conductivity_tensor
from ..config import resolve_device
from ..geometry import get_3D_slab_geometry
from ..mesh import locate_entities, meshtags
from ..models import tentusscher_panfilov_2006 as tp06
from ..parallel import ShardedMonodomainSolver, make_device_mesh, spawn_ranks
from ..stimulation import define_stimulus
from ..units import ureg

# the census slab: ``BASE_LX`` mm along x per rank, stepped at ``DT`` ms
BASE_LX = 10.0
DT = 0.05

# the kernels of the sharded paths, by their wrappers' names (each counts its launches)
KERNELS = ("tp06_grl_step_v", "cg_update", "axpy", "stencil_spmv", "csr_spmv",
           "stencil_spmv_sym", "stencil_spmv_sym_dir_dot")


def kernel_wrappers() -> dict:
    from ..ops import cuda_cg, cuda_ell, cuda_ode, cuda_spmv, cuda_stencil

    mods = (cuda_ode, cuda_cg, cuda_ell, cuda_spmv, cuda_stencil)
    return {name: next(getattr(m, name) for m in mods if hasattr(m, name)) for name in KERNELS}


def zero_launches() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def launches() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def slab_setup(dx: float, Lx: float) -> dict:
    """The Niederer slab problem (TP06 GRL, the S1 corner cube, Godunov) on
    a ``Lx`` x 7 x 3 mm slab at ``dx``: JAX's ``_slab_setup``."""
    geo = get_3D_slab_geometry(None, dx=dx, Lx=Lx, Ly=7.0, Lz=3.0)
    mesh = geo.mesh
    cond = default_conductivities("Niederer")
    tol = 1e-10
    cells = locate_entities(mesh, mesh.tdim,
                            lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol))
    I_s = define_stimulus(mesh=mesh, chi=cond["chi"], time=fem.Constant(0.0),
                          subdomain_data=meshtags(mesh, mesh.tdim, cells, 1), marker=1, mesh_unit="mm",
                          amplitude=50_000.0, duration=2.0)
    return dict(mesh=mesh, M=define_conductivity_tensor(f0=geo.f0, **cond), ode_fun=tp06.generalized_rush_larsen,
                init_states=tp06.init_state_values(), parameters=tp06.init_parameter_values(stim_amplitude=0.0),
                v_index=tp06.state_index("V"), I_s=I_s, theta=1.0,
                C_m=(1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude)


def _comm_row(solver, n_steps: int, cg: int) -> dict:
    c = solver.comm.counts
    per_cg = max(cg, 1)
    return {
        "exchanges_per_chunk": c["exchanges"], "all_reduces_per_chunk": c["all_reduces"],
        "exchanges_per_cg": c["exchanges"] / per_cg, "all_reduces_per_cg": c["all_reduces"] / per_cg,
        "halo_bytes_per_step": c["halo_bytes"] / n_steps, "reduce_bytes_per_step": c["reduce_bytes"] / n_steps,
    }


def census_rank(rank: int, world: int, dx: float = 0.5, n_steps: int = 100, device=None) -> dict | None:
    """One weak-scaling row (module docstring); rank 0 returns it.
    ``device``: each rank's card unless the CPU is named."""
    setup = slab_setup(dx, BASE_LX * world)
    solver = ShardedMonodomainSolver(device_mesh=make_device_mesh(device=device), **setup)
    part = solver.part
    solver.run_chunk(0.0, DT, 2)  # warm-up: the kernels' first launches
    solver.comm.reset_counts()
    cg0 = solver.cg_iterations
    _sync(solver.device)
    tic = time.perf_counter()
    res = solver.run_chunk(0.0, DT, n_steps)
    _sync(solver.device)
    wall = time.perf_counter() - tic
    cg = solver.cg_iterations - cg0
    S = int(solver.states.shape[0])
    item = solver.states.element_size()
    spmvs = cg / n_steps + 2.0  # CG products, the right-hand side's and the initial residual's
    K = len(solver._offsets) if solver._offsets is not None else solver.ops.mats[0].nnz / part.n_local
    local = 2 * S * part.n_local * item + spmvs * (K + 2) * part.n_local * item
    row = {"devices": world, "n_nodes": solver.V.ndofs, "n_local": part.n_local, "halo_rows": part.halo,
           "cg_iters_per_step": cg / n_steps, "max_cg_iters_per_step": res.iters_max,
           **_comm_row(solver, n_steps, cg), "local_bytes_per_step": local, "steps_per_s": n_steps / wall}
    # the busiest rank's halo (an interior rank sends to both neighbours)
    hb = torch.tensor([row["halo_bytes_per_step"]], dtype=torch.float64, device=solver.device)
    row["halo_bytes_per_step"] = float(solver.comm.all_reduce_max(hb)[0])
    row["halo_traffic_fraction"] = row["halo_bytes_per_step"] / local
    return row if rank == 0 else None


def run_census(worlds=(1, 2, 4), backend: str | None = None, device=None, dx: float = 0.5,
               n_steps: int = 100, timeout: float = 600.0) -> dict:
    """:func:`census_rank` at each world size, one spawn each, on the cards
    unless the CPU is named.  ``backend`` None means NCCL on cards and gloo
    on the CPU."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rows = [spawn_ranks(census_rank, w, backend=backend, args=(dx, n_steps, dev.type), timeout=timeout)[0]
            for w in worlds]
    return {"backend": backend, "device": dev.type, "weak_scaling": rows}


# ---------------------------------------------------------------------------
# the full-width runs of chip_smoke.py's phase 23


def niederer_rank(rank: int, world: int, device: str, dx: float = 0.1, T: float = 40.0, dt: float = 0.05,
                  cache_key: str | None = None) -> dict | None:
    """The Niederer main path sharded: TP06 GRL, Strang, ``T`` ms; P1-P9,
    ms/s, CG a step, the communicator's counts and the kernels' launches."""
    from .niederer import POINT_NAMES, benchmark_points, niederer_setup

    mesh, M, I_s, C_m = niederer_setup(dx)
    tic = time.perf_counter()
    s = ShardedMonodomainSolver(
        mesh=mesh, M=M, ode_fun=tp06.generalized_rush_larsen, init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0), v_index=tp06.state_index("V"), I_s=I_s,
        theta=0.5, C_m=C_m, device_mesh=make_device_mesh(device=device), operator_cache_key=cache_key)
    _sync(s.device)
    setup_s = time.perf_counter() - tic
    zero_launches()
    s.comm.reset_counts()
    tic = time.perf_counter()
    s.solve((0.0, T), dt=dt)
    _sync(s.device)
    wall = time.perf_counter() - tic
    counts = launches()
    act = s.activation_times()
    pts = benchmark_points()
    dofs, w = fem.point_evaluation_tables(s.V, np.array([pts[k] for k in POINT_NAMES]))
    at = (act[dofs] * w).sum(axis=1)
    n_steps = int(round(T / dt))
    out = {"at": at.tolist(), "ms_per_s": T / wall, "wall_s": wall, "setup_s": setup_s, "n": s.V.ndofs,
           "n_local": s.part.n_local, "halo": s.part.halo, "cg_per_step": s.cg_iterations / n_steps,
           "steps": n_steps, "launches": counts, **_comm_row(s, n_steps, s.cg_iterations),
           "host_syncs_per_step": s.host_syncs / n_steps, "finite": bool(torch.isfinite(s.states).all())}
    return out if rank == 0 else None


def lv_setup(psize: float) -> dict:
    """The LV problem of the monodomain LV path (:mod:`.lv`) with one TP06
    cell from ``init_state_values()`` everywhere: the endocardium
    stimulated for 1 ms, Niederer conductivities along the fibres, Strang."""
    from ..geometry import get_lv_ellipsoid_geometry
    from .lv import lv_amplitude

    geo = get_lv_ellipsoid_geometry(psize_ref=psize)
    mesh = geo.mesh
    I_s = define_stimulus(mesh=mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0), subdomain_data=geo.ffun,
                          marker=geo.markers["ENDO"][0], mesh_unit="cm", amplitude=lv_amplitude(psize),
                          duration=1.0)
    return dict(mesh=mesh, M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
                ode_fun=tp06.generalized_rush_larsen, init_states=tp06.init_state_values(),
                parameters=tp06.init_parameter_values(stim_amplitude=0.0), v_index=tp06.state_index("V"),
                I_s=I_s, theta=0.5)


def lv_rank(rank: int, world: int, device: str, psize: float = 0.1, T: float = 10.0, dt: float = 0.05,
            cache_key: str | None = None) -> dict | None:
    """The LV of :func:`lv_setup` sharded (RCM, the tail-aware partition,
    B8): the gathered activation times, ms/s, CG a step and launches."""
    setup = lv_setup(psize)
    tic = time.perf_counter()
    s = ShardedMonodomainSolver(device_mesh=make_device_mesh(device=device), operator_cache_key=cache_key, **setup)
    _sync(s.device)
    setup_s = time.perf_counter() - tic
    zero_launches()
    s.comm.reset_counts()
    tic = time.perf_counter()
    s.solve((0.0, T), dt=dt)
    _sync(s.device)
    wall = time.perf_counter() - tic
    n_steps = int(round(T / dt))
    out = {"act": s.activation_times(), "ms_per_s": T / wall, "setup_s": setup_s, "n": s.V.ndofs,
           "n_local": s.part.n_local, "halo": s.part.halo, "tail": s._tail is not None,
           "cg_per_step": s.cg_iterations / n_steps, "launches": launches(), **_comm_row(s, n_steps, s.cg_iterations),
           "finite": bool(torch.isfinite(s.states).all())}
    return out if rank == 0 else None


def bidomain_rank(rank: int, world: int, device: str, psize: float = 0.3, T: float = 5.0,
                  dt: float = 0.05) -> dict | None:
    """The bidomain LV of :func:`.bidomain_scale.lv_kwargs` sharded, on AMG:
    v and u_e gathered, CG a step and launches."""
    from ..parallel import ShardedBidomainSolver
    from .bidomain_scale import lv_kwargs

    sb = ShardedBidomainSolver(device_mesh=make_device_mesh(device=device), u_precond="auto", **lv_kwargs(psize))
    zero_launches()
    tic = time.perf_counter()
    sb.solve((0.0, T), dt=dt, save_freq=100)
    _sync(sb.device)
    wall = time.perf_counter() - tic
    out = {"v": sb.v.double().cpu().numpy(), "u_e": sb.u_e.double().cpu().numpy(), "amg": sb._amg_mode,
           "ms_per_s": T / wall, "cg_per_step": sb.cg_iterations / sb.steps, "launches": launches(),
           "all_reduces": sb.comm.counts["all_reduces"], "exchanges": sb.comm.counts["exchanges"]}
    return out if rank == 0 else None


ADJ_PROBES = np.array([[1.0, 1.0, 0.5], [4.0, 1.0, 0.5]])


def adjoint_problem(dx: float = 0.1, n_steps: int = 16, reverse: bool = False) -> tuple:
    """The slab of JAX's sharded-adjoint test (6 x 2 x 1 mm at ``dx``), FHN
    forward Euler, fiber and transverse stiffness components, stimulated in
    the corner ``x <= 1, y <= 1`` (the test's ``x <= 1`` sheet starts a
    planar wave, whose dL/dg along the transverse component is some 1e-3 of
    the fibre one's and below float32's noise), CG to rtol 1e-7 (at the
    test's 1e-6 the point where CG stops moves the transverse component
    more than float32's rounding does, and witnesses that take the same
    iterations cannot see it): ``(mesh, kwargs of build_diff_simulator
    without device or dtype)``.  ``reverse``
    numbers the nodes in reverse: the same problem with every sum over
    nodes taken in the other order (a witness of float32's reduction-order
    noise)."""
    from ..mesh import Mesh
    from ..models import fitzhughnagumo as fhn
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    m3 = get_3D_slab_geometry(None, dx=dx, Lx=6.0, Ly=2.0, Lz=1.0).mesh
    if reverse:
        n = m3.num_vertices
        m3 = Mesh(coords=m3.coords[::-1].copy(), cells=(n - 1 - m3.cells).astype(np.int32), cell_type=m3.cell_type)
    cells = locate_entities(m3, 3, lambda x: (x[0] <= 1.0) & (x[1] <= 1.0))
    I_s = Stimulus(expr=TimeWindow(amplitude=40.0, start=0.0, duration=1.0),
                   dZ=dx_measure(m3, subdomain_data=meshtags(m3, 3, cells, 1)), marker=1)
    Kf = np.outer([1.0, 0.0, 0.0], [1.0, 0.0, 0.0])
    return m3, dict(ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
                    I_s=I_s, probe_points=ADJ_PROBES, dt=0.1, n_steps=n_steps, theta=1.0, pde_theta=0.5,
                    stiffness_components=[Kf, np.eye(3) - Kf], cg_rtol=1e-7, cg_atol=1e-8)


def adjoint_params(device, dtype) -> dict:
    from ..models import fitzhughnagumo as fhn

    def t(v):
        return torch.tensor(v, dtype=torch.float64).to(device=device, dtype=dtype).requires_grad_(True)

    return {"g": t([0.003, 0.001]), "ionic": t(fhn.init_parameter_values(stim_amplitude=0.0).tolist()),
            "stim_amplitude": t(40.0)}


def adjoint_rank(rank: int, world: int, device: str, target: np.ndarray, dx: float = 0.1,
                 n_steps: int = 16) -> dict | None:
    """The loss ``mean((traces - target)^2)`` and dL/dg through the sharded
    simulator, its seconds forward and backward."""
    from ..parallel.adjoint import build_sharded_diff_simulator

    m3, kw = adjoint_problem(dx, n_steps)
    dm = make_device_mesh(device=device)
    sim = build_sharded_diff_simulator(m3, dm, **kw)
    params = adjoint_params(dm.device, sim.states0.dtype)
    tic = time.perf_counter()
    loss = torch.mean((sim(params) - torch.as_tensor(target, device=dm.device)) ** 2)
    _sync(dm.device)
    fwd = time.perf_counter() - tic
    (g,) = torch.autograd.grad(loss, [params["g"]])
    _sync(dm.device)
    out = {"value": float(loss.detach()), "dg": g.double().cpu().numpy(), "forward_s": fwd,
           "backward_s": time.perf_counter() - tic - fwd, "n": int(m3.num_vertices),
           "exchanges": sim.comm.counts["exchanges"], "all_reduces": sim.comm.counts["all_reduces"]}
    return out if rank == 0 else None


def phase_rank(rank: int, world: int, device: str, adj_target: np.ndarray, cache_key: str | None = None,
               parts=("main", "lv", "bidomain", "adjoint", "census")) -> dict | None:
    """Phase 23's runs in one spawn, in order, each rank on its card."""
    out = {}
    for part in parts:
        tic = time.perf_counter()
        if part == "main":
            out[part] = niederer_rank(rank, world, device, cache_key=cache_key)
        elif part == "lv":
            out[part] = lv_rank(rank, world, device, cache_key=cache_key)
        elif part == "bidomain":
            out[part] = bidomain_rank(rank, world, device)
        elif part == "adjoint":
            out[part] = adjoint_rank(rank, world, device, adj_target)
        elif part == "census":
            out[part] = census_rank(rank, world, device=device)
        if rank == 0:
            out[part]["seconds"] = time.perf_counter() - tic
    return out if rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--device", default="cuda", help="cuda (each rank its card) or cpu")
    ap.add_argument("--dx", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    out = run_census(args.worlds, backend=args.backend, device=args.device, dx=args.dx, n_steps=args.steps)
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
