"""Bidomain runs on the card: the Niederer slab, the LV and the demo.

Counterpart of ``fenicsx_beat_tpu/benchmarks/bidomain_scale.py`` on the
port's :class:`~..bidomain.BidomainSolver`:

- :func:`run_slab`: the Niederer slab (20 x 7 x 3 mm) at ``dx``, TP06
  generalized Rush-Larsen, Godunov, ``pde_theta`` 0.5, dt 0.05, separate
  intracellular and extracellular Niederer tensors along the fibres
  (:func:`bidomain_tensors`, not the monodomain's harmonic mean), the S1
  corner-cube stimulus; a 5 ms warm-up, then a 10 ms timed window that ends
  with one device synchronize, in chunks of 100 steps; then the matched
  monodomain run (:class:`~..fused.FusedMonodomainSolver`, harmonic-mean
  tensor) timed the same way.  Structured mesh: B1 (TP06), B5 and the DCT
  u-block preconditioner;
- :func:`run_lv`: the LV ellipsoid at ``psize`` with the same tensors along
  its fibres and an apex stimulus, one row for each u-block preconditioner
  (Jacobi and SA-AMG, as the JAX script's ``run_lv``): B1, and B8 for every
  operator and every product of the AMG V-cycle;
- :func:`run_demo`: ``demos/bidomain_ue.py``'s own configuration: the unit
  square at 48 x 48 cells, FitzHugh-Nagumo forward Euler, Strang, a
  0.25 x 0.25 corner stimulus of 120 for 2 ms, ``M_i = diag(0.004,
  0.0004)`` and ``M_e = diag(0.002, 0.0035)``, 40 ms at dt 0.1, a save every
  2 ms; returns the ``(t, v_max, max|u_e|)`` rows the demo prints (its VTU
  writer is not ported).  B1 (FHN), B5, the DCT.

The rows carry the JAX script's keys (``cg_iters_max`` and
``cg_iters_mean`` over the per-chunk maxima of every chunk run, warm-up
included, as its monitor collects them; no ``link_pull_ms``) and the
port's: CG iterations and host syncs per step over the timed window, the
field values at its end (``v_max``, ``u_e_max_abs``, ``v_pos_share``: the
share of nodes with v > 0), peak device memory and the device.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.bidomain_scale --dx 0.2 0.1 --lv-psize 0.3
    python -m fenicsx_beat_tpu_torch.benchmarks.bidomain_scale --dx --lv-psize 0.3 --scheme gs

and, on the CPU, the LV's float64 reference with its float32 witnesses
(:func:`run_lv_reference`)::

    python -m fenicsx_beat_tpu_torch.benchmarks.bidomain_scale --lv-psize 0.3 --lv-reference ref.npz
"""

from __future__ import annotations

import argparse
import json
import sys
import time as _time
from pathlib import Path

import numpy as np
import torch

from .. import fem
from .. import mesh as meshmod
from .. import stimulation
from ..base_model import Status
from ..bidomain import BidomainSolver
from ..conductivities import conductivity_tensor, default_conductivities, define_conductivity_tensor
from ..fused import FusedMonodomainSolver
from ..geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry
from ..models import fitzhughnagumo as fhn
from ..models import tentusscher_panfilov_2006 as tp06
from ..stimulation import define_stimulus
from ..telemetry import NullMonitor
from ..units import ureg
from .niederer import LX, LY, LZ

__all__ = [
    "bidomain_tensors", "slab_solver", "lv_solver", "demo_solver", "timed_solve", "perturb_states", "field_stats",
    "run_slab", "run_lv", "run_demo", "run_lv_reference",
]

CHUNK_STEPS = 100  # steps per chunk of the timed runs (the JAX script's)
REFERENCE_T = 5.0  # run_lv_reference's horizon (ms)
# run_lv_reference's runs of each scheme: name, u-block preconditioner,
# dtype, the one-ulp seed (None: the states as they start)
REFERENCE_RUNS = (
    ("f64", "auto", torch.float64, None),
    ("f32_amg", "auto", torch.float32, None), ("f32_amg_ulp", "auto", torch.float32, 1),
    ("f32_jacobi", "jacobi", torch.float32, None), ("f32_jacobi_ulp", "jacobi", torch.float32, 1),
)


class _IterMonitor(NullMonitor):
    """Collects each chunk's worst-step CG iterations."""

    def __init__(self):
        self.iters: list[int] = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def bidomain_tensors(f0):
    """Separate intra/extra conductivity tensors (not the monodomain
    harmonic mean): Niederer g_il/g_it/g_el/g_et scaled by 1/chi to uA/mV,
    the unit convention of ``define_conductivity_tensor``."""
    c = default_conductivities("Niederer")
    chi = c["chi"]

    def scale(g):
        return (g / chi).to("uA/mV").magnitude

    return (conductivity_tensor(scale(c["g_il"]), scale(c["g_it"]), f0),
            conductivity_tensor(scale(c["g_el"]), scale(c["g_et"]), f0))


def _tp06_kwargs():
    return dict(
        ode_fun=tp06.generalized_rush_larsen,
        init_states=tp06.init_state_values(),
        parameters=tp06.init_parameter_values(stim_amplitude=0.0),
        v_index=tp06.state_index("V"),
        theta=1.0,
        pde_theta=0.5,
    )


def _niederer_stimulus(mesh, cells):
    chi = default_conductivities("Niederer")["chi"]
    return define_stimulus(
        mesh=mesh, chi=chi, time=fem.Constant(0.0), subdomain_data=meshmod.meshtags(mesh, mesh.tdim, cells, 1),
        marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )


def _c_m():
    return (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude


def slab_solver(dx: float, device=None, monodomain: bool = False, **kw):
    """The bidomain slab solver at ``dx`` (or, with ``monodomain``, the
    matched fused monodomain solver on the same mesh and stimulus)."""
    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh
    tol = 1e-10
    cells = meshmod.locate_entities(
        mesh, mesh.tdim, lambda x: (x[0] <= 1.5 + tol) & (x[1] <= 1.5 + tol) & (x[2] <= 1.5 + tol)
    )
    common = dict(mesh=mesh, I_s=_niederer_stimulus(mesh, cells), C_m=_c_m(), device=device,
                  **{**_tp06_kwargs(), **kw})
    if monodomain:
        return FusedMonodomainSolver(M=define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")),
                                     **common)
    M_i, M_e = bidomain_tensors(geo.f0)
    return BidomainSolver(M_i=M_i, M_e=M_e, **common)


def lv_kwargs(psize: float) -> dict:
    """The bidomain LV's problem at ``psize`` (mesh, tensors, stimulus,
    C_m and TP06), the arguments :func:`lv_solver` and the sharded
    bidomain solver share: the apex region (x < apex + 2 mm) stimulated,
    the separate tensors along the fibres."""
    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    apex_x = mesh.coords[:, 0].min()
    cells = meshmod.locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    M_i, M_e = bidomain_tensors(geo.f0)
    return dict(mesh=mesh, M_i=M_i, M_e=M_e, I_s=_niederer_stimulus(mesh, cells), C_m=_c_m(), **_tp06_kwargs())


def lv_solver(psize: float, device=None, **kw) -> BidomainSolver:
    """The bidomain LV at ``psize`` (:func:`lv_kwargs`), Jacobi unless
    ``u_precond`` says otherwise (``"auto"`` or ``"amg"``: SA-AMG)."""
    kw.setdefault("u_precond", "jacobi")
    return BidomainSolver(device=device, **{**lv_kwargs(psize), **kw})


def demo_solver(nx: int = 48, device=None, **kw) -> BidomainSolver:
    """``demos/bidomain_ue.py``'s solver on the unit square of ``nx`` x
    ``nx`` cells."""
    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.25) & (x[1] < 0.25))
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=120.0, start=0.0, duration=2.0),
        dZ=stimulation.dx(mesh, subdomain_data=meshmod.meshtags(mesh, 2, cells, 1)),
        marker=1,
    )
    model = dict(ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
                 parameters=fhn.init_parameter_values(stim_amplitude=0.0), v_index=fhn.state_index("v"))
    return BidomainSolver(mesh=mesh, M_i=np.diag([0.004, 0.0004]), M_e=np.diag([0.002, 0.0035]), I_s=I_s,
                          theta=0.5, device=device, **{**model, **kw})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_solve(solver, T_warm: float, T_timed: float, dt: float) -> dict:
    """A warm-up solve of ``T_warm`` ms, then the timed window of
    ``T_timed`` ms that ends with one device synchronize, both in chunks of
    :data:`CHUNK_STEPS`.  Works on the bidomain and the fused monodomain
    solver; returns the wall, ms simulated per s, the per-chunk worst-step
    CG iterations of every chunk, and per-step CG iterations and host syncs
    of the timed window."""
    mon = _IterMonitor()
    solver.monitor = mon
    ok = True
    if T_warm > 0:
        ok = solver.solve((0.0, T_warm), dt=dt, save_freq=CHUNK_STEPS) == Status.OK
    iters0, syncs0 = solver.cg_iterations, solver.host_syncs
    n_warm = len(mon.iters)
    _sync(solver.device)
    tic = _time.perf_counter()
    status = solver.solve((T_warm, T_warm + T_timed), dt=dt, save_freq=CHUNK_STEPS)
    _sync(solver.device)
    wall = _time.perf_counter() - tic
    steps = int(round(T_timed / dt))
    return {
        "wall_s": wall,
        "ms_per_s": T_timed / wall if wall > 0 else 0.0,
        "chunk_iters": mon.iters,
        "timed_chunk_iters": mon.iters[n_warm:],
        "cg_iters_per_step": (solver.cg_iterations - iters0) / steps,
        "host_syncs_per_step": (solver.host_syncs - syncs0) / steps,
        "converged": ok and status == Status.OK,
    }


def perturb_states(solver, seed: int) -> None:
    """Move each state entry of ``solver`` by one ulp of its row's largest
    magnitude (of 1 for a row of zeros, as FitzHugh-Nagumo starts), up,
    down or not at all, at random (``seed``): a run from there is a witness
    of the working dtype's rounding noise."""
    s = solver.states
    step = torch.as_tensor(np.random.default_rng(seed).integers(-1, 2, tuple(s.shape))).to(s)
    mag = s.abs().amax(dim=1, keepdim=True)
    mag = torch.where(mag > 0, mag, torch.ones_like(mag))
    s.add_(step * (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag))


def field_stats(solver: BidomainSolver) -> dict:
    """v_max, max |u_e|, the share of nodes with v > 0, and whether every
    state and u_e is finite."""
    v = solver.v
    return {
        "v_max": float(v.max()),
        "u_e_max_abs": float(solver.u_e.abs().max()),
        "v_pos_share": float((v > 0).double().mean()),
        "finite": bool(torch.isfinite(solver.states).all() and torch.isfinite(solver.u_e).all()),
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def _u_precond(bi: BidomainSolver) -> str:
    return "dct" if bi._u_dct else "amg" if bi._u_amg else "jacobi"


def _row(bi: BidomainSolver, case: str, setup_s: float, dt: float, T_timed: float, timed: dict, peak) -> dict:
    iters = timed["chunk_iters"]
    return {
        "case": case,
        "n_nodes": int(bi.V.ndofs),
        "dt": dt,
        "scheme": bi.scheme,
        "gs_u_rtol": bi.gs_u_rtol,
        "u_precond": _u_precond(bi),
        "setup_s": setup_s,
        "amg_setup_s": bi.amg_setup_s,
        "amg_levels": bi._amg.n_levels if bi._u_amg else 0,
        "timed_ms": T_timed,
        "wall_s": timed["wall_s"],
        "ms_per_s": timed["ms_per_s"],
        "cg_iters_max": int(max(iters)),
        "cg_iters_mean": float(np.mean(iters)),
        "chunk_iters": iters,
        "cg_iters_per_step": timed["cg_iters_per_step"],
        "host_syncs_per_step": timed["host_syncs_per_step"],
        "converged": timed["converged"],
        **field_stats(bi),
        "peak_device_gib": peak,
        "device": _device_name(bi.device),
    }


def run_slab(dx: float, dt: float = 0.05, T_warm: float = 5.0, T_timed: float = 10.0, u_precond: str = "auto",
             scheme: str = "monolithic", gs_u_rtol: float | None = None, device=None, use_kernels: bool = True,
             monodomain: bool = True, return_solver: bool = False, cache_key: str | None = None):
    """The bidomain slab at ``dx`` (and the matched monodomain run unless
    ``monodomain`` is False); one row, and the solver with
    ``return_solver``.  ``cache_key`` opts both solvers' operator
    assemblies into the disk cache."""
    tic = _time.perf_counter()
    bi = slab_solver(dx, device=device, u_precond=u_precond, scheme=scheme, gs_u_rtol=gs_u_rtol,
                     use_kernels=use_kernels, cache_key=cache_key)
    dev = bi.device
    _sync(dev)
    setup_s = _time.perf_counter() - tic
    _reset_peak(dev)
    timed = timed_solve(bi, T_warm, T_timed, dt)
    row = _row(bi, f"slab_dx{dx:g}" + ("" if scheme == "monolithic" else f"_{scheme}"), setup_s, dt, T_timed,
               timed, _peak_gib(dev))
    row["dx"] = dx
    if monodomain:
        mono = slab_solver(dx, device=device, monodomain=True, use_kernels=use_kernels,
                           operator_cache_key=cache_key)
        m = timed_solve(mono, T_warm, T_timed, dt)
        row["mono_ms_per_s"] = m["ms_per_s"]
        row["mono_cg_iters_max"] = int(max(m["chunk_iters"]))
        row["bidomain_slowdown"] = m["ms_per_s"] / row["ms_per_s"] if row["ms_per_s"] else None
    return (row, bi) if return_solver else row


def run_lv(psize: float, dt: float = 0.05, T_warm: float = 5.0, T_timed: float = 10.0,
           preconds=("jacobi", "amg"), scheme: str = "monolithic", gs_u_rtol: float | None = None,
           device=None, use_kernels: bool = True) -> tuple[list[dict], list[BidomainSolver]]:
    """The bidomain LV at ``psize``, one row for each u-block preconditioner
    of ``preconds`` (``"jacobi"``, ``"amg"``, or ``"auto"``, which takes AMG
    on this unstructured mesh), as the JAX script's ``run_lv``: setup and
    AMG setup seconds, ms/s, CG iterations a step (per-chunk worst steps
    and the timed window's mean); the rows, and the solvers they ran."""
    rows, solvers = [], []
    for precond in preconds:
        tic = _time.perf_counter()
        bi = lv_solver(psize, device=device, u_precond=precond, scheme=scheme, gs_u_rtol=gs_u_rtol,
                       use_kernels=use_kernels)
        dev = bi.device
        _sync(dev)
        setup_s = _time.perf_counter() - tic
        _reset_peak(dev)
        timed = timed_solve(bi, T_warm, T_timed, dt)
        case = f"lv_ps{psize:g}_{_u_precond(bi)}" + ("" if scheme == "monolithic" else f"_{scheme}")
        rows.append(_row(bi, case, setup_s, dt, T_timed, timed, _peak_gib(dev)))
        solvers.append(bi)
    return rows, solvers


def run_lv_reference(path, psize: float = 0.3, T: float = REFERENCE_T, dt: float = 0.05,
                     schemes=("monolithic", "gs"), device="cpu") -> dict:
    """The bidomain LV at ``psize`` over ``T`` ms on ``device`` (the CPU), for
    each scheme in float64 (SA-AMG at the float64 default rtol 1e-8: the
    reference) and in float32 on SA-AMG and on Jacobi, each also from
    states one ulp away (:data:`REFERENCE_RUNS`; float32 CG at rtol 1e-6,
    as on the card).  The float32 runs' distance to the float64 one is
    what float32 and rtol 1e-6 leave of each preconditioner's solution.
    Writes every run's v and u_e to the npz ``path`` (keys
    ``"<scheme>/<run>/v"`` and ``".../u_e"``); returns each run's CG
    iterations a step, worst chunk and seconds, and its largest gaps to
    the float64 run."""
    arrays, out = {}, {"psize": psize, "T": T, "runs": {}}
    for scheme in schemes:
        for name, precond, dtype, seed in REFERENCE_RUNS:
            tic = _time.perf_counter()
            bi = lv_solver(psize, device=device, dtype=dtype, u_precond=precond, scheme=scheme)
            if seed is not None:
                perturb_states(bi, seed)
            mon = _IterMonitor()
            bi.monitor = mon
            ok = bi.solve((0.0, T), dt=dt, save_freq=CHUNK_STEPS) == Status.OK
            key = f"{scheme}/{name}"
            arrays[f"{key}/v"] = bi.v.double().cpu().numpy()
            arrays[f"{key}/u_e"] = bi.u_e.double().cpu().numpy()
            out["runs"][key] = {"converged": ok, "cg_iters_per_step": bi.cg_iterations / bi.steps,
                                "cg_iters_max": int(max(mon.iters)), "seconds": _time.perf_counter() - tic}
            if name != "f64":
                out["runs"][key].update({f"max_abs_d{f}": float(np.abs(arrays[f"{key}/{f}"]
                                                                       - arrays[f"{scheme}/f64/{f}"]).max())
                                         for f in ("v", "u_e")})
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return out


def run_demo(nx: int = 48, T: float = 40.0, dt: float = 0.1, device=None, use_kernels: bool = True,
             **model) -> dict:
    """``demos/bidomain_ue.py`` on the port: the per-save ``(t, v_max,
    max|u_e|)`` rows it prints, the status, and the run's timing.
    ``model`` replaces the demo's FitzHugh-Nagumo (``ode_fun``,
    ``init_states``, ``parameters``, ``v_index``)."""
    tic = _time.perf_counter()
    bi = demo_solver(nx, device=device, use_kernels=use_kernels, **model)
    dev = bi.device
    _sync(dev)
    setup_s = _time.perf_counter() - tic
    mon = _IterMonitor()
    bi.monitor = mon
    rows = []

    def cb(t, v, u):
        rows.append((t, float(v.max()), float(np.abs(u).max())))

    tic = _time.perf_counter()
    status = bi.solve((0.0, T), dt=dt, save_freq=max(1, int(2.0 / dt)), save_callback=cb)
    _sync(dev)
    wall = _time.perf_counter() - tic
    return {
        "case": f"demo_nx{nx}",
        "n_nodes": int(bi.V.ndofs),
        "dt": dt,
        "T": T,
        "status": status.name,
        "rows": rows,
        "setup_s": setup_s,
        "wall_s": wall,
        "ms_per_s": T / wall if wall > 0 else 0.0,
        "cg_iters_max": int(max(mon.iters)),
        "cg_iters_per_step": bi.cg_iterations / bi.steps,
        "host_syncs_per_step": bi.host_syncs / bi.steps,
        "u_precond": _u_precond(bi),
        **field_stats(bi),
        "device": _device_name(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dx", type=float, nargs="*", default=[0.2, 0.1])
    ap.add_argument("--lv-psize", type=float, default=0.3)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--scheme", default="monolithic", help="time-coupling scheme (monolithic | gs)")
    ap.add_argument("--gs-u-rtol", type=float, default=0.0, help="gs elliptic-solve rtol (0 = cg_rtol)")
    ap.add_argument("--lv-preconds", nargs="+", default=["jacobi", "amg"], help="the LV's u-block preconditioners")
    ap.add_argument("--skip-lv", action="store_true")
    ap.add_argument("--demo", action="store_true", help="also run demos/bidomain_ue.py's configuration")
    ap.add_argument("--lv-reference", metavar="NPZ", default=None,
                    help="only the LV's 5 ms CPU reference (float64 and float32 witnesses), its fields to NPZ")
    args = ap.parse_args(argv)
    if args.lv_reference is not None:
        print(json.dumps(run_lv_reference(args.lv_reference, psize=args.lv_psize, dt=args.dt)))
        return 0
    for dx in args.dx:
        print(json.dumps(run_slab(dx, dt=args.dt, scheme=args.scheme, gs_u_rtol=args.gs_u_rtol or None)))
    if not args.skip_lv:
        rows, _ = run_lv(args.lv_psize, dt=args.dt, preconds=args.lv_preconds, scheme=args.scheme,
                         gs_u_rtol=args.gs_u_rtol or None)
        for row in rows:
            print(json.dumps(row))
    if args.demo:
        print(json.dumps(run_demo()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
