"""Biventricular endocardial activation with a 12-lead pseudo-ECG, through
the object-oriented API.

The port's copy of ``demos/biv_endocardial.py`` (lines 49-197): the
two-cavity BiV ellipsoid (``get_biv_ellipsoid_geometry``, LDRB-lite fibers
from a Laplace solve on the card), transmural endo/mid/epi layers from two
Laplace solves (``expand_layer_biv``; both solves and the fibers' take the
SA-AMG V-cycle from 5,000 nodes on, as in the JAX package), per-layer
ToR-ORd dynCl celltypes (mid/endo/epi = 2/0/1) from single-cell pacing
(``get_steady_state``, BCL 1000 ms), random multi-point activation over
both endocardia (``generate_random_activation``: seed 42, 20 points, delays
0-4 ms, 2 ms at 50,000/1400 over a ``0.7 * psize`` neighbourhood),
Niederer conductivities along the fibres, ``MonodomainModel`` +
``DolfinMultiODESolver`` (one ToR-ORd B1 launch per layer a step) +
``MonodomainSplittingSolver`` (Godunov), dt 0.05 ms to T = 20 ms, the
voltage checkpointed every 1 ms (:mod:`..io`), then ``ECGRecovery`` at the
ten electrodes from the checkpoint and the standard 12 leads (``Leads12``).

The electrode potentials go through ``ECGRecovery.register_electrodes``
and ``electrode_potentials``: the quadrature of the demo's ``eval`` forms,
summed as one device product a frame instead of on the host.  Besides the
demo's output, the run stamps activation times on the host from the
voltage each step writes there (the step's start where v first exceeds
0 mV), and reports how far from its site the excitation reached.

The demo's ``MonodomainModel`` takes the default membrane capacitance 1 on
a mesh in mm, 100 times the 1 uF/cm^2 (0.01 uF/mm^2) that the Niederer
conductivities assume: the diffusion is 100 times weaker, its upstroke
front far thinner than an element, and the excitation stays within about
one element of each site.  ``build_biv`` and ``site_stimulus`` take
another capacitance (the stimulus scaled with it, so that a site
depolarizes as fast as in the demo): ``chip_smoke.py`` runs the same
sites at 1 uF/cm^2 from boxes of half-width 1 mm, where the wave crosses
the ventricles.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.biv_endocardial --psize 0.15
    python -m fenicsx_beat_tpu_torch.benchmarks.biv_endocardial --quick --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time as _time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import fem
from .. import mesh as meshmod
from ..conductivities import default_conductivities, define_conductivity_tensor
from ..ecg import ECGRecovery, Leads12
from ..geometry import get_biv_ellipsoid_geometry
from ..io import CheckpointWriter, load_checkpoint
from ..models import torord_dyncl
from ..monodomain_solver import MonodomainSplittingSolver
from ..single_cell import get_steady_state
from ..stimulation import Stimulus, generate_random_activation
from ..stimulation import dx as dx_measure
from ..utils import expand_layer_biv
from .lv import CELLTYPES, LAYER_SIZE, PREPACE_BCL
from .lv_endocardial import build_oo_lv
from .niederer import ACTIVATION_THRESHOLD

__all__ = ["LEADS", "LEAD_NAMES", "BiVSetup", "site_stimulus", "biv_setup", "biv_steady_states", "build_biv",
           "spread_mm", "BiVRun", "run_biv",
           "biv_ecg", "rv_free_wall", "run_demo", "main"]

LEADS = dict(
    RA=(-15.0, 0.0, -10.0),
    LA=(4.0, -12.0, -7.0),
    RL=(0.0, 20.0, 3.0),
    LL=(17.0, 11.0, 7.0),
    V1=(-3.0, 4.0, -9.0),
    V2=(0.0, 2.0, -8.0),
    V3=(3.0, 1.0, -8.0),
    V4=(6.0, 1.0, -6.0),
    V5=(10.0, 2.0, 0.0),
    V6=(10.0, -6.0, 2.0),
)
LEAD_NAMES = ["I", "II", "III", "aVR", "aVL", "aVF", "V1_", "V2_", "V3_", "V4_", "V5_", "V6_"]
SEED = 42  # the demo's activation sites and delays
STIM_AMPLITUDE = 50_000.0 / 1400.0  # 50,000 uA/cm^3 over chi
STIM_DURATION = 2.0
MAX_DELAY = 4.0
CHECKPOINT_MS = 1.0
RV_FREE_Y = 4.5  # the RV free wall lies beyond the LV's epicardium (tests/test_geometry.py)
QUICK = dict(T=3.0, psize=0.7, n_activation_points=5)  # the demo's --quick


def rv_free_wall(coords: np.ndarray) -> np.ndarray:
    """The nodes of the RV free wall (y > 4.5 mm); the rest is the LV side."""
    return coords[:, 1] > RV_FREE_Y


@dataclass
class BiVSetup:
    """The demo's inputs: geometry, P1 space, per-node layers, the
    conductivity, the activation stimulus, its picked endocardial nodes and
    their delays (ms), and the host seconds of each part."""

    geo: object
    V: fem.FunctionSpace
    layers: np.ndarray
    M: object
    I_s: Stimulus
    picks: np.ndarray
    delays: np.ndarray
    setup_s: dict


def site_stimulus(mesh, points: np.ndarray, delays: np.ndarray, tol: float, C_m: float = 1.0) -> Stimulus:
    """The demo's activation: ``STIM_AMPLITUDE * C_m`` (the demo's rate of
    depolarization at a site, whatever the capacitance) for
    ``STIM_DURATION`` ms from each point's delay, wherever every coordinate
    lies within ``tol`` of the point (``generate_random_activation``), over
    every cell."""
    activation = generate_random_activation(
        mesh=mesh, time=fem.Constant(0.0), points=points, delays=delays, stim_start=0.0,
        stim_duration=STIM_DURATION, stim_amplitude=STIM_AMPLITUDE * C_m, tol=tol,
    )
    cells = meshmod.locate_entities(mesh, mesh.tdim, lambda x: np.ones(x.shape[1], dtype=bool))
    all_tags = meshmod.meshtags(mesh, mesh.tdim, cells, 1)
    return Stimulus(expr=activation, dZ=dx_measure(mesh, subdomain_data=all_tags), marker=1)


def biv_setup(psize: float = 0.35, n_activation_points: int = 20, device=None, cache: bool = True,
              seed: int = SEED) -> BiVSetup:
    """The demo's geometry, layers (``expand_layer_biv`` on ``device``),
    Niederer conductivity along ``f0`` and random endocardial activation:
    ``n_activation_points`` nodes drawn from both endocardia by
    ``np.random.default_rng(seed)``, their delays uniform in [0, 4) ms."""
    tic = _time.perf_counter()
    geo = get_biv_ellipsoid_geometry(psize_ref=psize, cache=cache, device=device)
    # the mesh, its tags and the fibers' Laplace solve; with the cache on,
    # a build on a cold cache and a read after it
    setup_s = {"geometry_s": _time.perf_counter() - tic, "geometry_cache": cache}
    mesh, ffun = geo.mesh, geo.ffun

    tic = _time.perf_counter()
    V = fem.functionspace(mesh, ("P", 1))
    lv_m, rv_m = geo.markers["LV"][0], geo.markers["RV"][0]
    layers = expand_layer_biv(
        V, ffun, endo_lv_marker=lv_m, endo_rv_marker=rv_m, epi_marker=geo.markers["EPI"][0],
        endo_size=LAYER_SIZE, epi_size=LAYER_SIZE, output_mid_marker=0, output_endo_marker=1,
        output_epi_marker=2, device=device,
    )
    setup_s["layers_s"] = _time.perf_counter() - tic

    rng = np.random.default_rng(seed)
    endo_facets = np.concatenate([ffun.find(lv_m), ffun.find(rv_m)])
    endo_verts = np.unique(mesh.entities(2)[endo_facets].ravel())
    picks = rng.choice(endo_verts, size=min(n_activation_points, endo_verts.size), replace=False)
    delays = rng.uniform(0.0, MAX_DELAY, size=len(picks))
    I_s = site_stimulus(mesh, mesh.coords[picks], delays, tol=0.7 * psize)
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    return BiVSetup(geo=geo, V=V, layers=layers, M=M, I_s=I_s, picks=picks, delays=delays, setup_s=setup_s)


def biv_steady_states(nbeats: int = 1, dt: float = 0.05, device=None, outdir: Path | None = None) -> dict:
    """Each layer's ToR-ORd dynCl cell paced ``nbeats`` beats at BCL 1000 ms
    from ``init_state_values()`` with its own stimulus, as the demo does
    (marker -> states; cached under ``outdir``/layer-<marker>)."""
    from .lv import STEADY_DIR

    outdir = Path(outdir) if outdir is not None else STEADY_DIR
    m = torord_dyncl
    return {
        marker: get_steady_state(
            fun=m.generalized_rush_larsen, init_states=m.init_state_values(),
            parameters=m.init_parameter_values(celltype=ct), outdir=outdir / f"layer-{marker}",
            BCL=PREPACE_BCL, nbeats=nbeats, dt=dt, device=device,
        )
        for marker, ct in CELLTYPES.items()
    }


def build_biv(setup: BiVSetup, steady: dict, device=None, use_kernels: bool = True,
              C_m: float = 1.0) -> MonodomainSplittingSolver:
    """The demo's solver: ToR-ORd dynCl per layer from ``steady`` (marker ->
    states) through ``DolfinMultiODESolver``, the activation stimulus,
    Niederer conductivity, membrane capacitance ``C_m``, Godunov (the LV
    demo's builder, which this demo's solver equals)."""
    return build_oo_lv(setup.geo.mesh, setup.layers, setup.M, setup.I_s, steady, device=device,
                       use_kernels=use_kernels, C_m=C_m)


def spread_mm(coords: np.ndarray, picks: np.ndarray, activation: np.ndarray) -> float:
    """How far the excitation reached: the largest distance (mm) of a fired
    node (``activation >= 0``) from its nearest picked site."""
    fired = coords[activation >= 0]
    if not len(fired):
        return 0.0
    d = np.linalg.norm(fired[:, None, :] - coords[picks][None], axis=-1).min(axis=1)
    return float(d.max())


@dataclass
class BiVRun:
    """A run of :func:`run_biv`: the checkpoint, every node's activation
    time (ms, -1 if not activated), the printed voltage ranges, the timed
    loop's wall, CG iterations, exit tests read back and voltage
    crossings, and whether every state stayed finite."""

    simulated_ms: float
    n_steps: int
    wall_s: float
    checkpoint: Path | None
    activation: np.ndarray
    v_range: list
    cg_iters_sum: int
    host_syncs: int
    host_transfers: int
    all_finite: bool
    snapshot: dict | None = None

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_s if self.wall_s > 0 else 0.0


def run_biv(solver: MonodomainSplittingSolver, T: float, dt: float, checkpoint: Path | None = None,
            t0: float = 0.0, verbose: bool = True, snapshot_at: float | None = None) -> BiVRun:
    """Step ``solver`` from ``t0`` to ``T`` as the demo does (``solver.step``
    by ``dt``), writing the voltage to ``checkpoint`` (an npz, :mod:`..io`)
    at ``t0`` and every 1 ms and printing its range there; activation times
    stamped from the host voltage after each step.  With ``snapshot_at``
    the run keeps a copy of every layer's states and of the voltage at
    that time (``BiVRun.snapshot``: ``t``, ``states`` by marker, ``v``).
    The timed loop ends with a device synchronize; the checkpoint file is
    written after it."""
    pde = solver.pde
    act = np.full(pde.V.ndofs, -1.0)
    snap_step = None if snapshot_at is None else int(round((snapshot_at - t0) / dt))
    snapshot = None
    every = max(1, int(round(CHECKPOINT_MS / dt)))
    n_steps = int(round((T - t0) / dt))
    writer = CheckpointWriter(checkpoint, pde.V.mesh) if checkpoint is not None else None
    if writer is not None:
        writer.write(t0, pde.state.x.array)
    it0, sync0, tr0 = pde.cg_iterations, pde._pde.host_syncs, solver.host_transfers
    rows = []
    tic = _time.perf_counter()
    for step in range(1, n_steps + 1):
        lo = t0 + (step - 1) * dt
        solver.step((lo, lo + dt))
        v = pde.state.x.array
        act[(v > ACTIVATION_THRESHOLD) & (act < 0)] = lo
        if step == snap_step:
            snapshot = {"t": lo + dt, "states": {m: solver.ode.values(m).clone() for m in CELLTYPES},
                        "v": np.array(v)}
        if step % every == 0:
            t = t0 + step * dt
            rows.append((t, float(v.min()), float(v.max())))
            if verbose:
                print(f"t={t:6.1f}  v_range=[{v.min():8.2f}, {v.max():8.2f}]")
            if writer is not None:
                writer.write(t, v)
    if pde.device.type == "cuda":
        torch.cuda.synchronize(pde.device)
    wall = _time.perf_counter() - tic
    if writer is not None:
        writer.save()
    ode = solver.ode
    finite = all(bool(torch.isfinite(ode.values(m)).all()) for m in CELLTYPES)
    return BiVRun(
        simulated_ms=n_steps * dt, n_steps=n_steps, wall_s=wall, checkpoint=checkpoint, activation=act,
        v_range=rows, cg_iters_sum=pde.cg_iterations - it0, host_syncs=pde._pde.host_syncs - sync0,
        host_transfers=solver.host_transfers - tr0,
        all_finite=finite and bool(np.isfinite(pde.state.x.array).all()), snapshot=snapshot,
    )


def biv_ecg(V: fem.FunctionSpace, M, checkpoint: Path, device=None) -> tuple[np.ndarray, Leads12, dict]:
    """The demo's postprocessing: every checkpointed frame through
    ``ECGRecovery`` (sigma_b 1) on ``device``, the ten electrode
    potentials, and the 12 leads.  Returns ``(times, leads, stats)``:
    recovery setup seconds, CG iterations and seconds per frame."""
    data = load_checkpoint(checkpoint)
    vfun = fem.Function(V)
    tic = _time.perf_counter()
    ecg = ECGRecovery(v=vfun, sigma_b=1.0, M=M, device=device)
    ecg.register_electrodes(np.array(list(LEADS.values())))
    setup_s = _time.perf_counter() - tic
    traces = {k: [] for k in LEADS}
    iters = []
    tic = _time.perf_counter()
    for frame in data.values:
        vfun.x.array[:] = frame
        _, info = ecg.solve_device()
        iters.append(info.iterations)
        for k, phi in zip(LEADS, ecg.electrode_potentials()):
            traces[k].append(float(phi))
    frames_s = _time.perf_counter() - tic
    leads = Leads12(**{k: np.array(tr) for k, tr in traces.items()})
    stats = {"setup_s": setup_s, "frames": len(data.values), "cg_iters": iters,
             "s_per_frame": frames_s / max(1, len(data.values))}
    return data.times, leads, stats


def run_demo(psize: float = 0.35, T: float = 20.0, dt: float = 0.05, nbeats: int = 1,
             n_activation_points: int = 20, outdir: Path = Path("results-biv"), device=None,
             steady: dict | None = None, verbose: bool = True) -> dict:
    """The whole demo: setup, pre-pacing (or the ready ``steady`` states),
    the run with its checkpoint, the ECG; one result dict (setup seconds
    by part, nodes, ms/s, CG iterations, host syncs and crossings per
    step, activated shares at T of the LV side and the RV free wall, how
    far from its site the excitation reached, every picked node fired,
    the leads' extremes)."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    setup = biv_setup(psize, n_activation_points, device=device)
    mesh = setup.geo.mesh
    if verbose:
        print(f"geometry: {mesh.num_vertices} nodes, {mesh.num_cells} tets")
    tic = _time.perf_counter()
    if steady is None:
        steady = biv_steady_states(nbeats, dt, device=device, outdir=outdir)
        setup.setup_s["prepace_s"] = _time.perf_counter() - tic
    tic = _time.perf_counter()
    solver = build_biv(setup, steady, device=device)
    setup.setup_s["assembly_s"] = _time.perf_counter() - tic
    res = run_biv(solver, T, dt, checkpoint=outdir / "voltage", verbose=verbose)
    times, leads, ecg_stats = biv_ecg(setup.V, setup.M, res.checkpoint, device=solver.pde.device)
    extremes = {name: (float(getattr(leads, name).min()), float(getattr(leads, name).max())) for name in LEAD_NAMES}
    if verbose:
        print("lead    min        max")
        for name, (lo, hi) in extremes.items():
            print(f"{name:5s} {lo:10.3e} {hi:10.3e}")
    np.savez(outdir / "ecg12.npz", times=times, **{name: getattr(leads, name) for name in LEAD_NAMES})
    rv = rv_free_wall(mesh.coords)
    fired = res.activation >= 0
    return {
        "n_nodes": int(mesh.num_vertices), "n_cells": int(mesh.num_cells), "psize": psize, "T": T, "dt": dt,
        "setup_s": setup.setup_s, "ms_per_second": res.ms_per_second, "wall_s": res.wall_s,
        "cg_iters_per_step": res.cg_iters_sum / res.n_steps, "host_syncs_per_step": res.host_syncs / res.n_steps,
        "host_transfers_per_step": res.host_transfers / res.n_steps,
        "lv_side_share": float(fired[~rv].mean()), "rv_free_wall_share": float(fired[rv].mean()),
        "spread_mm": spread_mm(mesh.coords, setup.picks, res.activation),
        "picks_fired": bool(fired[setup.picks].all()), "all_finite": res.all_finite,
        "leads": extremes, "ecg": ecg_stats,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-T", type=float, default=20.0, help="end time (ms)")
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--psize", type=float, default=0.35)
    ap.add_argument("--nbeats", type=int, default=1)
    ap.add_argument("--n-activation-points", type=int, default=20)
    ap.add_argument("-o", "--outdir", type=Path, default=Path("results-biv"))
    ap.add_argument("--quick", action="store_true", help="smoke: coarse mesh, short horizon")
    ap.add_argument("--steady-states", type=Path, default=None,
                    help="npz of ready steady states, one array per layer marker ('0', '1', '2')")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.quick:
        args.T, args.psize, args.n_activation_points = QUICK["T"], QUICK["psize"], QUICK["n_activation_points"]
    steady = None
    if args.steady_states is not None:
        with np.load(args.steady_states) as f:
            steady = {int(k): f[k] for k in f.files}
    out = run_demo(psize=args.psize, T=args.T, dt=args.dt, nbeats=args.nbeats,
                   n_activation_points=args.n_activation_points, outdir=args.outdir, device=args.device,
                   steady=steady)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
