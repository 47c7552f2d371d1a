"""Pseudo-ECG recovery on the Niederer slab, on the card.

Two configurations:

* :func:`run_ecg_scale`, the port of ``fenicsx_beat_tpu/benchmarks/ecg_scale.py``:
  :class:`~..ecg.ECGRecovery` on the slab at a production resolution
  (default dx=0.05: 3,449,001 nodes, 20,160,000 tets), a 12-lead electrode
  set (10 electrodes), and ``n_frames`` frames of a moving sigmoid
  wavefront, each a warm-started mass solve for Im plus the device-side
  electrode product.  At dx=0.05 the operand is over 8 MiB and the solve
  runs B6; at dx=0.1 it runs B5.
* :func:`run_niederer_ecg`: the Niederer main path (TP06 GRL, Strang,
  dt=0.05, dx=0.1 by default) through the fused solver, with the pseudo-ECG
  of the solver's voltage taken every ``frame_ms`` (1 kHz, a clinical
  ECG's rate) with the solver's own conductivity tensor, and the 12 leads
  built from the traces.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.ecg_scale [dx] [frames]
    python -m fenicsx_beat_tpu_torch.benchmarks.ecg_scale --cpu [dx] [frames]
    python -m fenicsx_beat_tpu_torch.benchmarks.ecg_scale --niederer [dx] [T]

``--cpu`` runs :func:`run_ecg_scale` on the host in float64 through the
plain PyTorch twins: the reference for the card's float32 leads.  Each
prints one JSON line.  Every second is a host-clock reading around
work that ends in a device synchronize (or a read-back to the host).
"""

from __future__ import annotations

import json
import sys
import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from .. import fem
from ..ecg import ECGRecovery, Leads12
from ..geometry import get_3D_slab_geometry

__all__ = [
    "ELECTRODES_MM",
    "LEAD_NAMES",
    "wavefront",
    "twelve_leads",
    "ECGScaleSetup",
    "build_ecg_scale",
    "run_ecg_scale",
    "run_niederer_ecg",
]

# A plausible electrode layout for the 20x7x3 mm slab scaled up: limb +
# precordial positions a few slab-lengths away (the JAX package's layout,
# fenicsx_beat_tpu/benchmarks/ecg_scale.py:29-40)
ELECTRODES_MM = {
    "RA": (-20.0, -10.0, 40.0),
    "LA": (40.0, -10.0, 40.0),
    "LL": (40.0, 30.0, -40.0),
    "RL": (-20.0, 30.0, -40.0),
    "V1": (5.0, 3.5, 25.0),
    "V2": (9.0, 3.5, 25.0),
    "V3": (13.0, 3.5, 22.0),
    "V4": (17.0, 3.5, 20.0),
    "V5": (21.0, 3.5, 18.0),
    "V6": (25.0, 3.5, 16.0),
}
LEAD_NAMES = ("I", "II", "III", "aVR", "aVL", "aVF", "V1_", "V2_", "V3_", "V4_", "V5_", "V6_")


def wavefront(x: np.ndarray, k: int) -> np.ndarray:
    """Frame ``k``'s voltage (mV): a sigmoid front at x = 6 + 0.2 k mm."""
    return -85.0 + 125.0 / (1.0 + np.exp(-(x[:, 0] - 6.0 - 0.2 * k) / 0.5))


def twelve_leads(phi: np.ndarray) -> dict[str, np.ndarray]:
    """The 12 leads of electrode potentials ``phi`` ([..., 10], in the order
    of :data:`ELECTRODES_MM`)."""
    leads = Leads12(**{name: phi[..., i] for i, name in enumerate(ELECTRODES_MM)})
    return {name: np.asarray(getattr(leads, name)) for name in LEAD_NAMES}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


@dataclass
class ECGScaleSetup:
    dx: float
    V: fem.FunctionSpace
    v: fem.Function
    ecg: ECGRecovery
    n_cells: int
    mesh_build_s: float
    recovery_setup_s: float
    electrode_weights_s: float


def build_ecg_scale(dx: float = 0.05, device=None, operator_cache_key: str | None = None) -> ECGScaleSetup:
    """The slab, its ECG recovery and the registered electrodes, each part
    timed (the host setup of :func:`run_ecg_scale`); ``operator_cache_key``
    opts the recovery's assembly into the operator disk cache."""
    tic = _time.perf_counter()
    geo = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0)
    V = fem.functionspace(geo.mesh, ("P", 1))
    v = fem.Function(V)
    v.x.array[:] = wavefront(V.dof_coords, 0)
    mesh_s = _time.perf_counter() - tic

    tic = _time.perf_counter()
    ecg = ECGRecovery(v=v, M=1.0, device=device, operator_cache_key=operator_cache_key)
    setup_s = _time.perf_counter() - tic

    tic = _time.perf_counter()
    ecg.register_electrodes(list(ELECTRODES_MM.values()))
    _sync(ecg.device)
    weights_s = _time.perf_counter() - tic
    return ECGScaleSetup(dx, V, v, ecg, geo.mesh.num_cells, mesh_s, setup_s, weights_s)


def run_ecg_scale(
    dx: float = 0.05,
    n_frames: int = 10,
    device=None,
    setup: ECGScaleSetup | None = None,
) -> dict:
    """Time the ECG recovery frames at ``dx`` (the setup from
    :func:`build_ecg_scale` unless one is given).  Returns the JAX
    package's keys, with ``use_kernels`` (True: on the CPU the wrappers
    run the twins) and ``kernel`` (B5 or B6) in place of ``use_pallas``,
    and the setup's parts, each frame's CG convergence, the potentials'
    finiteness and the peak device memory."""
    setup = setup or build_ecg_scale(dx, device=device)
    ecg, v, x = setup.ecg, setup.v, setup.V.dof_coords
    dev = ecg.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ecg.host_syncs = 0
    iters, converged, finite = [], [], True
    best_frame, upload_s = float("inf"), 0.0
    tic_all = _time.perf_counter()
    for k in range(n_frames):
        tic = _time.perf_counter()
        v.x.array[:] = wavefront(x, k)
        im, info = ecg.solve_device()
        phi = ecg.electrode_potentials(im)
        best_frame = min(best_frame, _time.perf_counter() - tic)
        upload_s += ecg.last_upload_s
        iters.append(int(info.iterations))
        converged.append(bool(info.converged))
        finite &= bool(np.isfinite(phi).all())
    total_s = _time.perf_counter() - tic_all
    leads = twelve_leads(phi)
    return {
        "backend": dev.type,
        "device_name": _device_name(dev),
        "dx": setup.dx,
        "n_nodes": setup.V.ndofs,
        "n_cells": setup.n_cells,
        "n_electrodes": len(ELECTRODES_MM),
        "mesh_build_s": setup.mesh_build_s,
        "recovery_setup_s": setup.recovery_setup_s,
        "assembly_s": ecg.setup_s["assembly_s"],
        "operators_to_device_s": ecg.setup_s["operators_s"],
        "electrode_weights_s": setup.electrode_weights_s,
        "n_frames": n_frames,
        "frames_total_s": total_s,
        "best_frame_s": best_frame,
        "upload_s_per_frame": upload_s / n_frames,
        "cg_iters_per_frame": iters,
        "cg_converged_per_frame": converged,
        "potentials_finite": finite,
        "host_syncs_per_frame": ecg.host_syncs / n_frames,
        "peak_device_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None,
        "use_kernels": ecg.use_kernels,
        "kernel": ecg.kernel,
        "lead_I_sample": float(leads["I"]),
    }


def run_niederer_ecg(
    dx: float = 0.1,
    dt: float = 0.05,
    T: float = 40.0,
    theta: float = 0.5,
    frame_ms: float = 1.0,
    device=None,
    use_kernels: bool = True,
    operator_cache_key: str | None = None,
) -> dict:
    """The Niederer slab run for ``T`` ms with a pseudo-ECG frame every
    ``frame_ms``: the solver's voltage copied into a ``fem.Function``,
    :meth:`~..ecg.ECGRecovery.solve_device`, the 10 electrode potentials,
    and at the end the 12 leads.  ``use_kernels`` applies to the solver and
    the recovery alike, ``operator_cache_key`` (the operator disk cache) to
    both assemblies.  Returns the traces, each frame's CG iterations and
    convergence, the ECG's host syncs and seconds per frame by part (the
    voltage's pull to the host, the solve with its upload, the
    potentials), the simulation's seconds, and the setup's parts."""
    from .niederer import _build_solver

    tic = _time.perf_counter()
    solver = _build_solver(dx=dx, theta=theta, device=device, use_kernels=use_kernels,
                           operator_cache_key=operator_cache_key)
    dev = solver.device
    solver_s = _time.perf_counter() - tic
    tic = _time.perf_counter()
    vfun = fem.Function(solver.V)
    ecg = ECGRecovery(v=vfun, M=solver.M, C_m=solver.C_m, device=dev, use_kernels=use_kernels,
                      operator_cache_key=operator_cache_key)
    recovery_s = _time.perf_counter() - tic
    tic = _time.perf_counter()
    ecg.register_electrodes(list(ELECTRODES_MM.values()))
    _sync(dev)
    weights_s = _time.perf_counter() - tic

    steps = max(1, int(round(frame_ms / dt)))
    n_frames = int(round(T / (steps * dt)))
    amps = solver.stimulus_amplitudes()
    phis, times, iters, converged = [], [], [], []
    sim_s = pull_s = solve_s = phi_s = upload_s = 0.0
    t = 0.0
    for _ in range(n_frames):
        tic = _time.perf_counter()
        solver.run_chunk(t, dt, steps, amps)
        _sync(dev)
        sim_s += _time.perf_counter() - tic
        t += steps * dt
        tic = _time.perf_counter()
        vfun.x.array[:] = solver.v.cpu().numpy()
        pull_s += _time.perf_counter() - tic
        tic = _time.perf_counter()
        im, info = ecg.solve_device()
        _sync(dev)
        solve_s += _time.perf_counter() - tic
        upload_s += ecg.last_upload_s
        tic = _time.perf_counter()
        phis.append(ecg.electrode_potentials(im))
        phi_s += _time.perf_counter() - tic
        times.append(t)
        iters.append(int(info.iterations))
        converged.append(bool(info.converged))
    phi = np.stack(phis)
    return {
        "backend": dev.type,
        "device_name": _device_name(dev),
        "dx": dx,
        "dt": dt,
        "T": T,
        "theta": theta,
        "n_nodes": solver.V.ndofs,
        "n_cells": solver.mesh.num_cells,
        "n_frames": n_frames,
        "frame_ms": steps * dt,
        "use_kernels": use_kernels,
        "kernel": ecg.kernel,
        "solver_setup_s": solver_s,
        "recovery_setup_s": recovery_s,
        "assembly_s": ecg.setup_s["assembly_s"],
        "electrode_weights_s": weights_s,
        "simulation_s": sim_s,
        "ecg_s_per_frame": (pull_s + solve_s + phi_s) / n_frames,
        "pull_s_per_frame": pull_s / n_frames,
        "solve_s_per_frame": solve_s / n_frames,
        "upload_s_per_frame": upload_s / n_frames,
        "potentials_s_per_frame": phi_s / n_frames,
        # the voltage pull, the solves' read-backs and the potentials' read
        "ecg_host_syncs_per_frame": 1 + ecg.host_syncs / n_frames,
        "cg_iters_per_frame": iters,
        "cg_converged_per_frame": converged,
        "times_ms": times,
        "potentials": phi.tolist(),
        "leads": {name: trace.tolist() for name, trace in twelve_leads(phi).items()},
    }


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--niederer":
        dx = float(args[1]) if len(args) > 1 else 0.1
        T = float(args[2]) if len(args) > 2 else 40.0
        out = run_niederer_ecg(dx=dx, T=T)
    else:
        device = None
        if args and args[0] == "--cpu":
            device, args = "cpu", args[1:]
        dx = float(args[0]) if args else 0.05
        frames = int(args[1]) if len(args) > 1 else 10
        out = run_ecg_scale(dx=dx, n_frames=frames, device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
