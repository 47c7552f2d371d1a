"""Endocardial stimulation of an idealized left-ventricle ellipsoid, through
the object-oriented API.

The port's copy of ``demos/lv_endocardial.py`` (lines 29-136): an LV
ellipsoid, transmural endo/mid/epi layers from a Laplace solve
(``expand_layer`` on Jacobi, as every LV path of the port labels its
layers; the JAX package takes SA-AMG at this size, which the port has
too, ``benchmarks/lv_layers.py`` compares the two), per-layer ToR-ORd dynCl
celltypes pre-paced to steady state on the card (``get_steady_state``, 2
beats at BCL 1000 ms), an ENDO surface stimulus of 1 ms, Niederer
conductivities along the fibres, then ``MonodomainModel`` +
``DolfinMultiODESolver`` (one ToR-ORd B1 launch per layer a step) +
``MonodomainSplittingSolver`` (the demo's Godunov splitting), printing
the voltage range every 2 ms, and the pseudo-ECG potential at the
electrode (2, 7, 0) through ``ECGRecovery``; every 2 ms the voltage and
the layers go to a ParaView frame through ``io.VTUWriter`` (``--outdir``,
``viz/series.pvd``), as the demo writes them.

Besides the demo's output, the run stamps activation times on the host
from the voltage each step writes there (the fused solver's rule: the
step's start where v first exceeds 0 mV), read at the probes of
:func:`~.lv.lv_probe_points`.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.lv_endocardial --psize 0.1
"""

from __future__ import annotations

import argparse
import json
import sys
import time as _time
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from .. import fem
from ..conductivities import default_conductivities, define_conductivity_tensor
from ..ecg import ECGRecovery
from ..geometry import get_lv_ellipsoid_geometry
from ..io import VTUWriter
from ..models import torord_dyncl
from ..monodomain_model import MonodomainModel
from ..monodomain_solver import MonodomainSplittingSolver
from ..odesolver import DolfinMultiODESolver
from ..stimulation import define_stimulus
from ..units import ureg
from .lv import CELLTYPES, lv_amplitude, lv_layers, lv_probe_points, lv_steady_states
from .niederer import ACTIVATION_THRESHOLD

__all__ = ["ELECTRODE", "build_oo_lv", "OOLVRun", "run_oo_lv", "electrode_potential", "main"]

ELECTRODE = (2.0, 7.0, 0.0)  # the demo's electrode, 4 cm from the epicardial wall
PRINT_EVERY_MS = 2.0
GODUNOV = 1.0  # the demo's splitting theta


def build_oo_lv(mesh, layers: np.ndarray, M, I_s, init_states: dict, device=None,
                use_kernels: bool = True, C_m: float = 1.0) -> MonodomainSplittingSolver:
    """The demo's solver on ``mesh``: ToR-ORd dynCl per layer (``layers``,
    per-node MID / ENDO / EPI markers; ``init_states`` marker -> states),
    each layer's celltype parameters with the model's pacing off, the
    stimulus ``I_s``, conductivity ``M`` and membrane capacitance ``C_m``
    (``MonodomainModel``'s default 1, as the demo takes it); Godunov
    splitting, as the demo runs it.  ``use_kernels=False`` runs the
    kernels' twins."""
    model = torord_dyncl
    V = fem.functionspace(mesh, ("P", 1))
    pde = MonodomainModel(time=fem.Constant(0.0), mesh=mesh, M=M, I_s=I_s, C_m=C_m, device=device,
                          use_kernels=use_kernels)
    markers = fem.Function(V, name="layers")
    markers.x.array[:] = layers
    ode = DolfinMultiODESolver(
        v_ode=fem.Function(V),
        v_pde=pde.state,
        markers=markers,
        num_states={m: len(model.init_state_values()) for m in CELLTYPES},
        fun={m: model.generalized_rush_larsen for m in CELLTYPES},
        init_states={m: init_states[m] for m in CELLTYPES},
        parameters={m: model.init_parameter_values(i_Stim_Amplitude=0.0, celltype=ct) for m, ct in CELLTYPES.items()},
        v_index={m: model.state_index("v") for m in CELLTYPES},
        device=pde.device,
        use_kernels=use_kernels,
    )
    return MonodomainSplittingSolver(pde=pde, ode=ode, theta=GODUNOV)


@dataclass
class OOLVRun:
    """A run of :func:`run_oo_lv`: the demo's printed voltage ranges, the
    probes' and every node's activation (host stamps), the timed loop's
    wall, CG iterations, exit tests read back and voltage crossings."""

    simulated_ms: float
    n_steps: int
    wall_s: float
    v_range: list  # (t, v_min, v_max) every PRINT_EVERY_MS
    probes: dict  # name -> activation time (ms), -1 if not activated
    activation: np.ndarray  # every node's activation time (ms), -1 if not activated
    activated_share: float
    cg_iters_sum: int
    host_syncs: int
    host_transfers: int
    all_finite: bool

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_s if self.wall_s > 0 else 0.0


def run_oo_lv(solver: MonodomainSplittingSolver, T: float, dt: float, probe_points: dict | None = None,
              verbose: bool = True, writer: VTUWriter | None = None, layers: np.ndarray | None = None) -> OOLVRun:
    """Step ``solver`` from 0 to ``T`` as the demo does (``solver.step``
    by ``dt``, the voltage range printed every 2 ms and, with a
    ``writer``, written with the ``layers`` as a VTU frame), stamping
    activation times from the host voltage after each step (above
    :data:`~.niederer.ACTIVATION_THRESHOLD`); the timed loop ends with a
    device synchronize."""
    pde = solver.pde
    V = pde.V
    act = np.full(V.ndofs, -1.0)
    pdofs = pw = None
    if probe_points:
        pdofs, pw = fem.point_evaluation_tables(V, np.array(list(probe_points.values())))
    every = max(1, int(round(PRINT_EVERY_MS / dt)))
    n_steps = int(round(T / dt))
    it0, sync0, tr0 = pde.cg_iterations, pde._pde.host_syncs, solver.host_transfers
    rows = []
    tic = _time.perf_counter()
    for step in range(1, n_steps + 1):
        t0 = (step - 1) * dt
        solver.step((t0, t0 + dt))
        v = pde.state.x.array
        act[(v > ACTIVATION_THRESHOLD) & (act < 0)] = t0
        if step % every == 0:
            rows.append((step * dt, float(v.min()), float(v.max())))
            if verbose:
                print(f"t={step * dt:6.1f}  v_range=[{v.min():8.2f}, {v.max():8.2f}]")
            if writer is not None:
                writer.write(step * dt, {"v": v, "layer": layers})
    if pde.device.type == "cuda":
        torch.cuda.synchronize(pde.device)
    wall = _time.perf_counter() - tic
    ode = solver.ode
    finite = all(bool(torch.isfinite(ode.values(m)).all()) for m in CELLTYPES)
    probes = {}
    if pdofs is not None:
        probes = {k: float(a) for k, a in zip(probe_points, (act[pdofs] * pw).sum(axis=1))}
    return OOLVRun(
        simulated_ms=n_steps * dt, n_steps=n_steps, wall_s=wall, v_range=rows, probes=probes, activation=act,
        activated_share=float((act >= 0).mean()), cg_iters_sum=pde.cg_iterations - it0,
        host_syncs=pde._pde.host_syncs - sync0, host_transfers=solver.host_transfers - tr0,
        all_finite=finite and bool(np.isfinite(pde.state.x.array).all()),
    )


def electrode_potential(pde: MonodomainModel, M, point=ELECTRODE) -> float:
    """The demo's pseudo-ECG: Im recovered from the model's state by
    ``ECGRecovery`` on the model's device, the potential at ``point``."""
    ecg = ECGRecovery(v=pde.state, sigma_b=1.0, M=M, device=pde.device)
    ecg.solve()
    return float(fem.assemble_scalar(ecg.eval(point)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-T", type=float, default=30.0, help="end time (ms)")
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--psize", type=float, default=0.3, help="element size (cm)")
    ap.add_argument("--amplitude", type=float, default=None,
                    help="stimulus amplitude uA/cm^2 (default: 2000 at psize <= 0.15, scaled up with psize)")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("-o", "--outdir", type=Path, default=Path("results-lv-endocardial"))
    args = ap.parse_args(argv)

    tic = _time.perf_counter()
    geo = get_lv_ellipsoid_geometry(psize_ref=args.psize, cache=False)
    mesh = geo.mesh
    print(f"LV ellipsoid: {mesh.num_vertices} nodes, {mesh.num_cells} tets")
    V = fem.functionspace(mesh, ("P", 1))
    layers = lv_layers(geo, V, precond="jacobi", device=args.device)
    steady = lv_steady_states(dt=args.dt, device=args.device)
    I_s = define_stimulus(
        mesh=mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0), subdomain_data=geo.ffun,
        marker=geo.markers["ENDO"][0], mesh_unit="cm", amplitude=args.amplitude or lv_amplitude(args.psize),
        duration=1.0,
    )
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    solver = build_oo_lv(mesh, layers, M, I_s, steady, device=args.device)
    setup_s = _time.perf_counter() - tic
    writer = VTUWriter(args.outdir / "viz", mesh)
    res = run_oo_lv(solver, args.T, args.dt, lv_probe_points(args.psize), writer=writer, layers=layers)
    print(f"ParaView series: {writer.close()}")
    phi = electrode_potential(solver.pde, M)
    print(f"Electrode potential: {phi:.6e}")
    out = {k: v for k, v in asdict(res).items() if k != "activation"}
    print(json.dumps({**out, "setup_s": setup_s, "ms_per_second": res.ms_per_second, "electrode_potential": phi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
