"""Conduction velocity on a thin ToR-ORd bar: the slab demo on the port.

The configuration of ``demos/slab.py:38-95`` on the port's fused solver: a
1 cm bar of thickness ``dx`` (``create_box`` with ``(int(L / (dx / 5)), 5,
5)`` cells: 3,636 nodes at the demo's dx = 0.05 cm), a 2 ms facet stimulus
of 5000 uA/cm^2 on the x = 0 face, the harmonic-mean Niederer
conductivity, ToR-ORd dynCl from ``init_state_values()`` with its own
pacing moved out of reach (``i_Stim_Start=1e18``), activation threshold
0 mV, 20 ms at dt = 0.05 in 1 ms chunks (the demo's ``save_freq``).  The
activation times at the demo's two probes (x = 0.3 and x = 0.7 on the
bar's axis) give the conduction velocity ``0.4 / (t2 - t1)``.  The bar is
a structured mesh, so the path runs ToR-ORd's B1 and the stencil PCG (B2,
B3, B4).

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.slab --dx 0.05 -T 20
"""

from __future__ import annotations

import argparse
import json
import sys
import time as _time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import fem
from .. import mesh as meshmod
from ..conductivities import default_conductivities, get_harmonic_mean_conductivity
from ..fused import FusedMonodomainSolver
from ..models import torord_dyncl as torord
from ..stimulation import define_stimulus
from ..units import ureg

__all__ = ["SLAB_L", "slab_probe_points", "build_slab_solver", "SlabResult", "run_slab"]

SLAB_L = 1.0  # bar length (cm)
PROBE_X = (0.3, 0.7)  # the demo's conduction-velocity probes (cm)


def slab_probe_points(dx: float) -> np.ndarray:
    """The demo's two probes on the axis of the bar of thickness ``dx``."""
    return np.array([[x, dx / 2, dx / 2] for x in PROBE_X])


def build_slab_solver(dx: float = 0.05, device=None, **solver_kwargs) -> FusedMonodomainSolver:
    """The slab demo's solver on ``device`` (the card when None), with its
    probes."""
    mesh = meshmod.create_box(None, ((0.0, 0.0, 0.0), (SLAB_L, dx, dx)), (int(SLAB_L / (dx / 5)), 5, 5))
    marker = 1
    facets = meshmod.locate_entities_boundary(mesh, mesh.tdim - 1, lambda x: x[0] <= 1e-8)
    ffun = meshmod.meshtags(mesh, mesh.tdim - 1, facets, marker)
    I_s = define_stimulus(
        mesh=mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0), subdomain_data=ffun,
        marker=marker, mesh_unit="cm", amplitude=5000.0, duration=2.0,
    )
    conds = default_conductivities("Niederer")
    M = get_harmonic_mean_conductivity(
        chi=conds["chi"], g_il=conds["g_il"], g_it=conds["g_it"], g_el=conds["g_el"], g_et=conds["g_et"],
    )
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/cm**2").magnitude
    return FusedMonodomainSolver(
        mesh=mesh, M=float(M[0]), ode_fun=torord.generalized_rush_larsen,
        init_states=torord.init_state_values(),
        parameters=torord.init_parameter_values(i_Stim_Start=1e18),
        v_index=torord.state_index("v"), I_s=I_s, C_m=C_m, activation_threshold=0.0,
        probe_points=slab_probe_points(dx), device=device, **solver_kwargs,
    )


@dataclass
class SlabResult:
    dx: float
    dt: float
    n_nodes: int
    setup_s: float
    simulated_ms: float
    wall_s: float
    n_steps: int
    t1: float  # activation time (ms) at x = 0.3, -1 if not activated
    t2: float  # at x = 0.7
    cv_cm_per_ms: float | None  # 0.4 / (t2 - t1), None until both fired in order
    activated_share: float
    cg_iters_max: int
    cg_iters_sum: int
    host_syncs: int
    all_finite: bool
    device: str

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_s if self.wall_s > 0 else 0.0


def run_slab(dx: float = 0.05, dt: float = 0.05, T: float = 20.0, device=None, **solver_kwargs) -> SlabResult:
    """Build the slab demo's solver (its host setup timed) and run ``T`` ms
    in 1 ms chunks; the timed window ends with one device synchronize."""
    tic = _time.perf_counter()
    solver = build_slab_solver(dx=dx, device=device, **solver_kwargs)
    setup = _time.perf_counter() - tic
    dev = solver.device
    chunk = max(1, int(round(1.0 / dt)))
    n_total = int(round(T / dt))
    amps = solver.stimulus_amplitudes()
    t, done, it_max, it_sum, res = 0.0, 0, 0, 0, None
    syncs0 = solver.host_syncs
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tic = _time.perf_counter()
    while done < n_total:
        n = min(chunk, n_total - done)
        res = solver.run_chunk(t, dt, n, amps, probed=True)
        t, done = res.t, done + n
        it_max, it_sum = max(it_max, res.iters_max), it_sum + res.iters_sum
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = _time.perf_counter() - tic
    t1, t2 = (float(x) for x in res.probes.cpu().numpy())
    return SlabResult(
        dx=dx, dt=dt, n_nodes=solver.V.ndofs, setup_s=setup, simulated_ms=done * dt, wall_s=wall,
        n_steps=done, t1=t1, t2=t2,
        cv_cm_per_ms=(PROBE_X[1] - PROBE_X[0]) / (t2 - t1) if t1 > 0 and t2 > t1 else None,
        activated_share=float((solver.activation_time >= 0).double().mean()),
        cg_iters_max=it_max, cg_iters_sum=it_sum, host_syncs=solver.host_syncs - syncs0,
        all_finite=bool(torch.isfinite(solver.states).all()),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("-T", type=float, default=20.0)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args(argv)
    res = run_slab(dx=args.dx, dt=args.dt, T=args.T)
    print(json.dumps({**asdict(res), "ms_per_second": res.ms_per_second}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
