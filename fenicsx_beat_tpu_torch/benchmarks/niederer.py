"""Niederer 2011 benchmark (20x7x3 mm TP06 slab) on the port's fused solver.

The ionic model is TP06 GRL unless the caller names another ``model`` and
``scheme`` (a gotran model loaded at run time by ``odefile.load_ode``, as
``benchmarks/custom_ode.py`` does), as in the JAX function.

Port of ``fenicsx_beat_tpu/benchmarks/niederer.py``: S1 stimulus in a
1.5 mm corner cube, Niederer conductivities (g_il=0.17, g_it=0.019,
g_el=0.62, g_et=0.24 S/m, chi=1400/cm, C_m=1 uF/cm^2, amplitude
50,000 uA/cm^3 — reference ``demos/niederer_benchmark.py:126-162``),
activation times at the 8 slab corners P1-P8 and the center P9, and the
published activation-time table (reference
``demos/niederer_benchmark.py:301-311``).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from .. import fem
from ..conductivities import default_conductivities, define_conductivity_tensor
from ..fused import FusedMonodomainSolver
from ..geometry import get_3D_slab_geometry
from ..mesh import locate_entities, meshtags
from ..models import tentusscher_panfilov_2006 as tp06
from ..stimulation import define_stimulus
from ..units import ureg

__all__ = [
    "PUBLISHED_ACTIVATION_TIMES",
    "POINT_NAMES",
    "benchmark_points",
    "NiedererResult",
    "run_niederer_benchmark",
]

# Published reference activation times (ms) at (dx, dt) -> P1..P9, from the
# table committed in the reference repo (demos/niederer_benchmark.py:301-311).
PUBLISHED_ACTIVATION_TIMES = {
    (0.5, 0.05): [1.25, 51.1, 34.9, 58.9, 14.1, 49.5, 34.0, 56.65, 26.05],
    (0.5, 0.01): [1.22, 50.85, 33.96, 58.05, 13.98, 49.36, 33.07, 55.91, 25.64],
    (0.5, 0.005): [1.215, 50.775, 33.825, 57.96, 13.97, 49.345, 32.945, 55.825, 25.595],
    (0.2, 0.05): [1.25, 29.7, 32.9, 40.2, 9.55, 30.0, 32.95, 39.9, 18.9],
    (0.2, 0.01): [1.24, 29.09, 31.25, 38.66, 9.34, 29.4, 31.29, 38.42, 18.14],
    (0.2, 0.005): [1.235, 29.015, 31.05, 38.475, 9.315, 29.32, 31.08, 38.235, 18.045],
    (0.1, 0.05): [1.25, 26.85, 33.3, 40.35, 8.4, 27.5, 33.85, 40.55, 18.95],
    (0.1, 0.01): [1.23, 25.64, 31.46, 38.08, 8.03, 26.24, 31.94, 38.21, 17.95],
    (0.1, 0.005): [1.225, 25.5, 31.26, 37.81, 7.99, 26.09, 31.72, 37.93, 17.835],
}

LX, LY, LZ = 20.0, 7.0, 3.0  # mm
POINT_NAMES = ["P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9"]


def benchmark_points() -> dict[str, tuple[float, float, float]]:
    return {
        "P1": (0.0, 0.0, 0.0),
        "P2": (0.0, LY, 0.0),
        "P3": (LX, 0.0, 0.0),
        "P4": (LX, LY, 0.0),
        "P5": (0.0, 0.0, LZ),
        "P6": (0.0, LY, LZ),
        "P7": (LX, 0.0, LZ),
        "P8": (LX, LY, LZ),
        "P9": (LX / 2, LY / 2, LZ / 2),
    }


@dataclass
class NiedererResult:
    dx: float
    dt: float
    activation_times: dict[str, float]
    wall_time_s: float
    simulated_ms: float
    n_nodes: int
    n_steps: int
    theta: float = 1.0
    cg_iters_max: int = 0
    cg_iters_sum: int = 0
    host_syncs: int = 0
    device: str = "cpu"

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_time_s if self.wall_time_s > 0 else 0.0

    @property
    def cg_iters_mean(self) -> float:
        return self.cg_iters_sum / self.n_steps if self.n_steps else 0.0

    @property
    def host_syncs_per_step(self) -> float:
        return self.host_syncs / self.n_steps if self.n_steps else 0.0

    def error_vs_published(self) -> float | None:
        """Max relative error vs the committed table.  Godunov (theta=1)
        compares against the same-(dx, dt) row; Strang (theta=0.5) is second
        order, so it is judged against the finest published dt row at this
        dx (the converged reference)."""
        key = (self.dx, self.dt)
        if self.theta == 0.5:
            fine = [d for (dxk, d) in PUBLISHED_ACTIVATION_TIMES if dxk == self.dx]
            if fine:
                key = (self.dx, min(fine))
        if key not in PUBLISHED_ACTIVATION_TIMES:
            return None
        errs = []
        for name, r in zip(POINT_NAMES, PUBLISHED_ACTIVATION_TIMES[key]):
            mine = self.activation_times.get(name, -1.0)
            if mine < 0:
                return float("inf")
            errs.append(abs(mine - r) / r)
        return max(errs)

    def summary(self) -> str:
        at = ", ".join(f"{k}={v:.2f}" for k, v in self.activation_times.items())
        err = self.error_vs_published()
        ref_name = "published" if self.theta != 0.5 else "converged(dt->0 row)"
        err_s = f", max_rel_err_vs_{ref_name}={err:.3%}" if err is not None else ""
        return (
            f"Niederer dx={self.dx} dt={self.dt} theta={self.theta}: {at}\n"
            f"wall={self.wall_time_s:.3f}s for {self.simulated_ms:.0f}ms sim "
            f"({self.ms_per_second:.1f} ms/s on {self.device}, {self.n_nodes} nodes){err_s}"
        )


def _build_solver(
    dx: float = 0.5,
    theta: float = 1.0,
    device=None,
    dtype=None,
    probe_points: np.ndarray | None = None,
    scheme: str = "generalized_rush_larsen",
    model=None,
    **solver_kwargs,
) -> FusedMonodomainSolver:
    """Niederer-configuration solver (slab, S1 corner cube) on ``device``:
    the card when None (:func:`~..config.resolve_device`).  The ionic model
    is TP06 unless ``model`` names another (a hand-written port model or
    one that ``odefile.load_ode`` generated), stepped by its ``scheme``,
    from its initial states, with its own pacing stimulus set to zero
    under either name (``stim_amplitude``, ``i_Stim_Amplitude``), V in its
    row of ``V`` or ``v``: JAX's ``_build_solver``."""
    mesh_unit = "mm"
    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh

    conductivities = default_conductivities("Niederer")
    chi = conductivities["chi"]
    C_m = (1.0 * ureg("uF/cm**2")).to(f"uF/{mesh_unit}**2").magnitude

    # S1: 1.5 mm corner cube
    L = 1.5
    tol = 1e-10
    cells = locate_entities(
        mesh,
        mesh.tdim,
        lambda x: np.logical_and(np.logical_and(x[0] <= L + tol, x[1] <= L + tol), x[2] <= L + tol),
    )
    S1_marker = 1
    S1_tags = meshtags(mesh, mesh.tdim, cells, S1_marker)
    I_s = define_stimulus(
        mesh=mesh,
        chi=chi,
        time=fem.Constant(0.0),
        subdomain_data=S1_tags,
        marker=S1_marker,
        mesh_unit=mesh_unit,
        amplitude=50_000.0,
        duration=2.0,
    )
    M = define_conductivity_tensor(f0=geo.f0, **conductivities)
    model = model or tp06
    # zero the model's own pacing stimulus (its name differs per model family)
    for key in ("stim_amplitude", "i_Stim_Amplitude"):
        try:
            parameters = model.init_parameter_values(**{key: 0.0})
            break
        except KeyError:
            continue
    else:
        parameters = model.init_parameter_values()
    return FusedMonodomainSolver(
        mesh=mesh,
        M=M,
        ode_fun=getattr(model, scheme),
        init_states=model.init_state_values(),
        parameters=parameters,
        v_index=model.state_index("V" if "V" in model._STATE_NAMES else "v"),
        I_s=I_s,
        theta=theta,
        C_m=C_m,
        device=device,
        dtype=dtype,
        probe_points=probe_points,
        **solver_kwargs,
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_niederer_benchmark(
    dx: float = 0.5,
    dt: float = 0.05,
    T: float = 100.0,
    theta: float = 1.0,
    scheme: str = "generalized_rush_larsen",
    model=None,
    device=None,
    dtype=None,
    check_interval_ms: float = 20.0,
    **solver_kwargs,
) -> NiedererResult:
    """Run the benchmark on the port's fused solver, on the card unless
    ``device`` names the CPU; ``model`` and ``scheme`` as
    :func:`_build_solver` takes them.

    Chunks of ``check_interval_ms`` run back to back with the probe readout
    fused into each chunk; the timed horizon is the full ``T`` and ends with
    one device synchronize, and it extends chunk by chunk until all nine
    probes have activated.  One warm-up chunk (module load, allocator) runs
    first from the initial state and its results are discarded."""
    points = benchmark_points()
    solver = _build_solver(
        dx=dx,
        theta=theta,
        scheme=scheme,
        model=model,
        device=device,
        dtype=dtype,
        probe_points=np.array(list(points.values())),
        **solver_kwargs,
    )
    dev = solver.device
    chunk_steps = max(1, int(round(check_interval_ms / dt)))
    amps = solver.stimulus_amplitudes()

    init_states = solver.states.clone()
    init_act = solver.activation_time.clone()
    solver.run_chunk(0.0, dt, chunk_steps, amps, probed=True)
    _sync(dev)
    solver.states, solver.activation_time = init_states, init_act
    solver.host_syncs = 0

    it_max = it_sum = 0
    t = 0.0
    n_steps = 0
    probe_dev = None
    tic = _time.perf_counter()
    while t < T - 1e-9:
        res = solver.run_chunk(t, dt, chunk_steps, amps, probed=True)
        probe_dev = res.probes
        it_max, it_sum = max(it_max, res.iters_max), it_sum + res.iters_sum
        t += chunk_steps * dt
        n_steps += chunk_steps
    _sync(dev)
    probe_act = probe_dev.cpu().numpy()
    wall = _time.perf_counter() - tic
    # horizon extension until every probe has activated (the reference's
    # early-stopping loop, demos/niederer_benchmark.py:256)
    while not (probe_act >= 0).all() and t < 10 * T:
        tic2 = _time.perf_counter()
        res = solver.run_chunk(t, dt, chunk_steps, amps, probed=True)
        it_max, it_sum = max(it_max, res.iters_max), it_sum + res.iters_sum
        t += chunk_steps * dt
        n_steps += chunk_steps
        _sync(dev)
        probe_act = res.probes.cpu().numpy()
        wall += _time.perf_counter() - tic2

    return NiedererResult(
        dx=dx,
        dt=dt,
        activation_times={name: float(a) for name, a in zip(points, probe_act)},
        wall_time_s=wall,
        simulated_ms=t,
        n_nodes=solver.V.ndofs,
        n_steps=n_steps,
        theta=theta,
        cg_iters_max=it_max,
        cg_iters_sum=it_sum,
        host_syncs=solver.host_syncs,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
