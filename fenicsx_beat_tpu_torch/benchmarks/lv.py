"""Endocardial activation of the idealized LV on the port's fused solver.

The configuration of ``demos/lv_endocardial.py`` (lines 55-116), run
through the fused solver in the place of the operator-splitting OO path:
an LV ellipsoid (:func:`~..geometry.get_lv_ellipsoid_geometry`),
endo/mid/epi layers from :func:`~..utils.expand_layer`
(``endo_size=0.3, epi_size=0.3``), one parameter set per layer (celltype
endo 0, mid 2, epi 1) with the model's own pacing off, an ENDO facet
stimulus of 1 ms, and Niederer conductivities along ``geo.f0``.  This path
runs the multi-marker ionic kernel (B7) and the CSR SpMV (B8).

Three ionic models (``model``):

- ``"torord_dyncl"``, the demo's own: each layer starts from its
  celltype's single-cell steady state, 2 beats at BCL 1000 ms
  (:func:`lv_steady_states`, the demo's ``get_steady_state`` call, paced
  on the card through B1), or from ``init_state_values()`` unpaced;
- ``"torord_dyncl_land"``, ToR-ORd dynCl coupled to Land's contraction
  model (52 states), pre-paced the same way on its own B1; the run reports
  Land's active tension at the probes' nodes (``active_tension``);
- ``"tp06"``, the default, which the earlier measurements used: TP06 from
  ``init_state_values()``, unpaced.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.lv --psize 0.1 -T 30
    python -m fenicsx_beat_tpu_torch.benchmarks.lv --psize 0.1 -T 30 --model torord_dyncl
    python -m fenicsx_beat_tpu_torch.benchmarks.lv --psize 0.1 -T 30 --model torord_dyncl_land
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
from ..fused import FusedMonodomainSolver
from ..geometry import get_lv_ellipsoid_geometry
from ..models import tentusscher_panfilov_2006 as tp06
from ..models import torord_dyncl as torord
from ..models import torord_dyncl_land as land
from ..single_cell import get_steady_state
from ..stimulation import define_stimulus
from ..units import ureg
from ..utils import expand_layer

__all__ = [
    "MID", "ENDO", "EPI", "CELLTYPES", "MODELS", "lv_probe_points", "lv_amplitude", "lv_layers",
    "lv_steady_states", "lv_ionic", "build_lv_solver", "LVResult", "probe_active_tension", "run_lv_solver",
    "run_lv",
]

MID, ENDO, EPI = 0, 1, 2  # layer markers, as the demo numbers them
CELLTYPES = {MID: 2.0, ENDO: 0.0, EPI: 1.0}  # celltype of each layer (every model)
MODELS = {"tp06": tp06, "torord_dyncl": torord, "torord_dyncl_land": land}
# the demo's pre-pacing of each layer's cell (demos/lv_endocardial.py:74-82)
PREPACE_BEATS, PREPACE_BCL = 2, 1000
# where the steady states are cached (git-ignored), keyed by their arguments
STEADY_DIR = Path(__file__).resolve().parents[2] / "build" / "steady_states"
LAYER_SIZE = 0.3  # endo_size and epi_size of expand_layer
CHUNK_MS = 10.0  # run_chunk length of the timed runs; probes read at each end


def lv_probe_points(psize: float) -> dict[str, tuple[float, float, float]]:
    """Probe points of the default LV (r_short 2.5/3.5, r_long 9.0/9.7 cm,
    base at x = 0) at element size ``psize``: the endocardial apex and four
    endocardial mesh nodes, where the stimulated layer fires, and one
    mid-wall point.  A node is named by its place ``(mu, theta)`` on the
    generator's grid as fractions of the longitudinal and circumferential
    node counts, and has the generator's own coordinates, so its probe
    reads that node's activation time."""
    wall, arc, circ = 1.0, 9.0 * np.pi / 2, 2 * np.pi * 2.5
    nmu = max(8, int(np.rint(arc / psize)))
    nth = max(12, int(np.rint(circ / psize)))
    mu_t = np.linspace(-np.pi, -np.pi / 2, nmu + 1)
    ths = np.linspace(0.0, 2 * np.pi, nth + 1)[:-1]

    def endo_node(f_mu, f_th):
        mu, th = mu_t[int(round(f_mu * nmu))], ths[int(round(f_th * nth)) % nth]
        return (9.0 * np.cos(mu), 2.5 * np.sin(mu) * np.cos(th), 2.5 * np.sin(mu) * np.sin(th))

    t, mu, th = 0.5, -2.0, np.pi  # mid-wall, interpolated from its cell
    rs, rl = 2.5 + t * wall, 9.0 + t * 0.7
    return {
        "apex_endo": (-9.0, 0.0, 0.0),
        "apical_endo": endo_node(0.25, 0.0),
        "mid_endo": endo_node(0.5, 0.25),
        "basal_endo": endo_node(0.75, 0.5),
        "base_endo": endo_node(0.95, 0.75),
        "mid_wall": (rl * np.cos(mu), rs * np.sin(mu) * np.cos(th), rs * np.sin(mu) * np.sin(th)),
    }


def lv_amplitude(psize: float) -> float:
    """The demo's stimulus amplitude (uA/cm^2): 2000 at psize <= 0.15,
    scaled up with psize on coarser meshes."""
    return 2000.0 * max(1.0, psize / 0.15)


def lv_layers(geo, V, precond: str = "auto", device=None) -> np.ndarray:
    """Transmural layer markers (MID / ENDO / EPI) of every node."""
    return expand_layer(
        V, geo.ffun, endo_marker=geo.markers["ENDO"][0], epi_marker=geo.markers["EPI"][0],
        endo_size=LAYER_SIZE, epi_size=LAYER_SIZE, output_mid_marker=MID,
        output_endo_marker=ENDO, output_epi_marker=EPI, precond=precond, device=device,
    )


def lv_steady_states(dt: float = 0.05, device=None, outdir: Path = STEADY_DIR,
                     model: str = "torord_dyncl") -> dict:
    """Each layer's cell of ``model`` (ToR-ORd dynCl, with or without Land)
    paced to its steady state, as the demo does it: marker -> states after
    :data:`PREPACE_BEATS` beats at BCL :data:`PREPACE_BCL` ms from
    ``init_state_values()``, with the model's own stimulus (cached under
    ``outdir``, one directory per layer, keyed by model and arguments)."""
    m = MODELS[model]
    return {
        marker: get_steady_state(
            fun=m.generalized_rush_larsen,
            init_states=m.init_state_values(),
            parameters=m.init_parameter_values(celltype=ct),
            outdir=Path(outdir) / f"layer-{marker}",
            BCL=PREPACE_BCL,
            nbeats=PREPACE_BEATS,
            dt=dt,
            device=device,
        )
        for marker, ct in CELLTYPES.items()
    }


def lv_ionic(model: str = "tp06", init_states: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """The per-layer ``(ode_fun, init_states, parameters, v_index)`` dicts
    of the LV: ``model``'s generalized Rush-Larsen step, ``init_states``
    (marker -> states; ``init_state_values()`` for every layer when None)
    and each celltype's parameters with the model's pacing stimulus off."""
    m = MODELS[model]
    off = {"stim_amplitude": 0.0} if m is tp06 else {"i_Stim_Amplitude": 0.0}
    v_name = m._STATE_NAMES[0]
    funs, init, params, v_idx = {}, {}, {}, {}
    for marker, ct in CELLTYPES.items():
        funs[marker] = m.generalized_rush_larsen
        init[marker] = m.init_state_values() if init_states is None else init_states[marker]
        params[marker] = m.init_parameter_values(celltype=ct, **off)
        v_idx[marker] = m.state_index(v_name)
    return funs, init, params, v_idx


def build_lv_solver(
    psize: float = 0.3,
    theta: float = 0.5,
    device=None,
    precond: str = "auto",
    probe_points: np.ndarray | None = None,
    layers: np.ndarray | None = None,
    model: str = "tp06",
    init_states: dict | None = None,
    **solver_kwargs,
) -> FusedMonodomainSolver:
    """The LV configuration's solver on ``device`` (the card when None).
    ``precond`` goes to the layer labelling's Laplace solve; ``layers``
    given skips it (two solvers compared on one labelling).  ``model`` and
    ``init_states`` as :func:`lv_ionic` takes them (the pre-paced ToR-ORd
    layers: ``init_states=lv_steady_states(dt, model=model)``)."""
    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    V = fem.functionspace(mesh, ("P", 1))
    if layers is None:
        layers = lv_layers(geo, V, precond=precond, device=device)
    funs, init, params, v_idx = lv_ionic(model, init_states)
    I_s = define_stimulus(
        mesh=mesh,
        chi=1400.0 * ureg("cm**-1"),
        time=fem.Constant(0.0),
        subdomain_data=geo.ffun,
        marker=geo.markers["ENDO"][0],
        mesh_unit="cm",
        amplitude=lv_amplitude(psize),
        duration=1.0,
    )
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    return FusedMonodomainSolver(
        mesh=mesh, M=M, ode_fun=funs, init_states=init, parameters=params, v_index=v_idx,
        I_s=I_s, theta=theta, ode_markers=layers, device=device, probe_points=probe_points,
        **solver_kwargs,
    )


@dataclass
class LVResult:
    psize: float
    dt: float
    theta: float
    setup_s: float  # host setup: geometry, layers, assembly, packing
    n_nodes: int
    n_cells: int
    layer_nodes: dict  # marker -> nodes
    simulated_ms: float
    wall_s: float
    n_steps: int
    activated_share: float  # nodes with an activation time at the end
    probes: dict  # name -> activation time (ms), -1 if not activated
    cg_iters_max: int
    cg_iters_sum: int
    host_syncs: int
    all_finite: bool
    device: str
    model: str = "tp06"
    prepace_s: float = 0.0  # single-cell pre-pacing of the layers, inside setup_s
    active_tension: dict | None = None  # Land: probe name -> Ta (kPa) at its nearest node, at the end

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cg_iters_mean(self) -> float:
        return self.cg_iters_sum / self.n_steps if self.n_steps else 0.0

    @property
    def host_syncs_per_step(self) -> float:
        return self.host_syncs / self.n_steps if self.n_steps else 0.0


def probe_active_tension(solver: FusedMonodomainSolver) -> list[float]:
    """Land's active tension Ta (kPa) at each probe point of a Land LV
    ``solver``: ``active_tension`` of the states of each probe's cell
    nodes with their layers' parameters, weighted as the probes' activation
    times are."""
    g = solver._ionic_groups[0]
    index, table = g.index, g.table
    dofs, w = solver._probe_dofs, solver._probe_w
    flat = dofs.reshape(-1)
    params = table.double()[index[flat].long()].T
    Ta, _, _ = land.active_tension(solver.states[:, flat].double(), params)
    return (Ta.reshape(dofs.shape) * w.double()).sum(dim=1).tolist()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_lv_solver(solver: FusedMonodomainSolver, psize: float, T: float = 30.0, dt: float = 0.05,
                  setup_s: float = 0.0, t0: float = 0.0, prepace_s: float = 0.0) -> LVResult:
    """Run ``T`` ms of the psize-``psize`` LV ``solver`` from its state at
    time ``t0`` in chunks of :data:`CHUNK_MS`, the
    probes read at each chunk's end; the timed window is the whole run and
    ends with one device synchronize."""
    dev = solver.device
    markers = solver._ionic_groups[0].index.cpu().numpy()
    chunk = max(1, int(round(CHUNK_MS / dt)))
    n_total = int(round(T / dt))
    amps = solver.stimulus_amplitudes()
    t, done, it_max, it_sum = t0, 0, 0, 0
    syncs0 = solver.host_syncs
    res = None
    _sync(dev)
    tic = _time.perf_counter()
    while done < n_total:
        n = min(chunk, n_total - done)
        res = solver.run_chunk(t, dt, n, amps, probed=solver._probe_dofs is not None)
        t = res.t
        done += n
        it_max, it_sum = max(it_max, res.iters_max), it_sum + res.iters_sum
    _sync(dev)
    wall = _time.perf_counter() - tic
    act = solver.activation_time
    names = list(lv_probe_points(psize)) if res.probes is not None else []
    tension = None
    if names and solver._ionic_groups[0].model.module is land:
        tension = dict(zip(names, probe_active_tension(solver)))
    return LVResult(
        psize=psize, dt=dt, theta=float(solver.theta),
        setup_s=setup_s, n_nodes=solver.V.ndofs, n_cells=solver.mesh.num_cells,
        layer_nodes={int(m): int((markers == i).sum()) for i, m in enumerate(sorted(CELLTYPES))},
        simulated_ms=done * dt, wall_s=wall, n_steps=done,
        activated_share=float((act >= 0).double().mean()),
        probes={name: float(a) for name, a in zip(names, res.probes.cpu().numpy())} if names else {},
        cg_iters_max=it_max, cg_iters_sum=it_sum, host_syncs=solver.host_syncs - syncs0,
        all_finite=bool(torch.isfinite(solver.states).all()),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        model=solver._ionic.name, prepace_s=prepace_s, active_tension=tension,
    )


def run_lv(
    psize: float = 0.3,
    dt: float = 0.05,
    T: float = 30.0,
    theta: float = 0.5,
    device=None,
    precond: str = "auto",
    model: str = "tp06",
    prepace: bool = True,
    **solver_kwargs,
) -> LVResult:
    """Build the LV solver with the probes of :func:`lv_probe_points` (its
    host setup timed, the ToR-ORd or Land layers' pre-pacing included unless
    ``prepace`` is False) and run it (:func:`run_lv_solver`)."""
    tic = _time.perf_counter()
    init, prepace_s = None, 0.0
    if model != "tp06" and prepace:
        init = lv_steady_states(dt=dt, device=device, model=model)
        prepace_s = _time.perf_counter() - tic
    solver = build_lv_solver(
        psize=psize, theta=theta, device=device, precond=precond,
        probe_points=np.array(list(lv_probe_points(psize).values())), model=model, init_states=init,
        **solver_kwargs,
    )
    _sync(solver.device)
    return run_lv_solver(solver, psize, T=T, dt=dt, setup_s=_time.perf_counter() - tic, prepace_s=prepace_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--psize", type=float, default=0.1)
    ap.add_argument("-T", type=float, default=30.0)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--precond", default="jacobi")
    ap.add_argument("--model", choices=sorted(MODELS), default="tp06")
    args = ap.parse_args(argv)
    res = run_lv(psize=args.psize, dt=args.dt, T=args.T, precond=args.precond, model=args.model)
    print(json.dumps({**asdict(res), "ms_per_second": res.ms_per_second}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
