"""A two-model Niederer slab: TP06 beside ToR-ORd dynCl + Land, on B7's
mixed-model form.

The Niederer configuration of :mod:`.niederer` (the 20x7x3 mm slab, the S1
corner stimulus, Niederer conductivities, probes P1-P9), Strang, dt=0.05,
with two markers split at x = 10 mm:

- marker 1, nodes with x < 10 mm: TP06 (19 states, ``init_state_values()``,
  its pacing off);
- marker 2, nodes with x >= 10 mm: ToR-ORd dynCl + Land (52 states, endo
  parameters, its pacing off, ``init_state_values()``).

The union states are ``[52, n]`` (TP06 in its first 19 rows).  x is the
slowest node index of the slab's mesh, so every 256-node block of B7's grid
holds one model except the block at the interface: each model's launch
covers its own blocks and that one (:func:`~..ops.cuda_ode.mixed_groups`),
about 1x the ionic work of the two halves, not 2x.  The stimulus corner
lies in the TP06 half; the wave crosses into the Land half.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.mixed --dx 0.1 -T 40
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
from ..fused import FusedMonodomainSolver
from ..models import tentusscher_panfilov_2006 as tp06
from ..models import torord_dyncl_land as land
from ..ops.cuda_ode import BLOCK_NODES
from .niederer import benchmark_points, niederer_setup

__all__ = ["DT", "THETA", "X_SPLIT", "mixed_markers", "mixed_ionic", "build_mixed_solver", "MixedResult", "run_mixed_slab"]

DT, THETA = 0.05, 0.5  # the path's time step (ms) and Strang splitting
X_SPLIT = 10.0  # mm: TP06 below, ToR-ORd dynCl + Land from here on
TP06_MARKER, LAND_MARKER = 1, 2
CHUNK_MS = 10.0  # run_chunk length; probes read at each chunk's end


def mixed_markers(dof_coords: np.ndarray) -> np.ndarray:
    """Each node's marker from its coordinates ``[n, 3]`` (mm)."""
    return np.where(dof_coords[:, 0] < X_SPLIT - 1e-9, TP06_MARKER, LAND_MARKER).astype(np.int64)


def mixed_ionic() -> tuple[dict, dict, dict, dict]:
    """The ``(ode_fun, init_states, parameters, v_index)`` dicts of the two
    markers (each model's generalized Rush-Larsen step, its initial
    states, its default (endo) parameters with its pacing off, V in row 0)."""
    funs = {TP06_MARKER: tp06.generalized_rush_larsen, LAND_MARKER: land.generalized_rush_larsen}
    init = {TP06_MARKER: tp06.init_state_values(), LAND_MARKER: land.init_state_values()}
    params = {TP06_MARKER: tp06.init_parameter_values(stim_amplitude=0.0),
              LAND_MARKER: land.init_parameter_values(i_Stim_Amplitude=0.0)}
    v_idx = {TP06_MARKER: tp06.state_index("V"), LAND_MARKER: land.state_index("v")}
    return funs, init, params, v_idx


def build_mixed_solver(dx: float = 0.1, device=None, dtype=None,
                       probe_points: np.ndarray | None = None, **solver_kwargs) -> FusedMonodomainSolver:
    """The two-model slab's fused solver on ``device`` (the card when None)."""
    mesh, M, I_s, C_m = niederer_setup(dx)
    markers = mixed_markers(fem.functionspace(mesh, ("P", 1)).dof_coords)
    funs, init, params, v_idx = mixed_ionic()
    return FusedMonodomainSolver(
        mesh=mesh, M=M, ode_fun=funs, init_states=init, parameters=params, v_index=v_idx, I_s=I_s,
        theta=THETA, C_m=C_m, device=device, dtype=dtype, probe_points=probe_points, ode_markers=markers,
        **solver_kwargs,
    )


@dataclass
class MixedResult:
    dx: float
    model: str  # every model, "+"-joined
    setup_s: float  # host setup: mesh, assembly, markers, the mixed groups
    n_nodes: int
    marker_nodes: dict  # marker -> nodes
    n_blocks: int  # 256-node blocks of B7's grid
    blocks_per_model: dict  # model -> blocks its launch covers
    two_model_share: float  # share of the blocks that two models' launches cover
    simulated_ms: float
    wall_s: float
    n_steps: int
    activation_times: dict  # P1..P9 (ms), -1 where not activated
    cg_iters_max: int
    cg_iters_sum: int
    host_syncs: int
    launches: dict  # model -> B7 kernel launches in the timed run (0 on the twins)
    all_finite: bool
    device: str

    @property
    def ms_per_second(self) -> float:
        return self.simulated_ms / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def cg_iters_mean(self) -> float:
        return self.cg_iters_sum / self.n_steps if self.n_steps else 0.0

    @property
    def host_syncs_per_step(self) -> float:
        return self.host_syncs / self.n_steps if self.n_steps else 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mixed_slab(dx: float = 0.1, T: float = 40.0, device=None, dtype=None,
                   solver: FusedMonodomainSolver | None = None, **solver_kwargs) -> MixedResult:
    """Build the two-model slab (host setup timed) unless ``solver`` is
    given, and run it from its state at t = 0 for ``T`` ms in chunks of
    :data:`CHUNK_MS`; the timed window is the whole run and ends with one
    device synchronize."""
    tic = _time.perf_counter()
    if solver is None:
        solver = build_mixed_solver(dx=dx, device=device, dtype=dtype,
                                    probe_points=np.array(list(benchmark_points().values())), **solver_kwargs)
    dev = solver.device
    _sync(dev)
    setup_s = _time.perf_counter() - tic
    groups = solver._ionic_groups
    n = solver.V.ndofs
    n_blocks = -(-n // BLOCK_NODES)
    cover = np.zeros(n_blocks, dtype=np.int64)
    for g in groups:
        cover[g.blocks.cpu().numpy()] += 1
    before = {g.model.name: g.model.multi_step.launches for g in groups}
    chunk = max(1, int(round(CHUNK_MS / DT)))
    n_total = int(round(T / DT))
    amps = solver.stimulus_amplitudes()
    t, done, it_max, it_sum, res = 0.0, 0, 0, 0, None
    syncs0 = solver.host_syncs
    tic = _time.perf_counter()
    while done < n_total:
        k = min(chunk, n_total - done)
        res = solver.run_chunk(t, DT, k, amps, probed=True)
        t, done = res.t, done + k
        it_max, it_sum = max(it_max, res.iters_max), it_sum + res.iters_sum
    _sync(dev)
    wall = _time.perf_counter() - tic
    markers = mixed_markers(solver.V.dof_coords)
    return MixedResult(
        dx=dx, model=solver._ionic.name, setup_s=setup_s, n_nodes=n,
        marker_nodes={m: int((markers == m).sum()) for m in (TP06_MARKER, LAND_MARKER)},
        n_blocks=n_blocks, blocks_per_model={g.model.name: int(g.blocks.numel()) for g in groups},
        two_model_share=float((cover >= 2).mean()),
        simulated_ms=done * DT, wall_s=wall, n_steps=done,
        activation_times={name: float(a) for name, a in zip(benchmark_points(), res.probes.cpu().numpy())},
        cg_iters_max=it_max, cg_iters_sum=it_sum, host_syncs=solver.host_syncs - syncs0,
        launches={g.model.name: g.model.multi_step.launches - before[g.model.name] for g in groups},
        all_finite=bool(torch.isfinite(solver.states).all()),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dx", type=float, default=0.1)
    ap.add_argument("-T", type=float, default=40.0)
    args = ap.parse_args(argv)
    res = run_mixed_slab(dx=args.dx, T=args.T)
    print(json.dumps({**asdict(res), "dt": DT, "ms_per_second": res.ms_per_second, "cg_iters_mean": res.cg_iters_mean,
                      "host_syncs_per_step": res.host_syncs_per_step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
