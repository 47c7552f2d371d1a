"""The JAX package's side of the port's two-model Niederer slab.

:func:`jax_mixed_solver` builds the JAX ``FusedMonodomainSolver`` of the
setup that ``fenicsx_beat_tpu_torch.benchmarks.mixed.build_mixed_solver``
builds in the port: the Niederer slab at ``dx`` (the S1 corner stimulus,
Niederer conductivities, probes P1-P9), Strang, with TP06 on the nodes
with x < 10 mm and ToR-ORd dynCl + Land (endo) on the rest, a dict
``ode_fun`` with ``ode_markers`` (the JAX package's ``make_multi_ode``
composition).  Run as a script, it prints the JAX package's P1-P9
activation times in float64 on the CPU (plain path), the constants that
``chip_smoke.py`` holds the port's dx=0.5 run to on the card (each within
one dt)::

    JAX_PLATFORMS=cpu python tests/torch_mixed_reference.py --dx 0.5 -T 40
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenicsx_beat_tpu_torch.benchmarks import mixed as tmixed  # noqa: E402
from fenicsx_beat_tpu_torch.benchmarks.niederer import benchmark_points  # noqa: E402


def jax_mixed_solver(dx: float, **solver_kwargs):
    """The JAX solver of the two-model slab (``solver_kwargs`` as JAX's
    ``FusedMonodomainSolver`` takes them, ``use_pallas_ode`` among them)."""
    from fenicsx_beat_tpu.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.models import torord_dyncl_land as land

    base = _build_solver(dx=dx, theta=tmixed.THETA, operator_cache_key=None,
                         probe_points=np.array(list(benchmark_points().values())), **solver_kwargs)
    markers = tmixed.mixed_markers(np.asarray(base.V.tabulate_dof_coordinates()))
    T, L = tmixed.TP06_MARKER, tmixed.LAND_MARKER
    return dataclasses.replace(
        base,
        ode_fun={T: tp06.generalized_rush_larsen, L: land.generalized_rush_larsen},
        init_states={T: tp06.init_state_values(), L: land.init_state_values()},
        parameters={T: tp06.init_parameter_values(stim_amplitude=0.0),
                    L: land.init_parameter_values(i_Stim_Amplitude=0.0)},
        v_index={T: tp06.state_index("V"), L: land.state_index("v")},
        ode_markers=markers,
    )


def probe_times(solver) -> dict:
    """Activation times (ms) of a JAX solver at P1-P9, -1 where not fired."""
    pdofs, pw = solver._probe_tables
    act = (np.asarray(solver.activation_times())[pdofs] * pw).sum(axis=1)
    return {name: round(float(a), 10) for name, a in zip(benchmark_points(), act)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dx", type=float, default=0.5)
    ap.add_argument("-T", type=float, default=40.0)
    args = ap.parse_args(argv)
    dt = tmixed.DT

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    solver = jax_mixed_solver(args.dx, use_pallas_ode=False)
    solver.solve((0.0, args.T), dt=dt, save_freq=int(round(10.0 / dt)))
    act = np.asarray(solver.activation_times())
    print(json.dumps({
        "dx": args.dx, "T": args.T, "dt": dt, "n_nodes": int(act.size),
        "activated_share": float((act >= 0).mean()), "probes": probe_times(solver),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
