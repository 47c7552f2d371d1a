"""The JAX package's side of the port's Niederer runs beyond P1.

:func:`jax_niederer_oo` builds, with the JAX package, the object-oriented
configuration that ``fenicsx_beat_tpu_torch.benchmarks.niederer.build_niederer_oo``
builds in the port: the Niederer slab at ``dx`` (S1 corner cube, Niederer
conductivities), ``MonodomainModel`` with the PDE on Lagrange elements of
``degree``, TP06 GRL through ``DolfinODESolver`` on the PDE's space or on
``ode_space``, and ``MonodomainSplittingSolver``; for
``tests/test_torch_spaces_solver.py``.  Run as a script, it prints the JAX
package's P1-P9 in float64 on the CPU for the two configurations that
``chip_smoke.py`` holds the card to at dx=0.5, 40 ms, Strang, dt 0.05:
Path P2 (the PDE and the ODE on P2, 30,537 dofs) and Path Q (the PDE on
P1, 4,305 nodes; the ODE on Quadrature_2, 161,280 points)::

    JAX_PLATFORMS=cpu python tests/torch_spaces_reference.py --dx 0.5 -T 40

Activation times are the port's rule (``run_niederer_oo``): at every PDE
dof, the start time of the first step after which v exceeds 0 mV, read at
the probes through the PDE space's point-evaluation tables; -1 where a
probe's cell has a dof that never fired.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONFIGS = {"p2": {"degree": 2, "ode_space": None}, "q": {"degree": 1, "ode_space": "Quadrature_2"}}


def jax_niederer_oo(dx: float, degree: int = 1, ode_space: str | None = None, theta: float = 0.5):
    """The JAX package's OO Niederer solver, as the port's
    ``build_niederer_oo`` builds it."""
    import fenicsx_beat_tpu as beat
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.benchmarks.niederer import LX, LY, LZ
    from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
    from fenicsx_beat_tpu.mesh import locate_entities, meshtags
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.units import ureg

    geo = get_3D_slab_geometry(None, dx=dx, Lx=LX, Ly=LY, Lz=LZ)
    mesh = geo.mesh
    conds = beat.conductivities.default_conductivities("Niederer")
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    L, tol = 1.5, 1e-10
    cells = locate_entities(mesh, mesh.tdim, lambda x: (x[0] <= L + tol) & (x[1] <= L + tol) & (x[2] <= L + tol))
    I_s = beat.stimulation.define_stimulus(
        mesh=mesh, chi=conds["chi"], time=fem.Constant(0.0), subdomain_data=meshtags(mesh, mesh.tdim, cells, 1),
        marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    M = beat.conductivities.define_conductivity_tensor(f0=geo.f0, **conds)
    pde = beat.MonodomainModel(time=fem.Constant(0.0), mesh=mesh, M=M, I_s=I_s, C_m=C_m, params={"degree": degree})
    V_ode = pde.V if ode_space is None else beat.utils.space_from_string(ode_space, mesh)
    init = tp06.init_state_values()
    ode = beat.odesolver.DolfinODESolver(
        v_ode=fem.Function(V_ode), v_pde=pde.state, init_states=init,
        parameters=tp06.init_parameter_values(stim_amplitude=0.0), fun=tp06.generalized_rush_larsen,
        num_states=len(init), v_index=tp06.state_index("V"),
    )
    return beat.MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta)


def jax_probes(dx: float, T: float, dt: float, degree: int, ode_space: str | None) -> dict:
    """P1-P9 of :func:`jax_niederer_oo` run from 0 to ``T``."""
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.benchmarks.niederer import benchmark_points

    solver = jax_niederer_oo(dx, degree, ode_space)
    V = solver.pde.V
    pdofs, pw = fem.point_evaluation_tables(V, np.array(list(benchmark_points().values())))
    act = np.full(V.ndofs, -1.0)
    for k in range(int(round(T / dt))):
        solver.step((k * dt, (k + 1) * dt))
        v = np.asarray(solver.pde.state.x.array)
        act[(v > 0.0) & (act < 0)] = k * dt
    fired = (act[pdofs] >= 0).all(axis=1)
    vals = np.where(fired, (act[pdofs] * pw).sum(axis=1), -1.0)
    return {"ndofs": int(V.ndofs), "ode_points": int(solver.ode.num_points),
            "P": [round(float(a), 6) for a in vals]}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dx", type=float, default=0.5)
    ap.add_argument("-T", type=float, default=40.0)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args()
    for name, cfg in CONFIGS.items():
        tic = time.perf_counter()
        res = jax_probes(args.dx, args.T, args.dt, **cfg)
        print(json.dumps({"config": name, "dx": args.dx, "T": args.T, "dt": args.dt, **res,
                          "seconds": round(time.perf_counter() - tic, 1)}), flush=True)


if __name__ == "__main__":
    main()
