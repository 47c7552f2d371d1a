"""The JAX package's side of the port's LV configuration.

:func:`jax_lv_solver` builds the JAX ``FusedMonodomainSolver`` of the
setup that ``fenicsx_beat_tpu_torch.benchmarks.lv.build_lv_solver`` builds
in the port (same geometry, layers, celltypes, stimulus, conductivities
and probes), for ``tests/test_torch_lv.py``.  Run as a script, it prints
the JAX package's probe activation times in float64 on the CPU, the
constants that ``chip_smoke.py`` holds the port to on the card::

    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenicsx_beat_tpu_torch.benchmarks import lv as tlv  # noqa: E402


def jax_lv_solver(psize: float, theta: float = 0.5, probe_points=None, **solver_kwargs):
    import fenicsx_beat_tpu as beat
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu.units import ureg

    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    V = fem.functionspace(mesh, ("P", 1))
    layers = beat.utils.expand_layer(
        V=V, ft=geo.ffun, endo_marker=geo.markers["ENDO"][0], epi_marker=geo.markers["EPI"][0],
        endo_size=tlv.LAYER_SIZE, epi_size=tlv.LAYER_SIZE, output_mid_marker=tlv.MID,
        output_endo_marker=tlv.ENDO, output_epi_marker=tlv.EPI,
    )
    funs, init, params, v_idx = {}, {}, {}, {}
    for marker, ct in tlv.CELLTYPES.items():
        funs[marker] = tp06.generalized_rush_larsen
        init[marker] = tp06.init_state_values()
        params[marker] = tp06.init_parameter_values(stim_amplitude=0.0, celltype=ct)
        v_idx[marker] = tp06.state_index("V")
    I_s = beat.stimulation.define_stimulus(
        mesh=mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0), subdomain_data=geo.ffun,
        marker=geo.markers["ENDO"][0], mesh_unit="cm", amplitude=tlv.lv_amplitude(psize),
        duration=1.0,
    )
    conds = beat.conductivities.default_conductivities("Niederer")
    M = beat.conductivities.define_conductivity_tensor(f0=geo.f0, **conds)
    solver = FusedMonodomainSolver(
        mesh=mesh, M=M, ode_fun=funs, init_states=init, parameters=params, v_index=v_idx,
        I_s=I_s, theta=theta, ode_markers=layers, probe_points=probe_points, **solver_kwargs,
    )
    return solver, layers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--psize", type=float, default=0.3)
    ap.add_argument("-T", type=float, default=30.0)
    ap.add_argument("--dt", type=float, default=0.05)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    probes = tlv.lv_probe_points(args.psize)
    solver, layers = jax_lv_solver(
        args.psize, probe_points=np.array(list(probes.values())), use_pallas_ode=False,
    )
    solver.solve((0.0, args.T), dt=args.dt)
    act = np.asarray(solver.activation_times())
    pdofs, pw = solver._probe_tables
    values = (act[pdofs] * pw).sum(axis=1)
    print(json.dumps({
        "psize": args.psize, "T": args.T, "dt": args.dt, "n_nodes": int(act.size),
        "layer_nodes": {int(m): int((np.asarray(layers.x.array) == m).sum()) for m in tlv.CELLTYPES},
        "activated_share": float((act >= 0).mean()),
        "probes": {name: round(float(v), 10) for name, v in zip(probes, values)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
