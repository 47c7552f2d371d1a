"""The JAX package's side of the port's LV and slab configurations.

:func:`jax_lv_solver` builds the JAX ``FusedMonodomainSolver`` of the
setup that ``fenicsx_beat_tpu_torch.benchmarks.lv.build_lv_solver`` builds
in the port (same geometry, layers, celltypes, stimulus, conductivities
and probes; TP06, ToR-ORd or ToR-ORd + Land layers), for
``tests/test_torch_lv.py``, ``tests/test_torch_torord_tissue.py`` and
``tests/test_torch_land.py``; :func:`jax_slab_solver` that of
``fenicsx_beat_tpu_torch.benchmarks.slab.build_slab_solver`` (the slab
demo).  Run as a script, it prints the JAX package's values in float64 on
the CPU, the constants that ``chip_smoke.py`` holds the port to on the
card::

    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30
    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30 --model torord_dyncl
    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30 --model torord_dyncl_land
    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --steady-states
    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --steady-states --model torord_dyncl_land
    JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --slab 0.05 -T 20

the LV probe activation times (layers from ``init_state_values()``,
unpaced), each ToR-ORd (or, with ``--model torord_dyncl_land``, ToR-ORd +
Land) celltype's single-cell steady state after the LV demo's 2 beats at
BCL 1000 ms (dt 0.05), and the slab demo's probe times and conduction
velocity.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenicsx_beat_tpu_torch.benchmarks import lv as tlv  # noqa: E402
from fenicsx_beat_tpu_torch.benchmarks import slab as tslab  # noqa: E402


def jax_model(model: str):
    """The JAX package's module of the port's ``benchmarks.lv.MODELS`` name."""
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006, torord_dyncl, torord_dyncl_land

    return {"tp06": tentusscher_panfilov_2006, "torord_dyncl": torord_dyncl,
            "torord_dyncl_land": torord_dyncl_land}[model]


def jax_lv_solver(psize: float, theta: float = 0.5, probe_points=None, model: str = "tp06",
                  **solver_kwargs):
    import fenicsx_beat_tpu as beat
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.units import ureg

    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    V = fem.functionspace(mesh, ("P", 1))
    layers = beat.utils.expand_layer(
        V=V, ft=geo.ffun, endo_marker=geo.markers["ENDO"][0], epi_marker=geo.markers["EPI"][0],
        endo_size=tlv.LAYER_SIZE, epi_size=tlv.LAYER_SIZE, output_mid_marker=tlv.MID,
        output_endo_marker=tlv.ENDO, output_epi_marker=tlv.EPI,
    )
    m = jax_model(model)
    off = {"stim_amplitude": 0.0} if model == "tp06" else {"i_Stim_Amplitude": 0.0}
    funs, init, params, v_idx = {}, {}, {}, {}
    for marker, ct in tlv.CELLTYPES.items():
        funs[marker] = m.generalized_rush_larsen
        init[marker] = m.init_state_values()
        params[marker] = m.init_parameter_values(celltype=ct, **off)
        v_idx[marker] = m.state_index(m._STATE_NAMES[0])
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


def jax_slab_solver(dx: float, **solver_kwargs):
    """The slab demo's solver (``demos/slab.py:38-84``) with the port's
    probes (``benchmarks.slab.slab_probe_points``)."""
    import fenicsx_beat_tpu as beat
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu import mesh as meshmod
    from fenicsx_beat_tpu.fused import FusedMonodomainSolver
    from fenicsx_beat_tpu.models import torord_dyncl
    from fenicsx_beat_tpu.units import ureg

    L = tslab.SLAB_L
    mesh = meshmod.create_box(None, ((0.0, 0.0, 0.0), (L, dx, dx)), (int(L / (dx / 5)), 5, 5))
    facets = meshmod.locate_entities_boundary(mesh, mesh.tdim - 1, lambda x: x[0] <= 1e-8)
    ffun = meshmod.meshtags(mesh, mesh.tdim - 1, facets, 1)
    I_s = beat.stimulation.define_stimulus(
        mesh=mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0), subdomain_data=ffun, marker=1,
        mesh_unit="cm", amplitude=5000.0, duration=2.0,
    )
    conds = beat.conductivities.default_conductivities("Niederer")
    M = beat.conductivities.get_harmonic_mean_conductivity(
        chi=conds["chi"], g_il=conds["g_il"], g_it=conds["g_it"], g_el=conds["g_el"], g_et=conds["g_et"],
    )
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/cm**2").magnitude
    return FusedMonodomainSolver(
        mesh=mesh, M=float(M[0]), ode_fun=torord_dyncl.generalized_rush_larsen,
        init_states=torord_dyncl.init_state_values(),
        parameters=torord_dyncl.init_parameter_values(i_Stim_Start=1e18),
        v_index=torord_dyncl.state_index("v"), I_s=I_s, C_m=C_m, activation_threshold=0.0,
        probe_points=tslab.slab_probe_points(dx), **solver_kwargs,
    )


def probe_values(solver) -> np.ndarray:
    """Activation times of a JAX solver at its probe points."""
    pdofs, pw = solver._probe_tables
    return (np.asarray(solver.activation_times())[pdofs] * pw).sum(axis=1)


def jax_steady_states(dt: float = 0.05, outdir=None, model: str = "torord_dyncl") -> dict:
    """The JAX package's ``get_steady_state`` for each celltype of the LV
    (ToR-ORd, or ToR-ORd + Land), as the port's
    ``benchmarks.lv.lv_steady_states`` runs it."""
    import tempfile

    from fenicsx_beat_tpu.single_cell import get_steady_state

    m = jax_model(model)
    with tempfile.TemporaryDirectory() as tmp:
        return {
            marker: get_steady_state(
                fun=m.generalized_rush_larsen, init_states=m.init_state_values(),
                parameters=m.init_parameter_values(celltype=ct),
                outdir=Path(outdir or tmp) / f"layer-{marker}", BCL=tlv.PREPACE_BCL,
                nbeats=tlv.PREPACE_BEATS, dt=dt,
            )
            for marker, ct in tlv.CELLTYPES.items()
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--psize", type=float, default=0.3)
    ap.add_argument("-T", type=float, default=30.0)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--model", choices=sorted(tlv.MODELS), default="tp06")
    ap.add_argument("--steady-states", action="store_true",
                    help="each celltype's steady state (ToR-ORd unless --model names Land)")
    ap.add_argument("--slab", type=float, default=None, metavar="DX", help="the slab demo at bar thickness DX")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if args.steady_states:
        model = "torord_dyncl_land" if args.model == "torord_dyncl_land" else "torord_dyncl"
        states = jax_steady_states(dt=args.dt, model=model)
        print(json.dumps({
            "model": model, "dt": args.dt, "nbeats": tlv.PREPACE_BEATS, "BCL": tlv.PREPACE_BCL,
            "celltype_states": {f"{tlv.CELLTYPES[m]:g}": [float(x) for x in y] for m, y in states.items()},
        }))
        return 0
    if args.slab is not None:
        solver = jax_slab_solver(args.slab, use_pallas_ode=False)
        solver.solve((0.0, args.T), dt=args.dt, save_freq=int(1.0 / args.dt))
        t1, t2 = (float(x) for x in probe_values(solver))
        print(json.dumps({
            "dx": args.slab, "T": args.T, "dt": args.dt, "n_nodes": int(solver.V.ndofs),
            "t1": round(t1, 10), "t2": round(t2, 10),
            "cv_cm_per_ms": 0.4 / (t2 - t1) if t1 > 0 and t2 > t1 else None,
        }))
        return 0
    probes = tlv.lv_probe_points(args.psize)
    solver, layers = jax_lv_solver(
        args.psize, probe_points=np.array(list(probes.values())), model=args.model, use_pallas_ode=False,
    )
    solver.solve((0.0, args.T), dt=args.dt)
    act = np.asarray(solver.activation_times())
    print(json.dumps({
        "model": args.model, "psize": args.psize, "T": args.T, "dt": args.dt, "n_nodes": int(act.size),
        "layer_nodes": {int(m): int((np.asarray(layers.x.array) == m).sum()) for m in tlv.CELLTYPES},
        "activated_share": float((act >= 0).mean()),
        "probes": {name: round(float(v), 10) for name, v in zip(probes, probe_values(solver))},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
