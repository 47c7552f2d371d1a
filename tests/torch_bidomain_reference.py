"""The JAX package's side of the port's bidomain configurations.

:func:`jax_slab_solver`, :func:`jax_lv_solver` and :func:`jax_demo_solver`
build the JAX ``BidomainSolver`` of the setups that
``fenicsx_beat_tpu_torch.benchmarks.bidomain_scale`` builds in the port
(``slab_solver``, ``lv_solver``, ``demo_solver``: the same mesh,
conductivities, stimulus and ionic model), for
``tests/test_torch_bidomain.py``.  Run as a script, it prints the JAX
package's values in float64 on the CPU, the constants ``chip_smoke.py``
holds the card to, beside the port's own runs on the CPU in float64 and in
float32 (its twins)::

    JAX_PLATFORMS=cpu python tests/torch_bidomain_reference.py --slab 0.2
    JAX_PLATFORMS=cpu python tests/torch_bidomain_reference.py --lv 0.3
    JAX_PLATFORMS=cpu python tests/torch_bidomain_reference.py --demo

- the dx=0.2 slab (58,176 nodes; TP06, Godunov, monolithic, the DCT):
  ``v_max``, ``max|u_e|``, the share of nodes with v > 0 and the CG
  iterations at 15 ms (a 5 ms warm-up and a 10 ms window, chunks of 100
  steps, as ``bidomain_scale.run_slab`` runs it);
- the psize 0.3 LV (9,780 nodes; Jacobi): the same values at 10 ms;
- the demo (``demos/bidomain_ue.py``, nx=48, 40 ms at dt 0.1): its
  per-save ``(t, v_max, max|u_e|)`` rows.

The card's tolerances come from several float32 witnesses of each
configuration (:data:`WITNESS_SEEDS`): the port's float32 run on the CPU
from its initial states, and again from initial states that
``bidomain_scale.perturb_states`` moves by one ulp at random entries (a
seed each).
A float32 run's distance from the float64 values is rounding fed through
the CG's stopping test (rtol 1e-6), so one run is one sample of it; each
field's tolerance is three times the largest distance of that field over
the witnesses (:func:`tolerances`).

The CG iterations per chunk are the worst step's (the JAX monitor's
record); the port also counts them per step.  The float64 runs solve to
rtol 1e-8 and the float32 runs to 1e-6 (the float32 floor), so their
iteration counts differ by construction: the card is held to the float32
witnesses' range of counts per step (within 1), not to the float64 one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as tbs  # noqa: E402

DT = 0.05
CHUNK = tbs.CHUNK_STEPS
# the float32 witnesses: the unperturbed run (None), then one run per seed
# from initial states moved by one ulp at random entries
WITNESS_SEEDS = (None, 1, 2, 3)
FIELDS = ("v_max", "u_e_max_abs", "v_pos_share")


class IterMonitor:
    """Each chunk's worst-step CG iterations (a monitor of either solver)."""

    def __init__(self):
        self.iters: list[int] = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def jax_slab_solver(dx: float, **kw):
    from fenicsx_beat_tpu.benchmarks import bidomain_scale as jbs
    from fenicsx_beat_tpu.bidomain import BidomainSolver

    geo, mesh, I_s, C_m = jbs._slab_problem(dx)
    M_i, M_e = jbs._bidomain_tensors(geo.f0)
    return BidomainSolver(mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s, C_m=C_m, **{**jbs._tp06_kwargs(), **kw})


def jax_lv_solver(psize: float, **kw):
    """``bidomain_scale._lv_problem`` of the JAX package, its geometry not
    cached on disk; Jacobi unless ``u_precond`` says otherwise."""
    from fenicsx_beat_tpu import fem
    from fenicsx_beat_tpu.benchmarks import bidomain_scale as jbs
    from fenicsx_beat_tpu.bidomain import BidomainSolver
    from fenicsx_beat_tpu.conductivities import default_conductivities
    from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu.mesh import locate_entities, meshtags
    from fenicsx_beat_tpu.stimulation import define_stimulus
    from fenicsx_beat_tpu.units import ureg

    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    apex_x = mesh.coords[:, 0].min()
    cells = locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0)
    I_s = define_stimulus(
        mesh=mesh, chi=default_conductivities("Niederer")["chi"], time=fem.Constant(0.0),
        subdomain_data=meshtags(mesh, 3, cells, 1), marker=1, mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    M_i, M_e = jbs._bidomain_tensors(geo.f0)
    kw.setdefault("u_precond", "jacobi")
    C_m = (1.0 * ureg("uF/cm**2")).to("uF/mm**2").magnitude
    return BidomainSolver(mesh=mesh, M_i=M_i, M_e=M_e, I_s=I_s, C_m=C_m, **{**jbs._tp06_kwargs(), **kw})


def jax_demo_solver(nx: int = 48, **kw):
    """``demos/bidomain_ue.py``'s solver (lines 47-70 there)."""
    from fenicsx_beat_tpu import mesh as meshmod
    from fenicsx_beat_tpu import stimulation
    from fenicsx_beat_tpu.bidomain import BidomainSolver
    from fenicsx_beat_tpu.models import fitzhughnagumo as fhn

    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.25) & (x[1] < 0.25))
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=120.0, start=0.0, duration=2.0),
        dZ=stimulation.dx(mesh, subdomain_data=meshmod.meshtags(mesh, 2, cells, 1)),
        marker=1,
    )
    return BidomainSolver(
        mesh=mesh, M_i=np.diag([0.004, 0.0004]), M_e=np.diag([0.002, 0.0035]), ode_fun=fhn.forward_euler,
        init_states=fhn.init_state_values(), parameters=fhn.init_parameter_values(stim_amplitude=0.0),
        v_index=fhn.state_index("v"), I_s=I_s, theta=0.5, **kw,
    )


def stats(v, u) -> dict:
    v, u = np.asarray(v, dtype=np.float64), np.asarray(u, dtype=np.float64)
    return {"v_max": float(v.max()), "u_e_max_abs": float(np.abs(u).max()), "v_pos_share": float((v > 0).mean()),
            "n_nodes": int(v.size)}


def run_windows(solver, windows, dt: float = DT) -> dict:
    """Solve ``solver`` over consecutive ``(T0, T1)`` windows in chunks of
    :data:`CHUNK` steps; the field values at the end and every chunk's
    worst-step CG iterations (the run's seconds on stderr)."""
    mon = IterMonitor()
    solver.monitor = mon
    tic = time.perf_counter()
    for w in windows:
        solver.solve(w, dt=dt, save_freq=CHUNK)
    print(f"{type(solver).__module__}: {time.perf_counter() - tic:.1f} s", file=sys.stderr, flush=True)
    return {**stats(solver.v, solver.u_e), "chunk_iters": mon.iters}


def _port_runs(build, windows, dt=DT) -> dict:
    """The port's float64 run and its float32 witnesses, on the CPU."""
    import torch

    def run(dtype, seed=None):
        solver = build(device="cpu", dtype=dtype)
        if seed is not None:
            tbs.perturb_states(solver, seed)
        res = run_windows(solver, windows, dt)
        res["cg_iters_per_step"] = solver.cg_iterations / solver.steps
        return res

    return {"port_f64": run(torch.float64),
            "port_f32": [{"seed": seed, **run(torch.float32, seed)} for seed in WITNESS_SEEDS]}


def tolerances(ref: dict, witnesses: list) -> dict:
    """The card's tolerances: for each field, three times its largest
    distance from ``ref`` over the float32 ``witnesses``; for the share of
    nodes with v > 0 at least three nodes' worth (1/n each)."""
    gap = {k: max(abs(w[k] - ref[k]) for w in witnesses) for k in FIELDS}
    tol = {k: 3 * g for k, g in gap.items()}
    tol["v_pos_share"] = max(tol["v_pos_share"], 3 / ref["n_nodes"])
    return {"f32_gap": gap, "tol": tol}


def _summary(out: dict) -> None:
    """The constants ``chip_smoke.py`` keeps of a slab or LV reference."""
    j, ws = out["jax_f64"], out["port_f32"]
    iters = [w["cg_iters_per_step"] for w in ws]
    out["chip_smoke"] = {**{k: j[k] for k in FIELDS}, "n_nodes": j["n_nodes"], "chunk_iters": j["chunk_iters"],
                         "cg_iters_f64": out["port_f64"]["cg_iters_per_step"],
                         "cg_iters_f32": (min(iters), max(iters)), **tolerances(j, ws)}


def slab_reference(dx: float) -> dict:
    windows = [(0.0, 5.0), (5.0, 15.0)]
    out = {"jax_f64": run_windows(jax_slab_solver(dx), windows)}
    out.update(_port_runs(lambda **kw: tbs.slab_solver(dx, **kw), windows))
    _summary(out)
    return out


def lv_reference(psize: float, T: float = 10.0) -> dict:
    windows = [(0.0, T)]
    out = {"jax_f64": run_windows(jax_lv_solver(psize), windows)}
    out.update(_port_runs(lambda **kw: tbs.lv_solver(psize, **kw), windows))
    _summary(out)
    return out


def demo_rows(solver, T: float = 40.0, dt: float = 0.1) -> list:
    rows = []
    solver.solve((0.0, T), dt=dt, save_freq=max(1, int(2.0 / dt)),
                 save_callback=lambda t, v, u: rows.append((t, float(np.max(v)), float(np.abs(u).max()))))
    return rows


def demo_reference(nx: int = 48, T: float = 40.0) -> dict:
    """The JAX rows and the float32 witnesses' rows; for ``v_max`` and
    ``max|u_e|`` each, the largest relative distance of a witness row from
    its JAX row (over every save and witness), the card's tolerance being
    three times that."""
    import torch

    ref = demo_rows(jax_demo_solver(nx), T)
    witnesses = []
    for seed in WITNESS_SEEDS:
        solver = tbs.demo_solver(nx, device="cpu", dtype=torch.float32)
        if seed is not None:
            tbs.perturb_states(solver, seed)
        witnesses.append({"seed": seed, "rows": demo_rows(solver, T)})
    stray = {k: max(abs(b[i] - a[i]) / abs(a[i]) for w in witnesses for a, b in zip(ref, w["rows"]))
             for i, k in ((1, "v_max"), (2, "u_e_max_abs"))}
    return {"jax_f64": ref, "port_f32": witnesses, "f32_rel_stray": stray}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slab", type=float, default=None, help="the bidomain slab at this dx, 15 ms")
    ap.add_argument("--lv", type=float, default=None, help="the bidomain LV at this psize, 10 ms")
    ap.add_argument("--demo", action="store_true", help="demos/bidomain_ue.py at nx=48, 40 ms")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    tic = time.perf_counter()
    if args.slab is not None:
        print(json.dumps({"slab_dx": args.slab, **slab_reference(args.slab)}))
    if args.lv is not None:
        print(json.dumps({"lv_psize": args.lv, **lv_reference(args.lv)}))
    if args.demo:
        print(json.dumps({"demo_nx": 48, **demo_reference()}))
    print(f"{time.perf_counter() - tic:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
