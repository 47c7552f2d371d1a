"""How far the pre-paced ToR-ORd LV's activated share depends on where
its PCG starts and how tightly it converges.

The OO path (``benchmarks/lv_endocardial.py``) starts each step's PCG
from the previous voltage, as the JAX package's ``BaseModel`` does; the
fused solver starts it from ``v + dv`` (the last step's increment added).
At float32's clamped tolerance (rtol 1e-6) the two land on different
activated shares of the psize-0.1 LV at 30 ms.  This script runs the fused
solver, Godunov, from the demo's pre-paced layers (:func:`~.lv.lv_steady_states`)
and one labelling, on the card in float32 at each of :data:`RTOLS` from
both starts (the v_prev start by overriding ``_pde_solve`` on the
instance), then once in float64 on the CPU at rtol :data:`F64_RTOL` as
the converged reference.  Each run prints its activated share, probes, CG
iterations a step, and against the reference the nodes activated in one
run only and the largest gap in activation time over the nodes both
activated.

Usage, on a machine with a CUDA card (the float64 run takes about 20
minutes on 8 CPU threads at psize 0.1)::

    python -m fenicsx_beat_tpu_torch.benchmarks.lv_cg_start --psize 0.1 --threads 8 --out chiprun_out/lv_cg_start.json
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time as _time

import numpy as np
import torch

from .. import fem
from ..convert import states_from_numpy
from ..geometry import get_lv_ellipsoid_geometry
from .lv import build_lv_solver, lv_layers, lv_probe_points, lv_steady_states, run_lv_solver

__all__ = ["RTOLS", "F64_RTOL", "run_both_starts", "main"]

RTOLS = (1e-6, 1e-7, 1e-8)  # the float32 clamp (base_model._solver_tolerances) and two decades under it
F64_RTOL = 1e-10


def _reset(solver) -> None:
    solver.states = states_from_numpy(np.asarray(solver.init_states), solver.device, solver.dtype)
    solver.activation_time.fill_(-1.0)


def run_both_starts(solver, psize: float, T: float, dt: float, rtol: float) -> dict:
    """``solver`` (a Godunov LV) from its initial states at ``rtol``, once
    from each PCG start: start name -> (result, every node's activation)."""
    out = {}
    solver._pde.rtol = float(rtol)
    warm = solver._pde_solve
    for start in ("v + dv", "v_prev"):
        _reset(solver)
        if start == "v_prev":
            solver._pde_solve = lambda ops, v, x0, t, dt_, amps: warm(ops, v, v, t, dt_, amps)
        try:
            res = run_lv_solver(solver, psize, T=T, dt=dt)
        finally:
            vars(solver).pop("_pde_solve", None)
        out[start] = (res, solver.activation_time.double().cpu().numpy())
    return out


def _against(act: np.ndarray, ref: np.ndarray) -> dict:
    both = (act >= 0) & (ref >= 0)
    return {
        "nodes_in_one_run_only": int(((act >= 0) != (ref >= 0)).sum()),
        "max_gap_ms": float(np.abs(act - ref)[both].max()) if both.any() else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--psize", type=float, default=0.1)
    ap.add_argument("-T", type=float, default=30.0)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--threads", type=int, default=0, help="CPU threads of the float64 run (0: torch's default)")
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lv_cg_start: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    geo = get_lv_ellipsoid_geometry(psize_ref=args.psize, cache=False)
    layers = lv_layers(geo, fem.functionspace(geo.mesh, ("P", 1)), precond="jacobi", device="cuda")
    steady = lv_steady_states(dt=args.dt, device="cuda")
    probes = list(lv_probe_points(args.psize).values())
    common = dict(psize=args.psize, theta=1.0, precond="jacobi", model="torord_dyncl", init_states=steady,
                  layers=layers, probe_points=probes)
    rows = []
    card = build_lv_solver(device="cuda", **common)
    for rtol in RTOLS:
        for start, (res, act) in run_both_starts(card, args.psize, args.T, args.dt, rtol).items():
            rows.append({"dtype": "float32", "device": smi, "rtol": rtol, "start": start, "act": act,
                         "share": res.activated_share, "probes": res.probes, "cg_iters_mean": res.cg_iters_mean,
                         "cg_iters_max": res.cg_iters_max, "ms_per_s": res.ms_per_second})
            print(f"float32 on the card, rtol {rtol:g}, CG from {start}: share {res.activated_share:.6f}, "
                  f"cg_iters mean {res.cg_iters_mean:.3f} max {res.cg_iters_max}, probes "
                  + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items()), flush=True)
    del card
    torch.cuda.empty_cache()

    if args.threads:
        torch.set_num_threads(args.threads)
    tic = _time.perf_counter()
    host = build_lv_solver(device="cpu", dtype=torch.float64,
                           params={"ksp_rtol": F64_RTOL, "ksp_atol": 1e-14}, **common)
    res = run_lv_solver(host, args.psize, T=args.T, dt=args.dt)
    ref = host.activation_time.numpy().copy()
    print(f"float64 on the CPU ({torch.get_num_threads()} threads, {_time.perf_counter() - tic:.1f} s), rtol "
          f"{F64_RTOL:g}, CG from v + dv: share {res.activated_share:.6f}, cg_iters mean "
          f"{res.cg_iters_mean:.3f}, probes " + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items()))
    for r in rows:
        r.update(_against(r.pop("act"), ref))
        print(f"against the float64 reference: float32 rtol {r['rtol']:g} from {r['start']}: share "
              f"{r['share']:.6f} ({100 * (r['share'] - res.activated_share):+.3f} points), nodes activated in "
              f"one run only {r['nodes_in_one_run_only']}, max activation gap {r['max_gap_ms']:.3f} ms")
    rows.append({"dtype": "float64", "device": "cpu", "rtol": F64_RTOL, "start": "v + dv",
                 "share": res.activated_share, "probes": res.probes, "cg_iters_mean": res.cg_iters_mean,
                 "cg_iters_max": res.cg_iters_max, "ms_per_s": res.ms_per_second})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"reference_share": res.activated_share, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
