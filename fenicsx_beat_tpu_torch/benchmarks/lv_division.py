"""CG iterations of the psize 0.1 LV with ToR-ORd dynCl and with ToR-ORd
dynCl + Land layers (``chip_smoke.py``'s ToR-ORd LV and Path L: 30 ms at
dt = 0.05, pre-paced layers, Jacobi labelling) under builds of the ToR-ORd
kernels that divide differently, beside what a rounding of the start alone
does:

- ``library``: the kernel library as built (``_build._APPROX_DIV_SOURCES``:
  every ToR-ORd and Land source with ``-prec-div=false``);
- ``ieee``: every ToR-ORd and Land source with the IEEE division, whose
  output is the parent's bit for bit (``b1_designs.py``'s ``ieee-div``);
- ``b7-ieee``: B1 and its per-node form (the pre-pacing) divide
  approximately, B7 (``*_multi.cu``, the LV's ionic step) with the IEEE
  division;
- ``library-ulp``: the library, each pre-paced layer's states one float32
  ulp up (``np.nextafter``) before the run.

Each variant runs in a process of its own, with its own kernel library
(keyed by its flags) and pre-paced states (one temporary directory a
division: ``library``, ``b7-ieee`` and ``library-ulp`` pace on the same
B1).  Prints for each model and variant the CG iterations in the run and a
step, the probes' activation times and the activated share; the card's
name and power limit; a JSON object last.  Needs one card::

    python -m fenicsx_beat_tpu_torch.benchmarks.lv_division
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import _build

MODELS = ("torord_dyncl", "torord_dyncl_land")
VARIANTS = ("library", "ieee", "b7-ieee", "library-ulp")
PSIZE, T_MS, DT = 0.1, 30.0, 0.05
_TORORD = ("torord_grl", "torord_land_grl")


def variant_flags(variant: str):
    """``_build._nvcc_flags`` as ``variant`` builds the sources."""
    library = _build._nvcc_flags

    def flags(src: Path) -> list[str]:
        out = library(src)
        ieee = variant == "ieee" or (variant == "b7-ieee" and src.stem.endswith("_multi"))
        if ieee and src.stem.startswith(_TORORD):
            out = [f for f in out if f != "-prec-div=false"]
        return out

    return flags


def run_variant(model: str, variant: str, steady: Path) -> dict:
    """One LV run of ``model`` on ``variant``'s build (in this process)."""
    from . import lv

    _build._nvcc_flags = variant_flags(variant)  # this process builds the variant's library
    dev = torch.device("cuda")
    init = lv.lv_steady_states(dt=DT, device=dev, outdir=steady / ("ieee" if variant == "ieee" else "library"),
                               model=model)
    if variant == "library-ulp":
        init = {k: np.nextafter(np.asarray(s, np.float32), np.float32(np.inf)) for k, s in init.items()}
    solver = lv.build_lv_solver(psize=PSIZE, device=dev, precond="jacobi",
                                probe_points=np.array(list(lv.lv_probe_points(PSIZE).values())), model=model,
                                init_states=init)
    res = lv.run_lv_solver(solver, PSIZE, T=T_MS, dt=DT)
    return {"model": model, "variant": variant, "cg_iters_sum": res.cg_iters_sum, "n_steps": res.n_steps,
            "cg_iters_mean": res.cg_iters_mean, "probes": res.probes, "activated_share": res.activated_share,
            "active_tension": res.active_tension, "all_finite": res.all_finite}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", nargs=3, metavar=("MODEL", "VARIANT", "STEADY_DIR"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lv_division needs a CUDA card", file=sys.stderr)
        return 1
    if args.child:
        model, variant, steady = args.child
        print(json.dumps(run_variant(model, variant, Path(steady))))
        return 0
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    work = _build._BUILD_DIR.parent / "lv_division"
    work.mkdir(parents=True, exist_ok=True)
    rows, failed = [], []
    with tempfile.TemporaryDirectory(dir=work) as steady:
        for model in MODELS:
            for variant in VARIANTS:
                proc = subprocess.run([sys.executable, "-m", __spec__.name, "--child", model, variant, steady],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    failed.append(f"{model} {variant}")
                    print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                    continue
                r = json.loads(proc.stdout.strip().splitlines()[-1])
                rows.append(r)
                print(f"[lv_division] {model} {variant}: CG {r['cg_iters_sum']} in {r['n_steps']} steps, "
                      f"{r['cg_iters_mean']:.3f} a step; probes {r['probes']}; activated share "
                      f"{r['activated_share']:.4f}; active tension {r['active_tension']}; finite {r['all_finite']}")
    print(gpu)
    print(json.dumps({"lv_division": rows, "gpu": gpu}))
    if failed:
        print(f"[lv_division] failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
