"""The LV's transmural layers on Jacobi against SA-AMG.

Every LV path of the port labels its layers with ``precond="jacobi"``, a
keyword the JAX package's ``expand_layer`` lacks (its ``laplace_solve``
takes SA-AMG from 5,000 dofs on).  This script measures what dropping it
would change at ``--psize``: the endo/epi Laplace solve on each
preconditioner on the device (CG iterations, AMG setup and solve seconds),
the labels each gives, and how many nodes differ.  One JSON line.

Usage, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.lv_layers --psize 0.1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import fem
from ..geometry import get_lv_ellipsoid_geometry
from ..utils import _laplace_solve, _layers
from .lv import LAYER_SIZE

__all__ = ["compare_layers", "main"]


def compare_layers(psize: float, device=None) -> dict:
    """``expand_layer``'s labels of the LV at ``psize`` (its endo/epi solve
    and thresholds) on "jacobi" and on "amg":
    per preconditioner the solve's iterations, AMG setup and wall seconds
    and the layer counts; the number of nodes whose label differs."""
    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    V = fem.functionspace(geo.mesh, ("P", 1))
    bcs = [fem.dirichletbc(value, fem.locate_dofs_topological(V, 2, geo.ffun.find(geo.markers[key][0])), V)
           for key, value in (("ENDO", 0.0), ("EPI", 1.0))]
    out, labels = {"psize": psize, "n_nodes": int(V.ndofs)}, {}
    for precond in ("jacobi", "amg"):
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        tic = time.perf_counter()
        arr, info = _laplace_solve(V, bcs, precond=precond, device=device)
        labels[precond] = _layers(arr, LAYER_SIZE, LAYER_SIZE, 0, 1, 2)
        out[precond] = {"iterations": info.iterations, "converged": info.converged, "amg_levels": info.amg_levels,
                        "amg_setup_s": info.amg_setup_s, "wall_s": time.perf_counter() - tic,
                        "counts": [int((labels[precond] == m).sum()) for m in (0, 1, 2)]}
    out["labels_differ"] = int((labels["jacobi"] != labels["amg"]).sum())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--psize", type=float, default=0.1)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(compare_layers(args.psize, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
