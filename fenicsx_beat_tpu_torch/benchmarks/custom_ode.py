"""Bring your own cell model on the port: runtime ``.ode`` ingestion.

The path of ``demos/custom_ode.py`` on the card: a gotran ``.ode`` file
(or the demo's inline modified FitzHugh-Nagumo, the port's copy in
``odes/fhn_inline.ode``) becomes a torch cell model with the gotranx
contract and kernels of its own (:func:`~..odefile.load_ode`; ``nvcc``
builds them into ``build/torch_kernels/`` at the first step on the card),
then one single-cell step, then the Niederer slab run by the generated
stepper (:func:`~.niederer.run_niederer_benchmark` with ``model=``).  The
two-line user path::

    model = odefile.load_ode("my_model.ode")
    result = run_niederer_benchmark(dx=0.1, dt=0.05, T=40.0, theta=0.5, model=model)

Usage, on a machine with a CUDA card (prints one JSON line)::

    python3 -m fenicsx_beat_tpu_torch.benchmarks.custom_ode --dx 0.1 -T 40

The inline FitzHugh-Nagumo does not propagate on the slab, so its probes
never fire and the run goes on to ``10 T``, as the JAX function's does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import odefile
from ..config import resolve_device
from .niederer import run_niederer_benchmark

__all__ = ["main"]

DT, THETA = 0.05, 0.5  # the demo's time step (ms) and Strang splitting


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ode", type=Path, default=odefile.ODES / "fhn_inline.ode",
                    help="a gotran .ode file (default: the demo's inline FitzHugh-Nagumo)")
    ap.add_argument("--dx", type=float, default=0.5)
    ap.add_argument("-T", type=float, default=40.0, help="ms")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tic = time.perf_counter()
    model = odefile.load_ode(args.ode, device=dev)  # builds the model's kernels on a card
    load_s = time.perf_counter() - tic

    # one single-cell step of four cells, on the device
    states = torch.tensor(np.tile(model.init_state_values()[:, None], (1, 4)), device=dev)
    out = model.generalized_rush_larsen(states, 0.0, model.init_parameter_values(), 0.02)

    res = run_niederer_benchmark(dx=args.dx, dt=DT, T=args.T, theta=THETA, model=model, device=dev)
    row = {
        "model": model.__name__,
        "num_states": model.num_states,
        "num_parameters": model.num_parameters,
        "scheme": "generalized_rush_larsen",
        "load_s": load_s,
        "single_cell_finite": bool(torch.isfinite(out).all()),
        "dx": args.dx,
        "dt": DT,
        "n_nodes": res.n_nodes,
        "simulated_ms": res.simulated_ms,
        "wall_s": res.wall_time_s,
        "ms_per_s": res.ms_per_second,
        "cg_iters_mean": res.cg_iters_mean,
        "host_syncs_per_step": res.host_syncs_per_step,
        "activation_times": res.activation_times,
        "device": res.device,
    }
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
    sys.exit(0)
