"""Extracellular anisotropy fitting through the differentiable BIDOMAIN.

The port's copy of ``demos/anisotropy_fit.py`` (lines 36-118), on
:func:`..adjoint.build_diff_bidomain_simulator` and torch autograd: fit the
EXTRACELLULAR fiber/transverse pair ``(ge_l, ge_t)`` from u_e electrode
traces alone, the gradient taken through the coupled (v, u_e) block solve.
Synthetic twin: targets at the true pair (intracellular 4:1 known,
extracellular ~1.6:1 unknown), the optimizer (``torch.optim.Adam``, lr 0.1,
in log space) started at an equal-anisotropy guess.  FitzHugh-Nagumo on
the unit square, float64 on the CPU or float32 on the card.  The demo's
``aniso_fit_history.csv`` is written to ``--outdir``; its plot is left out.

Usage::

    python -m fenicsx_beat_tpu_torch.benchmarks.anisotropy_fit --quick --device cpu
    python -m fenicsx_beat_tpu_torch.benchmarks.anisotropy_fit            # on the card
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import mesh as meshmod
from .. import stimulation
from ..adjoint import build_diff_bidomain_simulator
from ..config import resolve_device
from ..models import fitzhughnagumo as fhn


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--quick", action="store_true", help="smoke size: fewer nodes, steps and iterations")
    parser.add_argument("-o", "--outdir", type=Path, default=Path("results-aniso-fit"))
    parser.add_argument("--device", default=None, help="cpu to run on the CPU (the card otherwise)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    nx = 12 if args.quick else 24
    n_steps = 50 if args.quick else 150
    iters = 10 if args.quick else 40

    mesh = meshmod.create_unit_square(None, nx, nx)
    cells = meshmod.locate_entities(mesh, 2, lambda x: (x[0] < 0.25) & (x[1] < 0.25))
    tags = meshmod.meshtags(mesh, 2, cells, 1)
    I_s = stimulation.Stimulus(
        expr=stimulation.TimeWindow(amplitude=40.0, start=0.0, duration=1.0),
        dZ=stimulation.dx(mesh, subdomain_data=tags),
        marker=1,
    )
    f0 = np.array([1.0, 0.0])
    K_l = np.outer(f0, f0)
    K_t = np.eye(2) - K_l
    xs = [0.2, 0.5, 0.8]
    electrodes = np.array([[x, y] for x in xs for y in xs])
    sim = build_diff_bidomain_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
        I_s=I_s, probe_points=electrodes[:1], u_probe_points=electrodes, dt=0.1, n_steps=n_steps,
        intra_components=[K_l, K_t], extra_components=[K_l, K_t], device=dev)
    ionic = fhn.init_parameter_values()

    gi = np.array([0.004, 0.001])
    ge_true = np.array([0.008, 0.005])
    with torch.no_grad():
        target = sim({"gi": gi, "ge": ge_true, "ionic": ionic})["u_e"]
    print(f"synthetic u_e target generated at (ge_l, ge_t) = {tuple(ge_true)}")

    log_ge = torch.log(torch.tensor([0.0065, 0.0065], device=dev).to(target.dtype)).requires_grad_(True)
    opt = torch.optim.Adam([log_ge], lr=0.1)
    hist = []
    for it in range(iters):
        opt.zero_grad()
        loss = torch.mean((sim({"gi": gi, "ge": torch.exp(log_ge), "ionic": ionic})["u_e"] - target) ** 2)
        loss.backward()
        opt.step()
        ge = np.exp(log_ge.detach().double().cpu().numpy())
        hist.append((it, float(loss.detach()), ge[0], ge[1]))
        if it % max(1, iters // 10) == 0:
            print(f"iter {it:3d}  loss={float(loss.detach()):.3e}  ge_l={ge[0]:.5f} ge_t={ge[1]:.5f}")

    ge_fit = np.exp(log_ge.detach().double().cpu().numpy())
    rel = np.abs(ge_fit - ge_true) / ge_true
    print(f"recovered (ge_l, ge_t) = ({ge_fit[0]:.5f}, {ge_fit[1]:.5f})  "
          f"(true ({ge_true[0]:g}, {ge_true[1]:g}), rel err {rel[0]:.1%}/{rel[1]:.1%})")
    if not hist[-1][1] < 0.2 * hist[0][1]:
        raise RuntimeError("optimization failed to reduce the loss")
    args.outdir.mkdir(parents=True, exist_ok=True)
    np.savetxt(args.outdir / "aniso_fit_history.csv", np.asarray(hist), header="iter loss ge_l ge_t", comments="")
    return ge_fit


if __name__ == "__main__":
    main()
