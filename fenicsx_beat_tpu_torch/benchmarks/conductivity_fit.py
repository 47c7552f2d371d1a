"""Anisotropic conductivity personalization by gradient descent through the solver.

The port's copy of ``demos/conductivity_fit.py`` (lines 31-111), on
:mod:`..adjoint` and torch autograd: fit the fiber and transverse
conductivities ``(g_l, g_t)`` of ``K(g) = g_l K_fiber + g_t K_transverse``
so simulated probe voltage traces match observations, the gradient taken
through the operator-splitting time loop (implicit differentiation of the
CG solve).  Synthetic twin: targets at the true pair, the optimizer
(``torch.optim.Adam``, lr 0.15, in log space) started at half both values.
FitzHugh-Nagumo on the unit square, float64 on the CPU or float32 on the
card.  The demo's ``fit_history.csv`` is written to ``--outdir``; its plot
is left out.

Usage::

    python -m fenicsx_beat_tpu_torch.benchmarks.conductivity_fit --quick --device cpu
    python -m fenicsx_beat_tpu_torch.benchmarks.conductivity_fit            # on the card
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from .. import mesh as meshmod
from .. import stimulation
from ..adjoint import build_diff_simulator
from ..config import resolve_device
from ..models import fitzhughnagumo as fhn


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--quick", action="store_true", help="smoke size: fewer nodes, steps and iterations")
    parser.add_argument("-o", "--outdir", type=Path, default=Path("results-fit"))
    parser.add_argument("--device", default=None, help="cpu to run on the CPU (the card otherwise)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    nx = 16 if args.quick else 32
    n_steps = 60 if args.quick else 250
    iters = 12 if args.quick else 60

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
    probes = np.array([[0.2, 0.2], [0.5, 0.5], [0.8, 0.8], [0.2, 0.8], [0.8, 0.2]])
    sim = build_diff_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
        I_s=I_s, probe_points=probes, dt=0.1, n_steps=n_steps, stiffness_components=[K_l, K_t], device=dev)
    ionic = fhn.init_parameter_values()

    g_true = np.array([0.004, 0.0012])  # fiber ~3x transverse
    with torch.no_grad():
        target = sim({"g": g_true, "ionic": ionic})
    print(f"synthetic target generated at (g_l, g_t) = {tuple(g_true)}")

    dtype = target.dtype
    log_g = torch.log(torch.as_tensor(g_true / 2, device=dev).to(dtype)).requires_grad_(True)
    opt = torch.optim.Adam([log_g], lr=0.15)
    hist = []
    for it in range(iters):
        opt.zero_grad()
        loss = torch.mean((sim({"g": torch.exp(log_g), "ionic": ionic}) - target) ** 2)
        loss.backward()
        opt.step()
        g = np.exp(log_g.detach().double().cpu().numpy())
        hist.append((it, float(loss.detach()), g[0], g[1]))
        if it % max(1, iters // 10) == 0:
            print(f"iter {it:3d}  loss={float(loss.detach()):.3e}  g_l={g[0]:.5f} g_t={g[1]:.5f}")

    g_fit = np.exp(log_g.detach().double().cpu().numpy())
    rel = np.abs(g_fit - g_true) / g_true
    print(f"recovered (g_l, g_t) = ({g_fit[0]:.5f}, {g_fit[1]:.5f})  "
          f"(true ({g_true[0]:g}, {g_true[1]:g}), rel err {rel[0]:.1%}/{rel[1]:.1%})")
    if not hist[-1][1] < 0.2 * hist[0][1]:
        raise RuntimeError("optimization failed to reduce the loss")
    args.outdir.mkdir(parents=True, exist_ok=True)
    np.savetxt(args.outdir / "fit_history.csv", np.asarray(hist), header="iter loss g_l g_t", comments="")
    return g_fit


if __name__ == "__main__":
    main()
