"""Splitting-scheme verification: Godunov is first order, Strang second.

The port's copy of ``demos/verification.py`` (the reference's, with the
exact ODE propagator at ``:121-126``), through the object-oriented API:
the coupled MMS problem ``v = cos(2 pi x) cos(2 pi y) sin(t)`` with the
exact rotation propagator for the ODE sub-step, and dt self-convergence
on a fixed mesh, so the temporal orders show above the O(h^2) spatial
floor.  The propagator is a torch function of the state tensor, so the
whole run stays on the device.

Usage::

    python -m fenicsx_beat_tpu_torch.benchmarks.verification            # N=64, on the card
    python -m fenicsx_beat_tpu_torch.benchmarks.verification --quick --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import fem
from .. import mesh as meshmod
from ..monodomain_model import MonodomainModel
from ..monodomain_solver import MonodomainSplittingSolver
from ..odesolver import DolfinODESolver

__all__ = ["ac_func", "exact_propagator", "run", "rates"]


def ac_func(x, t):
    return 8 * torch.pi**2 * torch.cos(2 * torch.pi * x[0]) * torch.cos(2 * torch.pi * x[1]) * torch.sin(t)


def exact_propagator(states, t, dt, parameters):
    """The exact flow of ``v' = -s, s' = v`` over ``dt``: a rotation."""
    v, s = states
    c, sn = np.cos(dt), np.sin(dt)
    return torch.stack([c * v - sn * s, sn * v + c * s])


def run(mesh, theta: float, dt: float, T: float = 1.0, device=None) -> np.ndarray:
    """The splitting solve of the MMS problem to ``T``; the PDE state."""
    time = fem.Constant(0.0)
    pde = MonodomainModel(time=time, mesh=mesh, M=1.0, I_s=ac_func, device=device)
    V_ode = fem.functionspace(mesh, ("P", 1))
    s = fem.Function(V_ode)
    s.interpolate(lambda x: -np.cos(2 * np.pi * x[0]) * np.cos(2 * np.pi * x[1]))
    init_states = np.zeros((2, s.x.array.size))
    init_states[1, :] = s.x.array
    ode = DolfinODESolver(
        v_ode=fem.Function(V_ode),
        v_pde=pde.state,
        fun=exact_propagator,
        init_states=init_states,
        parameters=None,
        num_states=2,
        v_index=0,
        device=device,
    )
    solver = MonodomainSplittingSolver(pde=pde, ode=ode, theta=theta)
    solver.solve((0.0, T), dt=dt)
    return np.array(pde.state.x.array)


def rates(N: int = 64, quick: bool = False, device=None) -> dict:
    """Observed temporal rates of Godunov and Strang against a fine-dt run
    on the same mesh: ``{name: (errors, rates)}``.  ``quick``: N=24, two
    dts (the demo's CI form)."""
    if quick:
        N = 24
    mesh = meshmod.create_unit_square(None, N, N)
    dts = [1 / 8, 1 / 16] if quick else [1 / 8, 1 / 16, 1 / 32]
    out = {}
    for theta, name in [(1.0, "Godunov"), (0.5, "Strang")]:
        ref = run(mesh, theta, dt=1 / 128 if quick else 1 / 256, device=device)
        errors = []
        for dt in dts:
            diff = run(mesh, theta, dt=dt, device=device) - ref
            errors.append(float(np.sqrt(np.mean(diff**2))))
        out[name] = (errors, [float(np.log2(e1 / e2)) for e1, e2 in zip(errors[:-1], errors[1:])])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-N", type=int, default=64)
    ap.add_argument("--quick", action="store_true", help="N=24, two dts")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    for name, (errors, r) in rates(args.N, args.quick, args.device).items():
        expected = 1.0 if name == "Godunov" else 2.0
        print(f"{name}: errors={errors}")
        print(f"  observed rates {r} (expected ~{expected})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
