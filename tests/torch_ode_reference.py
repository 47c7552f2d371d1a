"""The JAX package's side of the port's runtime ``.ode`` path.

Run as a script, it prints the values ``chip_smoke.py`` holds the port's
custom-ODE phase to on the card::

    JAX_PLATFORMS=cpu python tests/torch_ode_reference.py

``demos/custom_ode.py``'s configuration: the Niederer slab at dx=0.5 (4,305
nodes) with the inline FitzHugh-Nagumo source's generated GRL step, Strang,
dt=0.05, for a fixed 40 ms (its probes never fire, so the JAX
``run_niederer_benchmark`` would run on to 400 ms).  The JAX package's
generated jnp module in float64 on the CPU gives ``v_max`` and v at P1-P9
at 40 ms; the port's generated torch module in float32 on the CPU (its
kernels' twins) gives four witnesses, one from the initial states and three
from states moved by one ulp at random
(``benchmarks/bidomain_scale.perturb_states``), and each value's largest
distance from the float64 value over the witnesses.  ``chip_smoke.py``
holds the card's kernel run to three times each value's largest distance
over these witnesses and the card's own float32 runs (twins, and kernels
from states one ulp away), and at least three float32 ulps of the value.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fenicsx_beat_tpu_torch import odefile  # noqa: E402
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied  # noqa: E402

DX, DT, T = 0.5, 0.05, 40.0
SOURCE = odefile.ODES / "fhn_inline.ode"


def probe_nodes(coords: np.ndarray) -> list[int]:
    """The mesh vertex at each of P1-P9 (they are vertices at dx=0.5)."""
    pts = np.array(list(tnied.benchmark_points().values()))
    return [int(np.argmin(((coords - p) ** 2).sum(axis=1))) for p in pts]


def values(v: np.ndarray, nodes: list[int]) -> dict:
    return {"v_max": float(v.max()), **{f"v_P{i + 1}": float(v[k]) for i, k in enumerate(nodes)}}


def jax_values() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    from fenicsx_beat_tpu import odefile as jode
    from fenicsx_beat_tpu.benchmarks import niederer as jnied

    model = jode.load_ode(SOURCE.read_text(), name="fhn_inline")
    solver = jnied._build_solver(dx=DX, theta=0.5, model=model, operator_cache_key=None, use_pallas_ode=False)
    solver.solve((0.0, T), dt=DT)
    coords = np.asarray(solver.mesh.geometry.x)
    v = np.asarray(solver.states)[model.state_index("v"), : coords.shape[0]]
    return values(v, probe_nodes(coords))


def port_witness(seed: int | None) -> dict:
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.bidomain_scale import perturb_states

    model = odefile.load_ode(SOURCE)
    solver = tnied._build_solver(dx=DX, theta=0.5, model=model, device="cpu", dtype=torch.float32)
    if seed is not None:
        perturb_states(solver, seed)
    solver.solve((0.0, T), dt=DT)
    return values(solver.v.double().numpy(), probe_nodes(np.asarray(solver.mesh.geometry.x)))


def main() -> int:
    ref = jax_values()
    witnesses = [port_witness(seed) for seed in (None, 1, 2, 3)]
    gaps = {k: max(abs(w[k] - r) for w in witnesses) for k, r in ref.items()}
    print(json.dumps({"jax_f64": ref, "gap_f32": gaps, "witnesses_f32": witnesses}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
