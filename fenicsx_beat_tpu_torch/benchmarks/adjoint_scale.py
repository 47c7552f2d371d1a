"""Cost of the differentiable simulation at production scale, on the card.

The port's copy of ``fenicsx_beat_tpu/benchmarks/adjoint_scale.py``: the
forward pass and the value and gradient of a voltage-trace loss through
the whole splitting loop (implicit-diff CG, checkpointed steps) on the
Niederer slab, float32, FitzHugh-Nagumo (``run_adjoint_scale``); and the
clinical horizon, one full beat (20,000 steps at dt 0.05) through
host-chained segments (``run_full_beat``), exact or windowed
(``truncate_every``), clipped (``carry_clip``) and with adjoint-side loss
scaling (``cotangent_scale``), TP06 or FitzHugh-Nagumo.  Wall seconds
around work that ends in ``torch.cuda.synchronize()``; peak device memory
from ``torch.cuda.max_memory_allocated``.

Run, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.adjoint_scale 0.2 0.1
    python -m fenicsx_beat_tpu_torch.benchmarks.adjoint_scale --full-beat --out chiprun_out/adjoint_scale.json
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..adjoint import build_diff_simulator, host_segmented_value_and_grad
from ..config import resolve_device

SLAB = dict(Lx=20.0, Ly=7.0, Lz=3.0)
PROBES = np.array([[20.0, 7.0, 3.0], [10.0, 3.5, 1.5], [0.0, 0.0, 0.0]])


def _slab(dx: float):
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    mesh = get_3D_slab_geometry(None, dx=dx, **SLAB).mesh
    cells = locate_entities(mesh, 3, lambda x: (x[0] <= 1.5) & (x[1] <= 1.5) & (x[2] <= 1.5))
    I_s = Stimulus(expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
                   dZ=dx_measure(mesh, subdomain_data=meshtags(mesh, 3, cells, 1)), marker=1)
    return mesh, I_s


def _sync_clock(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _peak(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def run_adjoint_scale(dx: float, T: float = 20.0, dt: float = 0.05, device=None) -> dict:
    """Forward and value-and-grad of ``mean((traces - target)^2)`` over T ms
    in one piece, FitzHugh-Nagumo, float32, CG rtol 1e-6: the best of 3
    of each, the adjoint's overhead over the forward."""
    from ..models import fitzhughnagumo as fhn

    dev = resolve_device(device)
    mesh, I_s = _slab(dx)
    n_steps = int(round(T / dt))
    sim = build_diff_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
        I_s=I_s, probe_points=PROBES, dt=dt, n_steps=n_steps, dtype=torch.float32, cg_rtol=1e-6, cg_atol=1e-8,
        device=dev)
    ionic = fhn.init_parameter_values()
    with torch.no_grad():
        target = sim({"g": 0.0012, "ionic": ionic})

    def forward():
        with torch.no_grad():
            return torch.mean((sim({"g": 0.001, "ionic": ionic}) - target) ** 2)

    def value_and_grad():
        g = torch.tensor(0.001, dtype=torch.float32, device=dev, requires_grad=True)
        loss = torch.mean((sim({"g": g, "ionic": ionic}) - target) ** 2)
        loss.backward()
        return loss.detach(), g.grad

    def best_of(fn, n=3):
        best = float("inf")
        for _ in range(n):
            tic = _sync_clock(dev)
            fn()
            best = min(best, _sync_clock(dev) - tic)
        return best

    fwd_s = best_of(forward)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    vg_s = best_of(value_and_grad)
    val, grad = value_and_grad()
    return {
        "dx": dx, "n_nodes": int(mesh.num_vertices), "n_steps": n_steps, "dt": dt, "forward_s": fwd_s,
        "value_and_grad_s": vg_s, "adjoint_overhead_x": vg_s / fwd_s, "grad_g": float(grad), "loss": float(val),
        "peak_memory_bytes": _peak(dev), "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def _case_name(truncate_every, carry_clip, cotangent_scale) -> str:
    parts = ["full_beat"]
    if truncate_every is not None:
        parts.append(f"w{truncate_every}")
    if carry_clip is not None:
        parts.append(f"clip{carry_clip:g}")
    if cotangent_scale != 1.0:
        parts.append(f"cs2p{int(round(np.log2(cotangent_scale)))}")
    return "_".join(parts)


def run_full_beat(dx: float = 0.1, T: float = 1000.0, dt: float = 0.05, segments: int = 100, model: str = "tp06",
                  truncate_every: int | None = None, carry_clip: float | None = None, cotangent_scale: float = 1.0,
                  device=None) -> dict:
    """Value and gradient over one full beat (``T / dt`` steps) through
    host-chained segments (:func:`..adjoint.host_segmented_value_and_grad`),
    each step checkpointed; ``g`` at the physical 0.0012 (a unit scale
    drives TP06's rates into float32 gradient overflow)."""
    if model == "tp06":
        from ..models import tentusscher_panfilov_2006 as mod

        v_name, step = "V", mod.generalized_rush_larsen
    else:
        from ..models import fitzhughnagumo as mod

        v_name, step = "v", mod.forward_euler
    dev = resolve_device(device)
    mesh, I_s = _slab(dx)
    n_steps = int(round(T / dt))
    if n_steps % segments:
        raise ValueError("segments must divide n_steps")
    m = n_steps // segments
    sim = build_diff_simulator(
        mesh, ode_fun=step, init_states=mod.init_state_values(), v_index=mod.state_index(v_name), I_s=I_s,
        probe_points=PROBES, dt=dt, n_steps=m, dtype=torch.float32, cg_rtol=1e-6,
        # a power-of-two cotangent scale is exact only with a purely relative CG tolerance
        cg_atol=0.0 if cotangent_scale != 1.0 else 1e-8, device=dev)
    ionic = mod.init_parameter_values(stim_amplitude=0.0)
    states0 = torch.as_tensor(mod.init_state_values(), device=dev).to(torch.float32)[:, None].repeat(1, mesh.num_vertices)

    def run(p, **kw):
        return sim({**p, "ionic": ionic}, **kw)

    def seg_loss(traces, aux):
        return torch.mean(traces**2) / segments

    p = {"g": torch.tensor(0.0012, dtype=torch.float32, device=dev)}
    tic = _sync_clock(dev)
    s = states0
    with torch.no_grad():
        for k in range(segments):
            _tr, s = run(p, states0_in=s, t0=k * m * dt, return_final=True)
    fwd_s = _sync_clock(dev) - tic
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tic = _sync_clock(dev)
    val, grad = host_segmented_value_and_grad(
        run, p, seg_loss, [None] * segments, segment_ms=m * dt, states0=states0, truncate_every=truncate_every,
        carry_clip=carry_clip, cotangent_scale=cotangent_scale)
    vg_s = _sync_clock(dev) - tic
    g = float(grad["g"])
    return {
        "case": _case_name(truncate_every, carry_clip, cotangent_scale), "model": model, "dx": dx,
        "n_nodes": int(mesh.num_vertices), "n_steps": n_steps, "dt": dt, "host_segments": segments,
        "segment_steps": m, "truncate_every": truncate_every, "carry_clip": carry_clip,
        "cotangent_scale": cotangent_scale, "forward_s": fwd_s, "value_and_grad_s": vg_s,
        "adjoint_overhead_x": vg_s / fwd_s, "boundary_states_gib": segments * states0.numel() * 4 / 2**30,
        "peak_memory_bytes": _peak(dev), "loss": val, "grad_g": g, "grad_finite": bool(np.isfinite(g)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("dx", type=float, nargs="*", default=[0.2, 0.1])
    ap.add_argument("--full-beat", action="store_true", help="also the full-beat cases at dx=0.1")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (the card otherwise)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu", "configs": []}
    for dx in args.dx:
        row = run_adjoint_scale(dx, device=dev)
        print(json.dumps(row), flush=True)
        out["configs"].append(row)
    if args.full_beat:
        cs = 2.0**-64
        for model, kw in (("fhn", {}), ("tp06", {}), ("tp06", dict(truncate_every=1, cotangent_scale=cs)),
                          ("tp06", dict(truncate_every=2, cotangent_scale=cs)),
                          ("tp06", dict(truncate_every=10, carry_clip=1e6, cotangent_scale=cs))):
            row = run_full_beat(model=model, device=dev, **kw)
            print(json.dumps(row), flush=True)
            out["configs"].append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
