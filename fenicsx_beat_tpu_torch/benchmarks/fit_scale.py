"""Production-scale inverse problem: recover anisotropic conductivities from
synthetic probe traces by gradient descent through the solver.

The port's copy of ``fenicsx_beat_tpu/benchmarks/fit_scale.py``, on
:mod:`..adjoint` and torch autograd:

* ``slab``: the Niederer slab (58,176 nodes at dx=0.2), fibers along x, fit
  ``(g_l, g_t)`` of ``K(g) = g_l K_f + g_t K_t`` from 12 probe traces.
* ``lv``: the unstructured LV ellipsoid (78,968 nodes at psize 0.15), the
  same two components from the rule-based fiber field; on the card its
  operators go through B8's combination (:class:`..adjoint.LaneCombo`).
* ``fdcheck``: the WINDOWED gradient against central finite differences
  of the TRUE total loss: the cosine of the two in log space, and whether
  their signs match.
* ``witness``: the ``lv`` fit's first window on B8 and on B8's twin (the
  plain path, ``use_lane_ops=False``), each also from states one ulp away
  and with each row's entries summed in reverse order: the float32 noise
  that ``chip_smoke.py`` holds the two paths' gap to.
* ``reference``: the ``lv`` fit's first window at psize 0.5 over 10 ms (two
  5 ms segments) on the CPU, in float64, and in float32 from the same states
  and from states moved by one ulp (three seeds): the reference that
  ``chip_smoke.py`` holds the card's float32 window to, and the float32
  noise it allows.

TP06 GRL in float32, dt 0.05 ms, host-chained 10 ms segments
(:func:`..adjoint.host_segmented_value_and_grad`) with 20 ms truncation
windows, ``carry_clip`` 1e3, ``cotangent_scale`` 2**-64 and
``window_outlier`` 20.  The loss is ``mean((v - v_target)^2) / (100
mV)^2`` per segment; the parameters are optimized in log space with Adam
(``torch.optim.Adam``: the learning rate held for the first half of the
iterations, then decayed exponentially to 0.2x, as the JAX package's optax
schedule), then polished from the best iterate at 0.05x.  The ionic
parameters are fixed and enter the simulator outside the differentiated
``params`` (the fit asks for the conductivities' gradient only).

Run, on a machine with a CUDA card::

    python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale lv --psize 0.15 -T 40 --iters 4
    python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale slab --dx 0.2
    python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale fdcheck --dx 1.0 -T 30 --rel-eps 0.05
    python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale witness
    python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale reference --device cpu

Each prints one JSON row per iteration and one for the run (appended to
``--out`` as a JSON list when given).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..adjoint import build_diff_simulator, host_segmented_value_and_grad
from ..config import resolve_device

DEFAULT_WINDOW_MS = 20.0  # 2 x 10 ms segments
G_TRUE = (0.002, 0.0006)  # ~3.3x anisotropy
G0_SCALE = (0.5, 1.8)  # the fit's start: off the truth, asymmetrically
CARRY_CLIP, COTANGENT_SCALE, WINDOW_OUTLIER = 1e3, 2.0**-64, 20.0
LR = 0.15  # Adam's learning rate in log space
# the ``reference`` window: the LV at psize 0.5 (2,607 nodes), two 5 ms
# segments in one window
REF_PSIZE, REF_T, REF_SEGMENT_MS = 0.5, 10.0, 5.0


@functools.lru_cache(maxsize=2)
def _slab_problem(dx: float):
    """Niederer slab, corner S1 stimulus, fiber/transverse stiffness
    components, 12 probes spread over the tissue."""
    from ..geometry import get_3D_slab_geometry
    from ..mesh import locate_entities, meshtags
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    mesh = get_3D_slab_geometry(None, dx=dx, Lx=20.0, Ly=7.0, Lz=3.0).mesh
    cells = locate_entities(mesh, 3, lambda x: (x[0] <= 1.5) & (x[1] <= 1.5) & (x[2] <= 1.5))
    I_s = Stimulus(expr=TimeWindow(amplitude=50.0, start=0.0, duration=2.0),
                   dZ=dx_measure(mesh, subdomain_data=meshtags(mesh, 3, cells, 1)), marker=1)
    f0 = np.array([1.0, 0.0, 0.0])
    K_f = np.outer(f0, f0)
    probes = np.array([[x, y, z] for x in (2.0, 8.0, 14.0, 19.0) for (y, z) in ((1.0, 1.0), (3.5, 1.5), (6.0, 2.5))])
    return mesh, I_s, [K_f, np.eye(3) - K_f], probes


@functools.lru_cache(maxsize=2)
def _lv_problem(psize: float):
    """The unstructured LV ellipsoid with the rule-based fiber field (a
    per-node field, averaged to cells), an apical-cap stimulus, and 12
    probes at regular quantiles along the long (x) axis."""
    from ..conductivities import as_cell_tensors
    from ..geometry import get_lv_ellipsoid_geometry
    from ..mesh import locate_entities, meshtags
    from ..stimulation import Stimulus, TimeWindow
    from ..stimulation import dx as dx_measure

    geo = get_lv_ellipsoid_geometry(psize_ref=psize, cache=False)
    mesh = geo.mesh
    coords = mesh.coords
    apex_x = coords[:, 0].min()
    cells = locate_entities(mesh, 3, lambda x: x[0] <= apex_x + 2.0)
    I_s = Stimulus(expr=TimeWindow(amplitude=30.0, start=0.0, duration=2.0),
                   dZ=dx_measure(mesh, subdomain_data=meshtags(mesh, 3, cells, 1)), marker=1)
    f = np.asarray(geo.f0)
    if f.shape[0] == mesh.num_vertices:
        f = f[mesh.cells].mean(axis=1)
        f /= np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    K_f = np.einsum("ci,cj->cij", f, f)
    K_t = np.eye(3)[None] - K_f
    order = np.argsort(coords[:, 0])
    qs = np.linspace(0.04, 0.96, 12)
    probes = coords[order[(qs * (coords.shape[0] - 1)).astype(int)]]
    return mesh, I_s, [as_cell_tensors(K_f, mesh), as_cell_tensors(K_t, mesh)], probes


@dataclass
class FitProblem:
    """A built fit problem: the segment simulator ``sim(params, **kw)``
    (the ionic parameters bound), its initial states, the segment count
    and length."""

    mesh: object
    sim: object
    raw_sim: object
    states0: torch.Tensor
    n_seg: int
    seg_steps: int
    segment_ms: float

    def targets(self, g) -> tuple[list, float]:
        """Per-segment target traces of a forward sweep at ``g``, and its
        seconds."""
        g = torch.as_tensor(np.asarray(g, dtype=np.float64), device=self.states0.device).to(self.states0.dtype)
        tic = _clock(self.states0)
        out, s = [], self.states0
        with torch.no_grad():
            for k in range(self.n_seg):
                tr, s = self.sim({"g": g}, states0_in=s, t0=k * self.segment_ms, return_final=True)
                out.append(tr)
        return out, _clock(self.states0) - tic


def build_problem(case: str, dx: float = 0.2, psize: float = 0.15, T: float = 400.0, dt: float = 0.05,
                  segment_ms: float = 10.0, cg_rtol: float = 1e-6, cg_atol: float = 1e-8, device=None,
                  dtype=torch.float32, use_lane_ops=None) -> FitProblem:
    from ..models import tentusscher_panfilov_2006 as tp06

    dev = resolve_device(device)
    mesh, I_s, comps, probes = _lv_problem(psize) if case == "lv" else _slab_problem(dx)
    seg_steps = int(round(segment_ms / dt))
    n_seg = int(round(T / segment_ms))
    raw = build_diff_simulator(
        mesh, ode_fun=tp06.generalized_rush_larsen, init_states=tp06.init_state_values(),
        v_index=tp06.state_index("V"), I_s=I_s, probe_points=probes, dt=dt, n_steps=seg_steps, dtype=dtype,
        cg_rtol=cg_rtol, cg_atol=cg_atol, stiffness_components=comps, device=dev, use_lane_ops=use_lane_ops)
    ionic = tp06.init_parameter_values(stim_amplitude=0.0)

    def sim(p, **kw):
        return raw({**p, "ionic": ionic}, **kw)

    states0 = torch.as_tensor(tp06.init_state_values(), device=dev).to(dtype)[:, None].repeat(1, mesh.num_vertices)
    return FitProblem(mesh=mesh, sim=sim, raw_sim=raw, states0=states0, n_seg=n_seg, seg_steps=seg_steps,
                      segment_ms=segment_ms)


def _clock(like: torch.Tensor) -> float:
    if like.device.type == "cuda":
        torch.cuda.synchronize(like.device)
    return time.perf_counter()


def norm_seg_loss(traces, target):
    """Per-segment objective: trace MSE in units of (100 mV)^2, O(1)."""
    return torch.mean((traces - target) ** 2) / 1e4


def total_loss(prob: FitProblem, g, targets) -> float:
    """The fit's objective at ``g`` (array-like) from a forward sweep
    without a graph."""
    tr, _ = prob.targets(g)
    return float(sum(float(norm_seg_loss(a, b)) for a, b in zip(tr, targets)))


def fit_start(prob: FitProblem, g_true=G_TRUE, g0_scale=G0_SCALE) -> torch.Tensor:
    """The fit's first iterate, ``exp(log(g_true * g0_scale))`` in the
    problem's type, as :func:`run_fit` evaluates it."""
    theta = torch.log(torch.as_tensor(np.asarray(g_true) * np.asarray(g0_scale), device=prob.states0.device)
                      .to(prob.states0.dtype))
    return torch.exp(theta)


def windowed_value_and_grad(prob: FitProblem, g, targets, window_ms: float = DEFAULT_WINDOW_MS,
                            carry_clip=CARRY_CLIP, cotangent_scale=COTANGENT_SCALE, window_outlier=WINDOW_OUTLIER,
                            states0=None, segment_seconds: dict | None = None):
    """The fit's windowed ``(value, dL/dg)`` at ``g``."""
    return host_segmented_value_and_grad(
        prob.sim, {"g": g}, norm_seg_loss, targets, segment_ms=prob.segment_ms,
        states0=prob.states0 if states0 is None else states0,
        truncate_every=max(1, int(round(window_ms / prob.segment_ms))), carry_clip=carry_clip,
        cotangent_scale=cotangent_scale, window_outlier=window_outlier, segment_seconds=segment_seconds)


def adam(theta: torch.Tensor, lr: float, n_iters: int | None):
    """Adam on ``theta``; with ``n_iters``, lr held for the first half, then
    ``lr * 0.2 ** ((k - hold) / (n_iters - hold))`` (optax's
    ``join_schedules`` of a constant and an ``exponential_decay``)."""
    opt = torch.optim.Adam([theta], lr=lr)
    if n_iters is None:
        return opt, None
    hold = max(n_iters // 2, 1)
    span = max(n_iters - hold, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 1.0 if k < hold else 0.2 ** ((k - hold) / span))
    return opt, sched


def run_fit(case: str = "slab", dx: float = 0.2, psize: float = 0.15, T: float = 400.0, dt: float = 0.05,
            segment_ms: float = 10.0, window_ms: float = DEFAULT_WINDOW_MS, n_iters: int = 12, lr: float = LR,
            g_true=G_TRUE, g0_scale=G0_SCALE, n_polish: int = 6, carry_clip: float | None = CARRY_CLIP,
            cotangent_scale: float = COTANGENT_SCALE, window_outlier: float | None = WINDOW_OUTLIER,
            seed_noise_mv: float = 0.0, device=None, problem: FitProblem | None = None,
            targets=None, verbose: bool = True) -> dict:
    """Fit ``(g_l, g_t)`` from a start off the truth; one JSON row per
    iteration and the run's summary (rel_err of the best iterate, the loss
    history, seconds per iteration).  ``problem`` and ``targets`` reuse a
    built problem and its target sweep."""
    tic0 = time.perf_counter()
    prob = problem or build_problem(case, dx, psize, T, dt, segment_ms, device=device)
    setup_s = time.perf_counter() - tic0
    dtype, dev = prob.states0.dtype, prob.states0.device
    target_s = 0.0
    if targets is None:
        targets, target_s = prob.targets(g_true)
    if seed_noise_mv:
        rng = np.random.default_rng(3)
        targets = [t + torch.as_tensor(rng.normal(0.0, seed_noise_mv, tuple(t.shape)), device=dev).to(dtype)
                   for t in targets]

    theta = torch.log(torch.as_tensor(np.asarray(g_true) * np.asarray(g0_scale), device=dev).to(dtype))
    theta.requires_grad_(True)
    history: list[dict] = []
    best = {"loss": np.inf, "theta": theta.detach().clone()}
    seconds: dict = {}

    def fit_step(opt, sched, it, phase):
        g = torch.exp(theta.detach())
        value, grads = windowed_value_and_grad(prob, g, targets, window_ms, carry_clip, cotangent_scale,
                                               window_outlier, segment_seconds=seconds)
        g_theta = g * grads["g"]  # d loss / d theta = g * d loss / d g
        finite = bool(torch.isfinite(g_theta).all())
        if not finite:
            g_theta = torch.zeros_like(g_theta)
        if value < best["loss"]:
            best["loss"], best["theta"] = value, theta.detach().clone()
        theta.grad = g_theta.to(theta.dtype)
        opt.step()
        if sched is not None:
            sched.step()
        row = {"iter": it, "phase": phase, "loss": value, "g": g.double().cpu().tolist(),
               "grad_logg": g_theta.double().cpu().tolist(), "grad_finite": finite}
        history.append(row)
        if verbose:
            print(json.dumps(row), flush=True)

    t_fit = time.perf_counter()
    opt, sched = adam(theta, lr, n_iters)
    for it in range(n_iters):
        fit_step(opt, sched, it, "main")
    if n_polish:
        with torch.no_grad():
            theta.copy_(best["theta"])
        opt2, _ = adam(theta, 0.05 * lr, None)
        for it in range(n_polish):
            fit_step(opt2, None, n_iters + it, "polish")
    fit_s = time.perf_counter() - t_fit
    n_timed = len(seconds["backward"]) // prob.n_seg
    g_fin = np.exp(best["theta"].double().cpu().numpy())  # the best evaluated iterate
    rel_err = np.abs(g_fin - np.asarray(g_true)) / np.asarray(g_true)
    losses = [h["loss"] for h in history]
    return {
        "mode": "fit", "case": case, "resolution": dx if case == "slab" else psize,
        "n_nodes": int(prob.mesh.num_vertices), "model": "tp06", "T_ms": prob.n_seg * prob.segment_ms, "dt": dt,
        "n_steps": prob.n_seg * prob.seg_steps, "segment_ms": prob.segment_ms,
        "window_ms": max(1, int(round(window_ms / prob.segment_ms))) * prob.segment_ms,
        "carry_clip": carry_clip, "window_outlier": window_outlier,
        "cotangent_scale_log2": float(np.log2(cotangent_scale)), "n_iters": n_iters, "n_polish": n_polish, "lr": lr,
        "loss_best": best["loss"], "g_true": [float(x) for x in g_true], "g0": history[0]["g"],
        "g_recovered": [float(x) for x in g_fin], "rel_err": [float(x) for x in rel_err],
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_decrease_x": losses[0] / max(losses[-1], 1e-30),
        "loss_monotone_frac": float(np.mean(np.diff(losses) < 0.0)) if len(losses) > 1 else 0.0,
        "all_grads_finite": all(h["grad_finite"] for h in history),
        "setup_s": setup_s, "target_sweep_s": target_s, "fit_wall_s": fit_s, "s_per_iter": fit_s / n_timed,
        "segment_forward_s": float(np.mean(seconds["forward"])), "segment_backward_s": float(np.mean(seconds["backward"])),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "history": history,
    }


def run_fdcheck(dx: float = 0.5, T: float = 100.0, dt: float = 0.05, segment_ms: float = 10.0,
                window_ms: float = DEFAULT_WINDOW_MS, rel_eps: float = 0.02, g_true=G_TRUE, g_at=(0.0014, 0.0009),
                carry_clip: float | None = CARRY_CLIP, cotangent_scale: float = COTANGENT_SCALE,
                window_outlier: float | None = WINDOW_OUTLIER, device=None) -> dict:
    """The windowed gradient's DIRECTION against central finite differences
    of the TRUE total loss on the slab (CG rtol 1e-7): the windowed gradient
    is exact for the windowed objective; what the fit needs is that it
    descends the true one.  Compared in log space (the fit's variables)."""
    prob = build_problem("slab", dx, None, T, dt, segment_ms, cg_rtol=1e-7, cg_atol=1e-9, device=device)
    targets, _ = prob.targets(g_true)
    g_at_np = np.asarray(g_at, np.float64)
    g_t = torch.as_tensor(g_at_np, device=prob.states0.device).to(prob.states0.dtype)
    value, grads = windowed_value_and_grad(prob, g_t, targets, window_ms, carry_clip, cotangent_scale, window_outlier)
    g_win = grads["g"].double().cpu().numpy()
    fd = np.zeros(2)
    for i in range(2):
        e = np.zeros(2)
        e[i] = rel_eps * g_at_np[i]
        fd[i] = (total_loss(prob, g_at_np + e, targets) - total_loss(prob, g_at_np - e, targets)) / (2 * e[i])
    win_log, fd_log = g_win * g_at_np, fd * g_at_np
    cos = float(np.dot(win_log, fd_log) / max(np.linalg.norm(win_log) * np.linalg.norm(fd_log), 1e-300))
    return {
        "mode": "fdcheck", "dx": dx, "n_nodes": int(prob.mesh.num_vertices), "T_ms": T,
        "window_ms": max(1, int(round(window_ms / segment_ms))) * segment_ms, "window_outlier": window_outlier,
        "g_true": list(map(float, g_true)), "g_at": list(map(float, g_at)), "rel_eps": rel_eps, "loss_at": value,
        "grad_windowed_logg": [float(x) for x in win_log], "grad_fd_logg": [float(x) for x in fd_log],
        "cosine_log_space": cos, "signs_match": bool((np.sign(win_log) == np.sign(fd_log)).all()),
    }


def ulp_moved(states: torch.Tensor, seed: int) -> torch.Tensor:
    """``states`` with each entry moved by one ulp of its row's largest
    magnitude (of 1 for a row of zeros), up, down or not at all, at random
    (``seed``): a start whose run is a witness of float32's rounding."""
    step = torch.as_tensor(np.random.default_rng(seed).integers(-1, 2, tuple(states.shape))).to(states)
    mag = states.abs().amax(dim=1, keepdim=True)
    mag = torch.where(mag > 0, mag, torch.ones_like(mag))
    return states + step * (torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag)


def sum_rows_reversed(prob: FitProblem) -> None:
    """Reverse the order of each row's entries in ``prob``'s operators (a
    :class:`..adjoint.LaneCombo`), in place: the same products, each row
    summed in another order, a witness of float32's rounding where two
    paths differ in the order of their sums."""
    combo = prob.raw_sim.operators
    P = combo.parts[0]
    indptr = P.indptr.long()
    lengths = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(torch.arange(P.shape[0], device=indptr.device), lengths)
    k = torch.arange(P.nnz, device=indptr.device)
    perm = indptr[rows + 1] - 1 - (k - indptr[rows])
    combo.parts = tuple(dataclasses.replace(Q, cols=Q.cols[perm].contiguous(), vals=Q.vals[perm].contiguous())
                        for Q in combo.parts)
    combo.vals = combo.vals[:, perm].contiguous()


def run_witness(psize: float = 0.15, T: float = 20.0, seed: int = 1, device=None) -> dict:
    """The ``lv`` fit's first window (at the fit's start) on B8's combination
    and on B8's twin (``use_lane_ops=False``), each also from states moved
    by one ulp (:func:`ulp_moved`) and with its rows summed in reverse order
    (:func:`sum_rows_reversed`): the value and ``dL/dg`` of the six, the gap
    between the two paths and each quantity's float32 noise, the largest
    gap of a path to its own witnesses.  Every kernel and sum on these
    paths is deterministic, so a card repeats the figures bit for bit."""
    lane = build_problem("lv", psize=psize, T=T, device=device)
    plain = build_problem("lv", psize=psize, T=T, device=device, use_lane_ops=False)
    targets, _ = lane.targets(G_TRUE)
    g0 = fit_start(lane)
    runs = {}
    for tag, prob in (("lane", lane), ("plain", plain)):
        for suffix, s0 in (("", None), ("_ulp", ulp_moved(lane.states0, seed))):
            value, grads = windowed_value_and_grad(prob, g0, targets, states0=s0)
            runs[tag + suffix] = [value, *grads["g"].double().cpu().tolist()]
        sum_rows_reversed(prob)
        value, grads = windowed_value_and_grad(prob, g0, targets)
        runs[tag + "_reversed"] = [value, *grads["g"].double().cpu().tolist()]
    r = {k: np.asarray(v) for k, v in runs.items()}
    gap = np.abs(r["lane"] - r["plain"])
    noise = np.max([np.abs(r[t] - r[t + w]) for t in ("lane", "plain") for w in ("_ulp", "_reversed")], axis=0)
    names = ["loss", "dL/dg_l", "dL/dg_t"]
    dev = lane.states0.device
    return {
        "mode": "witness", "psize": psize, "T_ms": T, "seed": seed, "n_nodes": int(lane.mesh.num_vertices),
        "runs": runs, "gap": dict(zip(names, gap.tolist())), "noise": dict(zip(names, noise.tolist())),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def first_window(prob: FitProblem, states0=None) -> list[float]:
    """``[value, dL/dg_l, dL/dg_t]`` of one window over the whole of
    ``prob``'s horizon at the fit's start (:func:`fit_start`), the targets
    a sweep at :data:`G_TRUE` in the problem's own type."""
    targets, _ = prob.targets(G_TRUE)
    T = prob.n_seg * prob.segment_ms
    value, grads = windowed_value_and_grad(prob, fit_start(prob), targets, window_ms=T, states0=states0)
    return [value, *grads["g"].double().cpu().tolist()]


def run_reference(psize: float = REF_PSIZE, T: float = REF_T, segment_ms: float = REF_SEGMENT_MS,
                  seeds=(1, 2, 3), device="cpu") -> dict:
    """:func:`first_window` of the ``lv`` fit at ``psize`` over ``T`` in
    float64, and in float32 from the same states and from states moved by
    one ulp (:func:`ulp_moved`, each of ``seeds``): a card's float32 window
    of the same problem is held to the float64 one within a multiple of the
    largest gap of the float32 runs to it."""
    tic = time.perf_counter()
    f64 = build_problem("lv", psize=psize, T=T, segment_ms=segment_ms, device=device, dtype=torch.float64)
    f32 = build_problem("lv", psize=psize, T=T, segment_ms=segment_ms, device=device, dtype=torch.float32)
    runs = {"f64": first_window(f64), "f32": first_window(f32)}
    for seed in seeds:
        runs[f"f32_ulp{seed}"] = first_window(f32, ulp_moved(f32.states0, seed))
    return {"mode": "reference", "psize": psize, "T_ms": T, "segment_ms": segment_ms, "seeds": list(seeds),
            "n_nodes": int(f64.mesh.num_vertices), "runs": runs, "seconds": time.perf_counter() - tic}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    for name in ("slab", "lv"):
        p = sub.add_parser(name)
        p.add_argument("--dx", type=float, default=0.2)
        p.add_argument("--psize", type=float, default=0.15)
        p.add_argument("-T", type=float, default=400.0)
        p.add_argument("--dt", type=float, default=0.05)
        p.add_argument("--segment-ms", type=float, default=10.0)
        p.add_argument("--window-ms", type=float, default=DEFAULT_WINDOW_MS)
        p.add_argument("--iters", type=int, default=12)
        p.add_argument("--polish", type=int, default=6)
        p.add_argument("--lr", type=float, default=LR)
    pf = sub.add_parser("fdcheck")
    pf.add_argument("--dx", type=float, default=0.5)
    pf.add_argument("-T", type=float, default=100.0)
    pf.add_argument("--window-ms", type=float, default=DEFAULT_WINDOW_MS)
    pf.add_argument("--rel-eps", type=float, default=0.02)
    pw = sub.add_parser("witness")
    pw.add_argument("--psize", type=float, default=0.15)
    pw.add_argument("-T", type=float, default=DEFAULT_WINDOW_MS)
    pw.add_argument("--seed", type=int, default=1)
    pr = sub.add_parser("reference")
    pr.add_argument("--psize", type=float, default=REF_PSIZE)
    pr.add_argument("-T", type=float, default=REF_T)
    pr.add_argument("--segment-ms", type=float, default=REF_SEGMENT_MS)
    for p in (*sub.choices.values(),):
        p.add_argument("--device", default=None, help="cpu to run on the CPU (the card otherwise)")
        p.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.mode == "fdcheck":
        row = run_fdcheck(dx=args.dx, T=args.T, window_ms=args.window_ms, rel_eps=args.rel_eps, device=args.device)
    elif args.mode == "witness":
        row = run_witness(psize=args.psize, T=args.T, seed=args.seed, device=args.device)
    elif args.mode == "reference":
        row = run_reference(psize=args.psize, T=args.T, segment_ms=args.segment_ms, device=args.device)
    else:
        row = run_fit(case=args.mode, dx=args.dx, psize=args.psize, T=args.T, dt=args.dt,
                      segment_ms=args.segment_ms, window_ms=args.window_ms, n_iters=args.iters,
                      n_polish=args.polish, lr=args.lr, device=args.device)
    print(json.dumps(row))
    if args.out:
        rows = json.loads(args.out.read_text()) if args.out.exists() else []
        rows.append(row)
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
