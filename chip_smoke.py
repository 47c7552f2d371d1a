#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as it finishes:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. the kernel build from ``fenicsx_beat_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, at the shapes
   of the dx=0.1 Niederer main path (n = 442,401, float32): max abs and
   max relative difference, and the median time of each from CUDA events.
   The ionic kernel is held row by row: every state's one-step increment
   (at physiological values and with each slow concentration scaled, see
   ``benchmarks/kernel_check.py``), and every state over one paced beat of
   16,384 cells;
4. the kernel check: the dx=0.5 slab for 40 steps through the kernels and
   through the twins, max |dv| < 1e-2;
5. the main path: Niederer dx=0.1, dt=0.05, Strang, 40 ms, through
   ``run_niederer_benchmark``; P1-P9 against the converged published row
   (<= 5%) and against the JAX package's Strang values (each within one
   dt), ms simulated per s, CG iterations and host syncs per step, and
   the launch count of every kernel in that run (each must be > 0).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Any failed phase raises:
the script exits non-zero and prints no result.  It needs a CUDA card and
the repository beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_MAIN = 442_401  # nodes of the dx=0.1 Niederer slab
# P1..P9 of the JAX package's fused solver, dx=0.1 dt=0.05 Strang
# (BENCH_r05.json); the port must land within one dt of each.
JAX_STRANG_DX01 = [1.25, 25.80, 31.80, 38.45, 8.10, 26.40, 32.25, 38.55, 18.10]
DT = 0.05
# B2-B4 kernel vs twin on the card, float32: per output vector,
# max|kernel - twin| / max|twin| (rounding-order noise is ~1e-6).  B1 is
# held per state row by the limits of benchmarks/kernel_check.py.
REL_TOL = 1e-4
BEAT_CELLS = 16_384  # cells of B1's one-beat comparison


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Time per call of ``fn``: CUDA events around ``launches`` calls back
    to back, median of ``reps`` such runs after a warm-up.  This is the
    device timeline per call as a caller issuing calls back to back sees
    it: launch overhead included, operands of L2 size or less warm."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        runs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in runs) / launches


def compare(kernel_out, twin_out) -> tuple[float, float]:
    """(max abs difference, max over rows of max|diff| / max|twin|)."""
    abs_err, rel_err = 0.0, 0.0
    for k, t in zip(kernel_out, twin_out):
        k2 = k.double().reshape(k.shape[0] if k.dim() == 2 else 1, -1)
        t2 = t.double().reshape(k2.shape)
        d = (k2 - t2).abs().amax(dim=-1)
        scale = t2.abs().amax(dim=-1).clamp_min(1e-30)
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / scale).max()))
    return abs_err, rel_err


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }


def phase_build() -> None:
    from fenicsx_beat_tpu_torch._build import load_library

    tic = time.perf_counter()
    kl = load_library()
    print(f"[build] {kl.path.name}: nvcc {kl.build_seconds:.1f} s, "
          f"loaded in {time.perf_counter() - tic:.1f} s")
    for line in kl.compiler_output.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_kernels(seed: int = 0) -> dict:
    """Each kernel against its twin at main-path shapes; returns per-kernel
    rows for the final JSON (launch counts filled in by the main path)."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ode, cuda_spmv

    tic = time.perf_counter()
    solver = _build_solver(dx=0.1, theta=0.5, device="cuda")
    n = solver.V.ndofs
    require(n == N_MAIN, f"dx=0.1 slab has {N_MAIN} nodes (got {n})")
    A, _, minv = solver._operators(DT)
    pos = solver._pos
    print(f"[kernels] dx=0.1 operators: n={n}, Kp={len(pos)} offsets {pos}, "
          f"host setup {time.perf_counter() - tic:.1f} s")

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(solver.dtype).contiguous()

    rows = {}  # name -> ((max abs err, rel err), kernel ms, twin ms)

    # B1: one step at main-path shapes from perturbed states with V over the
    # whole action-potential range, every state row held by its increment,
    # at both dt and also with each slow concentration scaled so float32
    # resolves their increments; then one paced beat of BEAT_CELLS cells,
    # every row held by its excursion.
    init = tp06.init_state_values()
    states = np.tile(init[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((19, n)))
    states[0] = rng.uniform(-90.0, 40.0, n)
    S0 = on_card(states)
    v = on_card(rng.uniform(-90.0, 40.0, n))
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    names = tp06._STATE_NAMES
    step_abs, step_err = 0.0, torch.zeros(19, dtype=torch.float64, device=dev)
    for label, S in kc.step_check_states(S0):
        for dt in (0.025, 0.05):
            a, e = kc.ionic_step_errors(
                cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, S, v, 1.0, dt, params
            )
            print(f"[kernels] tp06_grl_step_v one step, {label}, dt={dt}: per row "
                  "|k-w| beyond 1 ulp / max|increment|: "
                  + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e)))
            step_abs, step_err = max(step_abs, a), torch.maximum(step_err, e)
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS))
                    * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))
    tic = time.perf_counter()
    beat_abs, beat_err = kc.ionic_beat_errors(
        cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, beat0, tp06.init_parameter_values()
    )
    beat_s = time.perf_counter() - tic
    print(f"[kernels] tp06_grl_step_v one beat ({BEAT_CELLS} cells, {kc.BEAT_STEPS} steps of "
          f"{kc.BEAT_DT} ms, {beat_s:.1f} s), max|k-w| {beat_abs:.3e}; per row max|k-w| / max excursion: "
          + " ".join(f"{nm}={float(e):.2e}" for nm, e in zip(names, beat_err)))
    require(bool((step_err <= kc.IONIC_STEP_TOL).all()),
            f"tp06_grl_step_v one-step increments agree with its twin (<= {kc.IONIC_STEP_TOL})")
    require(bool((beat_err <= kc.IONIC_BEAT_TOL).all()),
            f"tp06_grl_step_v agrees with its twin over one beat (<= {kc.IONIC_BEAT_TOL})")
    scratch = S0.clone()
    rows["tp06_grl_step_v"] = (
        (step_abs, float(step_err.max())),
        time_ms(lambda: cuda_ode.tp06_grl_step_v(scratch, v, 1.0, 0.025, params)),
        time_ms(lambda: cuda_ode.tp06_grl_step_v_twin(scratch, v, 1.0, 0.025, params)),
    )

    # B2 (with its dot) on the main path's theta-system operator
    x = on_card(rng.uniform(-90.0, 40.0, n))
    yk, dk = cuda_spmv.stencil_spmv_sym_dot(A, x, pos)
    yt, dt_ = cuda_spmv.stencil_spmv_sym_dot_twin(A, x, pos)
    yk2 = cuda_spmv.stencil_spmv_sym(A, x, pos)
    rows["stencil_spmv_sym"] = (
        compare([yk, yk2, dk], [yt, yt, dt_]),
        time_ms(lambda: cuda_spmv.stencil_spmv_sym_dot(A, x, pos)),
        time_ms(lambda: cuda_spmv.stencil_spmv_sym_dot_twin(A, x, pos)),
    )

    # B3 and B4 on random vectors, the main path's Jacobi preconditioner
    xv, r, p, ap = (on_card(rng.standard_normal(n)) for _ in range(4))
    alpha = on_card(np.float32(0.37)).reshape(())
    beta = on_card(np.float32(0.61)).reshape(())
    outk = cuda_cg.cg_update(xv, r, p, ap, minv, alpha)
    outt = cuda_cg.cg_update_twin(xv, r, p, ap, minv, alpha)
    rows["cg_update"] = (
        compare(outk, outt),
        time_ms(lambda: cuda_cg.cg_update(xv, r, p, ap, minv, alpha)),
        time_ms(lambda: cuda_cg.cg_update_twin(xv, r, p, ap, minv, alpha)),
    )
    rows["axpy"] = (
        compare([cuda_cg.axpy(xv, p, beta)], [cuda_cg.axpy_twin(xv, p, beta)]),
        time_ms(lambda: cuda_cg.axpy(xv, p, beta)),
        time_ms(lambda: cuda_cg.axpy_twin(xv, p, beta)),
    )
    torch.cuda.synchronize()
    for name, ((abs_err, rel_err), ms, plain_ms) in rows.items():
        print(f"[kernels] {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
              f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
        require(np.isfinite(abs_err), f"{name} output is finite")
        if name != "tp06_grl_step_v":  # held per row above
            require(rel_err <= REL_TOL, f"{name} agrees with its twin (rel {rel_err:.3e} <= {REL_TOL})")
    return rows


def phase_kernel_check() -> None:
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import kernel_check

    out = kernel_check(dx=0.5, dt=DT, n_steps=40, device="cuda")
    print(f"[kernel_check] {json.dumps(out)}")
    require(out["max_abs_dev"] < out["threshold"], "dx=0.5 kernel check max|dv| < 1e-2")


def phase_main_path() -> tuple[dict, object]:
    import math

    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ode, cuda_spmv

    wrappers = {
        "tp06_grl_step_v": cuda_ode.tp06_grl_step_v,
        "stencil_spmv_sym": cuda_spmv.stencil_spmv_sym,
        "cg_update": cuda_cg.cg_update,
        "axpy": cuda_cg.axpy,
    }
    for w in wrappers.values():
        w.launches = 0
    res = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device="cuda")
    launches = {name: w.launches for name, w in wrappers.items()}

    print(f"[main] {res.summary()}")
    at = [res.activation_times[f"P{i}"] for i in range(1, 10)]
    require(all(math.isfinite(a) and a >= 0 for a in at), "all nine probes activated")
    dev = [abs(a - b) for a, b in zip(at, JAX_STRANG_DX01)]
    print("[main] |P - P_jax| = " + ", ".join(f"P{i + 1}={d:.3f}" for i, d in enumerate(dev)))
    err = res.error_vs_published()
    print(f"[main] max_rel_err_vs_converged={err:.4%}, ms_per_s={res.ms_per_second:.3f}, "
          f"steps={res.n_steps}, cg_iters max={res.cg_iters_max} mean={res.cg_iters_mean:.3f}, "
          f"host_syncs_per_step={res.host_syncs_per_step:.3f}")
    print(f"[main] launches {json.dumps(launches)}")
    require(err is not None and err <= 0.05, "max error vs the converged published row <= 5%")
    require(max(dev) <= DT + 1e-6, "P1-P9 within one dt of the JAX Strang values")
    for name, count in launches.items():
        require(count > 0, f"{name} launched on the main path")
    return launches, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (ROOT / "fenicsx_beat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    device = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_kernel_check()
    launches, _ = phase_main_path()

    sources = {
        "tp06_grl_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl.cu",
                            "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
        "stencil_spmv_sym": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv_sym.cu",
                             "fenicsx_beat_tpu/ops/pallas_spmv.py:175"),
        "cg_update": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
                      "fenicsx_beat_tpu/ops/pallas_cg.py:41"),
        "axpy": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
                 "fenicsx_beat_tpu/ops/pallas_cg.py:124"),
    }
    kernels = []
    for name, ((abs_err, _), ms, plain_ms) in rows.items():
        source, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
