#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as it finishes:

1. the card (name and power limit from nvidia-smi), torch and CUDA versions;
2. the kernel build from ``fenicsx_beat_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all started together);
3. each kernel against its plain PyTorch twin on the card, float32, with
   the median time of kernel, twin and the one PyTorch library call that
   computes the same function (where there is one) from CUDA events, and
   the least time the card could take (``bound_ms``):
   - B1-B4 at the shapes of the dx=0.1 Niederer main path (n = 442,401).
     The ionic kernel is held row by row for each TP06 celltype (endo,
     epi, mid): every state's one-step increment (at physiological values
     and with each slow concentration scaled, see
     ``benchmarks/kernel_check.py``), and every state over one paced beat
     of 16,384 cells;
   - B7 and B8 at the shapes of the psize 0.1 LV (n = 243,518): B7 with
     the LV's own transmural layers, held by the same per-row step and beat
     limits for each celltype (nodes of no layer must keep their states
     exactly), B8 on the LV's theta-system operators A and B, timed also
     with its few very long (apex) rows emptied;
4. the kernel checks: the dx=0.5 slab and the psize 0.3 LV, 40 steps each
   through the kernels and through the twins, max |dv| < 1e-2 (the LV's
   window from a shared state at 5 ms, after the stimulated layer's
   upstroke; see ``benchmarks/kernel_check.py:lv_kernel_check``);
5. the LV parity: psize 0.3, Strang, dt=0.05, 30 ms; the probe activation
   times against the JAX package's (float64, CPU), each within one dt;
6. the main path: Niederer dx=0.1, dt=0.05, Strang, 40 ms, through
   ``run_niederer_benchmark``; P1-P9 against the converged published row
   (<= 5%) and against the JAX package's Strang values (each within one
   dt), ms simulated per s, CG iterations and host syncs per step, and
   the launch count of every kernel in that run (B1-B4 must be > 0);
7. the LV path at full width: psize 0.1, Strang, dt=0.05, 30 ms timed,
   through ``benchmarks/lv.py`` (host setup seconds, nodes and cells,
   activated share, probes, ms/s, CG iterations and host syncs per step,
   launch counts; B7 and B8 must be > 0, every state finite, every
   stimulated node activated), then on in 10 ms chunks until more than
   half the nodes fired (150 ms at most; the wave crosses the 1 mm-element
   wall at about one element per 16 ms, so 30 ms is not enough).

Each path runs with every launch count set to 0 just before it and read
just after.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises: the script exits non-zero and prints no result.  It needs a
CUDA card and the repository beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

N_MAIN = 442_401  # nodes of the dx=0.1 Niederer slab
# P1..P9 of the JAX package's fused solver, dx=0.1 dt=0.05 Strang
# (BENCH_r05.json); the port must land within one dt of each.
JAX_STRANG_DX01 = [1.25, 25.80, 31.80, 38.45, 8.10, 26.40, 32.25, 38.55, 18.10]
DT = 0.05
LV_PSIZE, N_LV = 0.1, 243_518  # the full-width LV and its nodes
LV_CHECK_PSIZE = 0.3  # the LV of the kernel check and the parity phase (9,780 nodes)
LV_T = 30.0  # the timed LV horizon (ms)
LV_T_MAX = 150.0  # the LV run goes on in 10 ms chunks until half the nodes fired
# Probe activation times (ms) of the JAX package's fused solver on the LV of
# psize 0.3 (Strang, dt=0.05, 30 ms, float64 on the CPU, its plain path), from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30
# -1 is "not activated" (the mid-wall point: the wave stays in the
# stimulated endocardial layer at this element size, see PERF.md).
JAX_LV_PSIZE03 = {
    "apex_endo": 1.65, "apical_endo": 1.15, "mid_endo": 1.35,
    "basal_endo": 1.65, "base_endo": 1.85, "mid_wall": -1.0,
}
JAX_LV_PSIZE03_ACTIVATED = 0.25  # share of nodes activated by 30 ms, same run
# B2-B4 and B8 kernel vs twin on the card, float32: per output vector,
# max|kernel - twin| / max|twin| (rounding-order noise is ~1e-6).  B1 and
# B7 are held per state row by the limits of benchmarks/kernel_check.py.
REL_TOL = 1e-4
BEAT_CELLS = 16_384  # cells of the ionic kernels' one-beat comparison
LONG_ROW = 64  # B8 rows with more entries than this are timed apart
# H100 SXM data sheet (NVIDIA, dense rates without sparsity): HBM rate and
# float32 peak outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# TP06 GRL operations per node, counted from csrc/tp06.cuh: about 330
# add/mul/div and 66 exp/log/sqrt, each counted as one operation.
TP06_OPS_PER_NODE = 400

SOURCES = {
    "tp06_grl_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl.cu",
                        "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "stencil_spmv_sym": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv_sym.cu",
                         "fenicsx_beat_tpu/ops/pallas_spmv.py:175"),
    "cg_update": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
                  "fenicsx_beat_tpu/ops/pallas_cg.py:41"),
    "axpy": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
             "fenicsx_beat_tpu/ops/pallas_cg.py:124"),
    "tp06_grl_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl_multi.cu",
                              "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "csr_spmv": ("fenicsx_beat_tpu_torch/csrc/csr_spmv.cu",
                 "fenicsx_beat_tpu/ops/pallas_ell.py:170"),
}


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` once and doing ``ops`` float32
    operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_time(fn) -> float | None:
    """``time_ms`` of a PyTorch library call, None (with the reason
    printed) where this build of torch refuses it."""
    try:
        return time_ms(fn)
    except (RuntimeError, NotImplementedError) as exc:
        print(f"[kernels]   library call refused: {type(exc).__name__}: {str(exc)[:200]}")
        return None


def sparse_mv(S, x):
    """The library SpMV: ``torch.mv`` on a sparse CSR tensor."""
    import torch

    return torch.mv(S, x)


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


def row(err, ms, plain_ms, bound_ms_by, library_ms) -> dict:
    (abs_err, rel_err), (bound_ms, bound_by) = err, bound_ms_by
    return {"max_abs_err": abs_err, "rel_err": rel_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def print_rows(rows: dict) -> None:
    import numpy as np

    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernels] {name}: max_abs_err={r['max_abs_err']:.3e} max_rel_err={r['rel_err']:.3e} "
              f"kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        require(np.isfinite(r["max_abs_err"]), f"{name} output is finite")


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


def stencil_csr(vals, pos, n):
    """The symmetric stencil operator ``(pos, vals)`` as a torch sparse CSR
    tensor on the card (B2's library yardstick)."""
    import torch

    r = torch.arange(n, device=vals.device)
    rows, cols, data = [], [], []
    for k, d in enumerate(pos):
        m = n - d
        rows.append(r[:m])
        cols.append(r[:m] + d)
        data.append(vals[k, :m])
        if d > 0:
            rows.append(r[:m] + d)
            cols.append(r[:m])
            data.append(vals[k, :m])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(data), (n, n)).coalesce().to_sparse_csr()


def phase_kernels(seed: int = 0) -> dict:
    """B1-B4 against their twins at the Niederer main path's shapes;
    returns per-kernel rows for the final JSON."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ode, cuda_spmv

    tic = time.perf_counter()
    solver = _build_solver(dx=0.1, theta=0.5, device=DEVICE)
    n = solver.V.ndofs
    require(n == N_MAIN, f"dx=0.1 slab has {N_MAIN} nodes (got {n})")
    A, _, minv = solver._operators(DT)
    pos = solver._pos
    print(f"[kernels] dx=0.1 operators: n={n}, Kp={len(pos)} offsets {pos}, "
          f"host setup {time.perf_counter() - tic:.1f} s")

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(solver.dtype).contiguous()

    rows = {}
    f32 = 4

    # B1, for each celltype: one step at main-path shapes from perturbed
    # states with V over the whole action-potential range, every state row
    # held by its increment, at both dt and also with each slow
    # concentration scaled so float32 resolves their increments; then one
    # paced beat of BEAT_CELLS cells, every row held by its excursion.
    init = tp06.init_state_values()
    states = np.tile(init[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((19, n)))
    states[0] = rng.uniform(-90.0, 40.0, n)
    S0 = on_card(states)
    v = on_card(rng.uniform(-90.0, 40.0, n))
    names = tp06._STATE_NAMES
    step_abs, step_err = 0.0, torch.zeros(19, dtype=torch.float64, device=dev)
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS))
                    * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))
    for ct in kc.CELLTYPES:
        params = tp06.init_parameter_values(stim_amplitude=0.0, celltype=ct)
        ct_err = torch.zeros(19, dtype=torch.float64, device=dev)
        for label, S in kc.step_check_states(S0):
            for dt in (0.025, 0.05):
                a, e = kc.ionic_step_errors(
                    cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, S, v, 1.0, dt, params
                )
                step_abs, ct_err = max(step_abs, a), torch.maximum(ct_err, e)
        print(f"[kernels] tp06_grl_step_v one step, celltype {ct:g}, all state sets and dt: per row "
              "|k-w| beyond 1 ulp / max|increment|: "
              + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, ct_err)))
        require(bool((ct_err <= kc.IONIC_STEP_TOL).all()),
                f"tp06_grl_step_v one-step increments agree with its twin, celltype {ct:g} "
                f"(<= {kc.IONIC_STEP_TOL})")
        step_err = torch.maximum(step_err, ct_err)
        tic = time.perf_counter()
        beat_abs, beat_err = kc.ionic_beat_errors(
            cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, beat0,
            tp06.init_parameter_values(celltype=ct),
        )
        print(f"[kernels] tp06_grl_step_v one beat, celltype {ct:g} ({BEAT_CELLS} cells, "
              f"{kc.BEAT_STEPS} steps of {kc.BEAT_DT} ms, {time.perf_counter() - tic:.1f} s), "
              f"max|k-w| {beat_abs:.3e}; per row max|k-w| / max excursion: "
              + " ".join(f"{nm}={float(e):.2e}" for nm, e in zip(names, beat_err)))
        require(bool((beat_err <= kc.IONIC_BEAT_TOL).all()),
                f"tp06_grl_step_v agrees with its twin over one beat, celltype {ct:g} "
                f"(<= {kc.IONIC_BEAT_TOL})")
    scratch = S0.clone()
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    rows["tp06_grl_step_v"] = row(
        (step_abs, float(step_err.max())),
        time_ms(lambda: cuda_ode.tp06_grl_step_v(scratch, v, 1.0, 0.025, params)),
        time_ms(lambda: cuda_ode.tp06_grl_step_v_twin(scratch, v, 1.0, 0.025, params)),
        bound((2 * 19 + 1) * n * f32, TP06_OPS_PER_NODE * n),
        None,
    )

    # B2 (with its dot) on the main path's theta-system operator
    kp = len(pos)
    x = on_card(rng.uniform(-90.0, 40.0, n))
    yk, dk = cuda_spmv.stencil_spmv_sym_dot(A, x, pos)
    yt, dt_ = cuda_spmv.stencil_spmv_sym_dot_twin(A, x, pos)
    yk2 = cuda_spmv.stencil_spmv_sym(A, x, pos)
    S_A = stencil_csr(A, pos, n)
    rows["stencil_spmv_sym"] = row(
        compare([yk, yk2, dk], [yt, yt, dt_]),
        time_ms(lambda: cuda_spmv.stencil_spmv_sym_dot(A, x, pos)),
        time_ms(lambda: cuda_spmv.stencil_spmv_sym_dot_twin(A, x, pos)),
        bound((kp + 2) * n * f32, 2 * (2 * kp - 1) * n + 2 * n),
        library_time(lambda: sparse_mv(S_A, x)),
    )
    if rows["stencil_spmv_sym"]["library_ms"] is not None:
        require(float((sparse_mv(S_A, x) - yt).abs().max()) <= REL_TOL * float(yt.abs().max()),
                "the library SpMV of B2's operator computes the same y")

    # B3 and B4 on random vectors, the main path's Jacobi preconditioner
    xv, r, p, ap = (on_card(rng.standard_normal(n)) for _ in range(4))
    alpha = on_card(np.float32(0.37)).reshape(())
    beta = on_card(np.float32(0.61)).reshape(())
    outk = cuda_cg.cg_update(xv, r, p, ap, minv, alpha)
    outt = cuda_cg.cg_update_twin(xv, r, p, ap, minv, alpha)
    rows["cg_update"] = row(
        compare(outk, outt),
        time_ms(lambda: cuda_cg.cg_update(xv, r, p, ap, minv, alpha)),
        time_ms(lambda: cuda_cg.cg_update_twin(xv, r, p, ap, minv, alpha)),
        bound(8 * n * f32, 10 * n),
        None,
    )
    rows["axpy"] = row(
        compare([cuda_cg.axpy(xv, p, beta)], [cuda_cg.axpy_twin(xv, p, beta)]),
        time_ms(lambda: cuda_cg.axpy(xv, p, beta)),
        time_ms(lambda: cuda_cg.axpy_twin(xv, p, beta)),
        bound(3 * n * f32, 2 * n),
        library_time(lambda: torch.addcmul(xv, beta, p)),
    )
    torch.cuda.synchronize()
    print_rows(rows)
    dev_us = {
        "tp06_grl_step_v": device_us_per_call(lambda: cuda_ode.tp06_grl_step_v(scratch, v, 1.0, 0.025, params)),
        "stencil_spmv_sym": device_us_per_call(lambda: cuda_spmv.stencil_spmv_sym_dot(A, x, pos)),
        "cg_update": device_us_per_call(lambda: cuda_cg.cg_update(xv, r, p, ap, minv, alpha)),
        "axpy": device_us_per_call(lambda: cuda_cg.axpy(xv, p, beta)),
    }
    print("[kernels] device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    for name in ("stencil_spmv_sym", "cg_update", "axpy"):
        require(rows[name]["rel_err"] <= REL_TOL,
                f"{name} agrees with its twin (rel {rows[name]['rel_err']:.3e} <= {REL_TOL})")
    return rows


def phase_lv_setup():
    """The full-width LV solver (psize 0.1) on the card, its host setup timed."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import build_lv_solver, lv_probe_points

    tic = time.perf_counter()
    solver = build_lv_solver(
        psize=LV_PSIZE, device=DEVICE, precond="jacobi",
        probe_points=list(lv_probe_points(LV_PSIZE).values()),
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - tic
    n = solver.V.ndofs
    model = solver._multi[0]
    print(f"[lv] psize {LV_PSIZE}: n={n} nodes, {solver.mesh.num_cells} cells, layers "
          f"(model index: count) {torch.bincount(model.long() + 1).tolist()[1:]}, "
          f"{solver._mass.nnz} operator entries, host setup {setup:.1f} s")
    require(n == N_LV, f"psize {LV_PSIZE} LV has {N_LV} nodes (got {n})")
    return solver, setup


def phase_lv_kernels(solver, seed: int = 1) -> dict:
    """B7 and B8 against their twins at the full-width LV's shapes."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_ell, cuda_ode

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    n = solver.V.ndofs
    f32 = 4

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32).contiguous()

    rows = {}
    names = tp06._STATE_NAMES
    layer_of = {i: f"celltype {CELLTYPES[m]:g}" for i, m in enumerate(sorted(CELLTYPES))}

    # B7: the LV's own layer index, every 97th node moved to "no layer"
    model, table = solver._multi
    model = model.clone()
    model[::97] = -1
    groups = {name: torch.nonzero(model == i).flatten() for i, name in layer_of.items()}
    groups["no layer"] = torch.nonzero(model < 0).flatten()

    def b7(S, v, t, dt, p):
        return cuda_ode.tp06_grl_multi_step_v(S, v, model, t, dt, p)

    def b7_twin(S, v, t, dt, p):
        return cuda_ode.tp06_grl_multi_step_v_twin(S, v, model, t, dt, p)

    init = tp06.init_state_values()
    states = np.tile(init[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((19, n)))
    states[0] = rng.uniform(-90.0, 40.0, n)
    S0 = on_card(states)
    v = on_card(rng.uniform(-90.0, 40.0, n))
    step_abs, step_err = 0.0, {g: torch.zeros(19, dtype=torch.float64, device=dev) for g in groups}
    for _, S in kc.step_check_states(S0):
        for dt in (0.025, 0.05):
            out = kc.ionic_step_errors_by_group(b7, b7_twin, S, v, 1.0, dt, table, groups)
            for g, (a, e) in out.items():
                if g == "no layer":
                    require(a == 0.0, "B7 leaves the nodes of no layer as they were, V injected")
                    continue
                step_abs = max(step_abs, a)
                step_err[g] = torch.maximum(step_err[g], e)
    for g in layer_of.values():
        print(f"[kernels] tp06_grl_multi_step_v one step, {g} ({groups[g].numel()} nodes), all "
              "state sets and dt: per row |k-w| beyond 1 ulp / max|increment|: "
              + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, step_err[g])))
        require(bool((step_err[g] <= kc.IONIC_STEP_TOL).all()),
                f"tp06_grl_multi_step_v one-step increments agree with its twin, {g}")

    # one paced beat of BEAT_CELLS cells spread evenly over the LV, each
    # with its own layer's parameter set (the model's own pacing on)
    sample = torch.as_tensor(np.linspace(0, n - 1, BEAT_CELLS).astype(np.int64), device=dev)
    model_b = solver._multi[0][sample].contiguous()
    table_b = on_card(np.stack([tp06.init_parameter_values(celltype=CELLTYPES[m])
                                for m in sorted(CELLTYPES)]))
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS))
                    * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))
    beat_groups = {name: torch.nonzero(model_b == i).flatten() for i, name in layer_of.items()}
    tic = time.perf_counter()
    beat = kc.ionic_beat_errors_by_group(
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v(S, v, model_b, t, dt, p),
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v_twin(S, v, model_b, t, dt, p),
        beat0, table_b, beat_groups,
    )
    beat_s = time.perf_counter() - tic
    for g, (a, e) in beat.items():
        print(f"[kernels] tp06_grl_multi_step_v one beat, {g} ({beat_groups[g].numel()} of "
              f"{BEAT_CELLS} cells, {beat_s:.1f} s for all), max|k-w| {a:.3e}; per row max|k-w| / "
              "max excursion: " + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e)))
        require(bool((e <= kc.IONIC_BEAT_TOL).all()),
                f"tp06_grl_multi_step_v agrees with its twin over one beat, {g}")
    scratch = S0.clone()
    rows["tp06_grl_multi_step_v"] = row(
        (step_abs, max(float(e.max()) for e in step_err.values())),
        time_ms(lambda: b7(scratch, v, 1.0, 0.025, table)),
        time_ms(lambda: b7_twin(scratch, v, 1.0, 0.025, table)),
        bound((2 * 19 + 2) * n * f32, TP06_OPS_PER_NODE * n),
        None,
    )

    # B8 on the LV's theta-system operators
    A, B, _ = solver._operators(DT)
    x = on_card(rng.uniform(-90.0, 40.0, n))
    ys_k = [cuda_ell.csr_spmv(op, x) for op in (A, B)]
    ys_t = [cuda_ell.csr_spmv_twin(op, x) for op in (A, B)]
    S_A = torch.sparse_csr_tensor(A.indptr, A.cols, A.vals, A.shape)
    lengths = (A.indptr[1:] - A.indptr[:-1]).cpu().numpy()
    long_rows = np.nonzero(lengths > LONG_ROW)[0]
    # the same operator with its long rows emptied: what they cost the kernel
    keep = torch.as_tensor(np.repeat(lengths <= LONG_ROW, lengths), device=dev)
    short_len = torch.as_tensor(np.where(lengths <= LONG_ROW, lengths, 0), device=dev)
    indptr_s = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr_s[1:] = torch.cumsum(short_len, 0).to(torch.int32)
    A_short = cuda_ell.CSRMatrix(indptr=indptr_s, cols=A.cols[keep].contiguous(),
                                 vals=A.vals[keep].contiguous(), shape=A.shape)
    rows["csr_spmv"] = row(
        compare(ys_k, ys_t),
        time_ms(lambda: cuda_ell.csr_spmv(A, x)),
        time_ms(lambda: cuda_ell.csr_spmv_twin(A, x)),
        bound(A.nnz * 2 * f32 + (n + 1) * f32 + 2 * n * f32, 2 * A.nnz),
        library_time(lambda: sparse_mv(S_A, x)),
    )
    dev_us = {"full": device_us_per_call(lambda: cuda_ell.csr_spmv(A, x)),
              "short": device_us_per_call(lambda: cuda_ell.csr_spmv(A_short, x)),
              "b7": device_us_per_call(lambda: b7(scratch, v, 1.0, 0.025, table))}
    if rows["csr_spmv"]["library_ms"] is not None:
        require(float((sparse_mv(S_A, x) - ys_t[0]).abs().max()) <= REL_TOL * float(ys_t[0].abs().max()),
                "the library SpMV of B8's operator computes the same y")
    print(f"[kernels] csr_spmv: n={n}, {A.nnz} entries, row length max {int(lengths.max())}, "
          f"mean {lengths.mean():.2f}; {long_rows.size} rows longer than {LONG_ROW} "
          f"({int(lengths[long_rows].sum())} entries): device time {dev_us['full']:.2f} us with "
          f"them, {dev_us['short']:.2f} us with them emptied (torch.profiler)")
    print(f"[kernels] tp06_grl_multi_step_v: device time {dev_us['b7']:.2f} us per call (torch.profiler)")
    torch.cuda.synchronize()
    print_rows(rows)
    require(rows["csr_spmv"]["rel_err"] <= REL_TOL,
            f"csr_spmv agrees with its twin (rel {rows['csr_spmv']['rel_err']:.3e} <= {REL_TOL})")
    return rows


def phase_kernel_checks() -> None:
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import kernel_check, lv_kernel_check

    out = kernel_check(dx=0.5, dt=DT, n_steps=40, device=DEVICE)
    print(f"[kernel_check] {json.dumps(out)}")
    require(out["max_abs_dev"] < out["threshold"], "dx=0.5 kernel check max|dv| < 1e-2")
    out = lv_kernel_check(psize=LV_CHECK_PSIZE, dt=DT, n_steps=40, device=DEVICE)
    print(f"[kernel_check] {json.dumps(out)}")
    require(out["max_abs_dev"] < out["threshold"], f"psize {LV_CHECK_PSIZE} LV kernel check max|dv| < 1e-2")


def phase_lv_parity() -> None:
    from fenicsx_beat_tpu_torch.benchmarks.lv import run_lv

    res = run_lv(psize=LV_CHECK_PSIZE, dt=DT, T=LV_T, device=DEVICE, precond="jacobi")
    dev = {k: abs(res.probes[k] - v) for k, v in JAX_LV_PSIZE03.items()}
    print(f"[lv_parity] psize {LV_CHECK_PSIZE}: n={res.n_nodes}, probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items())
          + "; |probe - JAX| " + ", ".join(f"{k}={d:.3f}" for k, d in dev.items())
          + f"; activated share {res.activated_share:.4f} (JAX {JAX_LV_PSIZE03_ACTIVATED}), "
          f"layers {res.layer_nodes}")
    require(res.all_finite, "psize 0.3 LV states finite")
    require(max(dev.values()) <= DT + 1e-6, "LV probe activation times within one dt of the JAX values")


def zero_launches(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def kernel_wrappers() -> dict:
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ell, cuda_ode, cuda_spmv

    return {
        "tp06_grl_step_v": cuda_ode.tp06_grl_step_v,
        "stencil_spmv_sym": cuda_spmv.stencil_spmv_sym,
        "cg_update": cuda_cg.cg_update,
        "axpy": cuda_cg.axpy,
        "tp06_grl_multi_step_v": cuda_ode.tp06_grl_multi_step_v,
        "csr_spmv": cuda_ell.csr_spmv,
    }


def phase_main_path() -> dict:
    import math

    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE)
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
    for name in ("tp06_grl_step_v", "stencil_spmv_sym", "cg_update", "axpy"):
        require(launches[name] > 0, f"{name} launched on the main path")
    return launches


def phase_lv_path(solver, setup_s: float) -> dict:
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import run_lv_solver

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_lv_solver(solver, LV_PSIZE, T=LV_T, dt=DT, setup_s=setup_s)
    launches = {name: w.launches for name, w in wrappers.items()}
    stimulated = solver._b_units[0] > 0
    stim_share = float(stimulated.double().mean())
    fired = bool((solver.activation_time[stimulated] >= 0).all())
    print(f"[lv] psize {LV_PSIZE} Strang dt={DT} {res.simulated_ms:g} ms: n={res.n_nodes} nodes, "
          f"{res.n_cells} cells, layers {res.layer_nodes}, host setup {res.setup_s:.1f} s")
    print(f"[lv] activated share {res.activated_share:.4f} (stimulated ENDO nodes: share "
          f"{stim_share:.4f}, all fired: {fired}); probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items()))
    print(f"[lv] ms_per_s={res.ms_per_second:.3f} (wall {res.wall_s:.3f} s), steps={res.n_steps}, "
          f"cg_iters max={res.cg_iters_max} mean={res.cg_iters_mean:.3f}, "
          f"host_syncs_per_step={res.host_syncs_per_step:.3f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[lv] launches {json.dumps(launches)}")
    require(res.all_finite, "every LV state finite")
    require(fired, "every stimulated endocardial node activated")
    for name in ("tp06_grl_multi_step_v", "csr_spmv"):
        require(launches[name] > 0, f"{name} launched on the LV path")
    # the wave through the wall: on in 10 ms chunks until half the nodes fired
    t, share = res.simulated_ms, res.activated_share
    shares = [(t, share)]
    while share <= 0.5 and t < LV_T_MAX - 1e-9:
        more = run_lv_solver(solver, LV_PSIZE, T=10.0, dt=DT, t0=t)
        t, share = t + more.simulated_ms, more.activated_share
        shares.append((t, share))
        require(more.all_finite, "every LV state finite")
    print("[lv] activated share by time: " + ", ".join(f"{a:g} ms {b:.4f}" for a, b in shares))
    require(share > 0.5, f"more than half of the LV's nodes activated by {LV_T_MAX:g} ms")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (ROOT / "fenicsx_beat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    tic = time.perf_counter()
    device = phase_device()
    phase_build()
    rows = phase_kernels()
    lv_solver, lv_setup = phase_lv_setup()
    rows.update(phase_lv_kernels(lv_solver))
    phase_kernel_checks()
    phase_lv_parity()
    launches = phase_main_path()
    lv_launches = phase_lv_path(lv_solver, lv_setup)
    for name in ("tp06_grl_multi_step_v", "csr_spmv"):
        launches[name] = lv_launches[name]

    kernels = []
    for name, r in rows.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(f"[done] {time.perf_counter() - tic:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
