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
     of 16,384 cells (the twin's step replayed as a CUDA graph).  B1's
     per-node form for TP06 at the same shapes: a uniform parameter field
     gives B1's bits exactly, a field of mixed celltypes is held by the
     same one-step limits;
   - B7 and B8 at the shapes of the psize 0.1 LV (n = 243,518): B7 with
     the LV's own transmural layers, held by the same per-row step and beat
     limits for each celltype (nodes of no layer must keep their states
     exactly), B8 on the LV's theta-system operators A and B, timed also
     with its few very long (apex) rows emptied;
   - ToR-ORd dynCl, the single-cell steady states first: 2 beats at BCL
     1000 ms, dt 0.05, for each celltype, through ``get_steady_state`` on
     the card (B1 with one node), held to the JAX package's float64 states
     (V within 1 mV, every other state within 2% of its value, or both
     below float32's normal range); then ToR-ORd's B1, its per-node form
     and B7 at the psize 0.1 LV's shapes (n = 243,518; B7 with the LV's
     own layers), held per state row and celltype by the one-step limits
     (each slow row scaled) and over one paced beat of 4,096 cells; B1's
     per-node form on a uniform field gives B1's bits;
4. the kernel checks: the dx=0.5 slab and the psize 0.3 LV, 40 steps each
   through the kernels and through the twins, max |dv| < 1e-2 (the LV's
   window from a shared state at 5 ms, after the stimulated layer's
   upstroke; see ``benchmarks/kernel_check.py:lv_kernel_check``);
5. the LV parity: psize 0.3, Strang, dt=0.05, 30 ms; the probe activation
   times against the JAX package's (float64, CPU), each within one dt, with
   TP06 layers and with ToR-ORd layers (from ``init_state_values()``);
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
   wall at about one element per 16 ms, so 30 ms is not enough); once with
   TP06 layers and once in the demo's own configuration, ToR-ORd layers
   from the pre-paced steady states (pre-pacing seconds reported beside
   the host setup);
   - the slab demo (``demos/slab.py``): the dx=0.05 ToR-ORd bar, 20 ms,
     through ``benchmarks/slab.py``; both probes within one dt of the JAX
     package's, the conduction velocity reported;
   - the per-node parameter paths: the main path's solver for 2 ms with
     its TP06 parameters as a uniform node-aligned field, and the
     pre-paced ToR-ORd LV for 10 ms with its layers as a per-node field
     (each node its layer's parameters), each against the same run on its
     vector or table: every state and activation time equal;
8. the ECG setup (host seconds by part): the dx=0.1 slab's recovery
   operators with the Niederer conductivity tensor, and the dx=0.05 slab
   (3,449,001 nodes, 20,160,000 tets) with its 10 electrodes;
9. B5 and B6, plain and with the dot, against the twin they share on both
   slabs' mass and stiffness tables (n = 442,401 and 3,449,001), each timed
   at both sizes (the plain form five times, for the spread) beside the
   library's CSR product of the same operator;
10. ECG Configuration 1: the dx=0.1 Strang slab for 40 ms with a pseudo-ECG
   frame every 1 ms (B5), through ``benchmarks/ecg_scale.py:run_niederer_ecg``,
   on the kernels and on the twins, and once more on the twins with the PDE
   SpMV summed in another order (the float32 noise); CG iterations, host
   syncs and seconds per frame, the 12-lead extremes, and every lead of the
   kernel run held to the twin run;
11. ECG Configuration 2: the JAX package's production run, dx=0.05, 10
   frames of a moving wavefront (B6), through ``run_ecg_scale``; every
   frame converged, every potential finite, ``lead_I_sample`` within 1e-2
   of the JAX package's value.

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
# The same with ToR-ORd dynCl layers from init_state_values() (the demo's
# model, unpaced), from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30 --model torord_dyncl
JAX_TORORD_LV_PSIZE03 = {
    "apex_endo": 2.05, "apical_endo": 1.3, "mid_endo": 1.65,
    "basal_endo": 2.5, "base_endo": 3.75, "mid_wall": -1.0,
}
JAX_TORORD_LV_PSIZE03_ACTIVATED = 0.25
# The slab demo (dx=0.05 bar, 3,636 nodes, 20 ms): activation times (ms) at
# x = 0.3 and 0.7, float64 on the CPU, from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --slab 0.05 -T 20
SLAB_DX, N_SLAB, SLAB_T = 0.05, 3_636, 20.0
JAX_SLAB_PROBES = (5.85, 13.025)
# Each ToR-ORd celltype's single-cell state after 2 beats at BCL 1000 ms,
# dt 0.05, paced from init_state_values() (the LV demo's pre-pacing), the
# JAX package's get_steady_state in float64 on the CPU, from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --steady-states
JAX_STEADY = {
    0.0: [-89.74885068, 0.01088342482, 7.44625234e-05, 6.491621694e-05, 1.525579339, 1.523324443,
          29.20684039, 29.20681677, 147.7113584, 147.7113173, 12.39695091, 12.39728929, 0.0006516081008,
          0.8473406525, 0.7018690246, 0.8471812091, 0.846917467, 0.0001351006897, 0.5565960612,
          0.3115120545, 0.0008898799527, 0.0004533930986, 0.999671621, 0.5984328311, 0.999671628,
          0.6613665125, 0.0, 0.9999999943, 0.9399234081, 0.9999999943, 0.9998988499, 0.9999843603,
          0.9999999943, 0.9999999943, 0.0004883963483, 0.0008297293795, 0.0006499809868, 0.0007892876346,
          0.9928768341, 0.0002952769926, 9.907866844e-06, 0.244343203, 0.0001586019334, 1.374431654e-76,
          5.199778872e-62],
    1.0: [-89.84978293, 0.0111927239, 6.182545605e-05, 5.441954884e-05, 1.639385211, 1.636166312,
          29.20829056, 29.20827248, 147.6995798, 147.6995448, 12.39134646, 12.39161522, 0.0006375643802,
          0.8491662916, 0.7049603982, 0.8490927914, 0.8489143056, 0.0001325351933, 0.5611599143,
          0.3168161468, 0.00088384235, 0.0004503156103, 0.999677418, 0.9996749111, 0.9996774181,
          0.9996769547, 0.0, 0.9999999945, 0.9344716422, 0.9999999945, 0.9998987954, 0.9999794244,
          0.9999999945, 0.9999999945, 0.0002461879441, 0.0004041809342, 0.0006442620302, 0.0007833071369,
          0.9924685637, 0.0002800207403, 9.344220148e-06, 0.2640908022, 0.0001567874497, 2.648264396e-75,
          6.253816362e-61],
    2.0: [-89.49461391, 0.01470292944, 7.216724804e-05, 6.050883848e-05, 1.582274637, 1.578769883,
          29.21493854, 29.21491737, 147.6598203, 147.6598061, 12.44452716, 12.44489813, 0.0006883489267,
          0.8426668283, 0.6940020149, 0.842407887, 0.8416210338, 0.0001417849322, 0.5354737123,
          0.2769156377, 0.0009052656481, 0.0004612355816, 0.9996566565, 0.532562925, 0.9996566668,
          0.5848432131, 0.0, 0.9999999939, 0.8965725678, 0.9999999939, 0.9995015659, 0.9999298801,
          0.9999999939, 0.9999999939, 0.0003719515007, 0.0007355375436, 0.0007025181036, 0.0008030342444,
          0.9918523551, 0.0009159263064, 3.124387433e-05, 0.3167656376, 0.000163205505, 2.167477826e-65,
          5.207580671e-53],
}
STEADY_V_TOL = 1.0  # mV
STEADY_REL_TOL = 0.02  # every other state, relative to the JAX value
# float32's smallest normal number: d, Jrel_np and Jrel_p rest below it in
# float64 (0, 1e-76 to 1e-53), where float32 holds a denormal or zero
F32_MIN_NORMAL = 1.1754944e-38
# B2-B4 and B8 kernel vs twin on the card, float32: per output vector,
# max|kernel - twin| / max|twin| (rounding-order noise is ~1e-6).  B1 and
# B7 are held per state row by the limits of benchmarks/kernel_check.py.
REL_TOL = 1e-4
BEAT_CELLS = 16_384  # cells of the TP06 ionic kernels' one-beat comparison
TORORD_BEAT_CELLS = 4_096  # cells of the ToR-ORd ionic kernels' one-beat comparisons
LONG_ROW = 64  # B8 rows with more entries than this are timed apart
N_SCALE = 3_449_001  # nodes of the dx=0.05 slab (the ECG scale run)
STENCIL_REPEATS = 5  # timings of B5 and B6 at each size, for their spread
ECG_SCALE_FRAMES = 10
# lead I of the last frame of the JAX package's dx=0.05 run (ECG_SCALE.json,
# float32); a value, not a time
JAX_LEAD_I_SAMPLE = -0.09649090468883514
LEAD_I_REL_TOL = 1e-2
# dx=0.1 pseudo-ECG, kernel run vs twin run: per lead max|diff| / max|twin|.
# Two correct float32 runs differ by up to 1.6e-2 (lead III, the smallest):
# the twins against the twins with the PDE SpMV summed in another order, on
# an H100 (PERF.md); the kernel run sat at 1.1e-2.  The limit is 3x that noise.
ECG_LEAD_TOL = 5e-2
# H100 SXM data sheet (NVIDIA, dense rates without sparsity): HBM rate and
# float32 peak outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# TP06 GRL operations per node, counted from csrc/tp06.cuh: about 330
# add/mul/div and 66 exp/log/sqrt, each counted as one operation.
TP06_OPS_PER_NODE = 400
# ToR-ORd GRL operations per node, counted from csrc/torord.cuh with its
# helpers inlined (each operator and call once): about 1,570
# add/mul/div/compare and 126 exp/log/sqrt/pow.
TORORD_OPS_PER_NODE = 1_700

SOURCES = {
    "tp06_grl_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl.cu",
                        "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "tp06_grl_node_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl_node.cu",
                             "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_grl_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_grl.cu",
                          "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_grl_node_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_grl_node.cu",
                               "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_grl_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_grl_multi.cu",
                                "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
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
    "stencil_spmv": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv.cu",
                     "fenicsx_beat_tpu/ops/pallas_spmv.py:38"),
    "stencil_spmv_window": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv_window.cu",
                            "fenicsx_beat_tpu/ops/pallas_spmv.py:358"),
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

    # B1's per-node form at the same shapes: a uniform field of each
    # celltype gives B1's bits; a field of mixed celltypes is held by the
    # one-step limits in each celltype's nodes
    table = np.stack([tp06.init_parameter_values(stim_amplitude=0.0, celltype=ct) for ct in kc.CELLTYPES])
    for i, ct in enumerate(kc.CELLTYPES):
        uniform = on_card(np.tile(table[i][:, None], (1, n)))
        a, b = S0.clone(), S0.clone()
        cuda_ode.tp06_grl_step_v(a, v, 1.0, DT, table[i])
        cuda_ode.tp06_grl_node_step_v(b, v, 1.0, DT, uniform)
        require(torch.equal(a, b), f"tp06_grl_node_step_v on a uniform field of celltype {ct:g} gives "
                "tp06_grl_step_v's bits")
        del uniform
    cts = rng.integers(0, len(kc.CELLTYPES), n)
    mixed = on_card(table[cts].T)
    node_groups = {f"celltype {ct:g}": torch.as_tensor(np.nonzero(cts == i)[0], device=dev)
                   for i, ct in enumerate(kc.CELLTYPES)}
    node_abs, node_err = 0.0, {g: torch.zeros(19, dtype=torch.float64, device=dev) for g in node_groups}
    for _, S in kc.step_check_states(S0):
        for dt in (0.025, 0.05):
            out = kc.ionic_step_errors_by_group(cuda_ode.tp06_grl_node_step_v, cuda_ode.tp06_grl_step_v_twin,
                                                S, v, 1.0, dt, mixed, node_groups)
            for g, (a, e) in out.items():
                node_abs, node_err[g] = max(node_abs, a), torch.maximum(node_err[g], e)
    for g, e in node_err.items():
        print(f"[kernels] tp06_grl_node_step_v one step, mixed field, {g}, all state sets and dt: per row "
              "|k-w| beyond 1 ulp / max|increment|: " + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e)))
        require(bool((e <= kc.IONIC_STEP_TOL).all()),
                f"tp06_grl_node_step_v one-step increments agree with its twin, {g}")
    rows["tp06_grl_node_step_v"] = row(
        (node_abs, max(float(e.max()) for e in node_err.values())),
        time_ms(lambda: cuda_ode.tp06_grl_node_step_v(scratch, v, 1.0, 0.025, mixed)),
        time_ms(lambda: cuda_ode.tp06_grl_step_v_twin(scratch, v, 1.0, 0.025, mixed)),
        bound((2 * 19 + 1 + 54) * n * f32, TP06_OPS_PER_NODE * n),
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
        "tp06_grl_node_step_v": device_us_per_call(
            lambda: cuda_ode.tp06_grl_node_step_v(scratch, v, 1.0, 0.025, mixed)),
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
    table_np = np.stack([tp06.init_parameter_values(celltype=CELLTYPES[m]) for m in sorted(CELLTYPES)])
    table_b = on_card(table_np)
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS))
                    * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))
    beat_groups = {name: torch.nonzero(model_b == i).flatten() for i, name in layer_of.items()}
    tic = time.perf_counter()
    beat = kc.ionic_beat_errors_by_group(  # the twin's table on the host: its graph needs no copy
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v(S, v, model_b, t, dt, table_b),
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v_twin(S, v, model_b, t, dt, table_np),
        beat0, None, beat_groups,
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


def phase_steady_states() -> tuple[dict, float]:
    """Each ToR-ORd celltype's single-cell steady state on the card (the LV
    demo's pre-pacing, B1 with one node), held to the JAX package's
    float64 states; returns marker -> states and the pacing seconds."""
    import tempfile

    import numpy as np

    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES, PREPACE_BCL, PREPACE_BEATS, lv_steady_states
    from fenicsx_beat_tpu_torch.models import torord_dyncl as tor
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    names = tor._STATE_NAMES
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:  # nothing cached: paced here
        tic = time.perf_counter()
        steady = lv_steady_states(dt=DT, device=DEVICE, outdir=cache)
        seconds = time.perf_counter() - tic
    launches = cuda_ode.torord_grl_step_v.launches
    steps = len(CELLTYPES) * PREPACE_BEATS * len(np.arange(0.0, PREPACE_BCL, DT))
    print(f"[steady] {PREPACE_BEATS} beats at BCL {PREPACE_BCL} ms, dt={DT}, 3 celltypes: {seconds:.2f} s, "
          f"{launches} torord_grl_step_v launches ({1e6 * seconds / steps:.1f} us per step)")
    require(launches == steps, "every pacing step launched torord_grl_step_v")
    for marker, y in steady.items():
        ct = CELLTYPES[marker]
        ref = np.asarray(JAX_STEADY[ct])
        v_gap = abs(y[0] - ref[0])
        tiny = (np.abs(ref) < F32_MIN_NORMAL) & (np.abs(y) < F32_MIN_NORMAL)
        rel = np.where(tiny, 0.0, np.abs(y - ref) / np.maximum(np.abs(ref), 1e-300))
        rel[0] = 0.0
        worst = np.argsort(-rel)[:4]
        print(f"[steady] celltype {ct:g}: |V - V_jax| {v_gap:.4e} mV (limit {STEADY_V_TOL:g}); max relative "
              f"gap of the other states {rel.max():.3e} (limit {STEADY_REL_TOL:g}), largest "
              + ", ".join(f"{names[i]} {rel[i]:.2e}" for i in worst)
              + "; below float32's normal range in both: " + ", ".join(names[i] for i in np.nonzero(tiny)[0]))
        require(np.isfinite(y).all(), f"celltype {ct:g} steady state finite")
        require(v_gap <= STEADY_V_TOL, f"celltype {ct:g} steady V within {STEADY_V_TOL:g} mV of the JAX value")
        require(rel.max() <= STEADY_REL_TOL,
                f"celltype {ct:g} steady states within {STEADY_REL_TOL:g} of the JAX values")
    return steady, seconds


def phase_torord_lv_setup(steady: dict):
    """The demo's own LV at full width: ToR-ORd layers from the pre-paced
    steady states, its host setup timed."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import build_lv_solver, lv_probe_points

    tic = time.perf_counter()
    solver = build_lv_solver(
        psize=LV_PSIZE, device=DEVICE, precond="jacobi", model="torord_dyncl", init_states=steady,
        probe_points=list(lv_probe_points(LV_PSIZE).values()),
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - tic
    print(f"[torord_lv] psize {LV_PSIZE}: n={solver.V.ndofs} nodes, {solver.states.shape[0]} states, "
          f"host setup {setup:.1f} s")
    require(solver.V.ndofs == N_LV and solver._ionic.name == "torord_dyncl", "the ToR-ORd LV at full width")
    return solver, setup


def phase_torord_kernels(solver, seed: int = 3) -> dict:
    """ToR-ORd's B1, its per-node form and B7 against their twins at the
    full-width LV's shapes, B7 with the LV's own layers and table."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import torord_dyncl as tor
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    n = solver.V.ndofs
    S_, NP, f32 = len(tor._STATE_NAMES), len(tor._PARAM_NAMES), 4
    names = tor._STATE_NAMES

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32).contiguous()

    def per_row(e):
        return " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e))

    init = tor.init_state_values()
    states = np.tile(init[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((S_, n)))
    states[0] = rng.uniform(-90.0, 40.0, n)
    S0 = on_card(states)
    v = on_card(rng.uniform(-90.0, 40.0, n))
    table = np.stack([tor.init_parameter_values(i_Stim_Amplitude=0.0, celltype=ct) for ct in kc.CELLTYPES])
    state_sets = kc.step_check_states(S0, "torord_dyncl")
    rows = {}

    # B1 per celltype; its per-node form on each celltype's uniform field
    # gives B1's bits
    b1_abs, b1_err = 0.0, torch.zeros(S_, dtype=torch.float64, device=dev)
    for i, ct in enumerate(kc.CELLTYPES):
        ct_err = torch.zeros(S_, dtype=torch.float64, device=dev)
        for _, S in state_sets:
            for dt in (0.025, 0.05):
                a, e = kc.ionic_step_errors(cuda_ode.torord_grl_step_v, cuda_ode.torord_grl_step_v_twin,
                                            S, v, 1.0, dt, table[i])
                b1_abs, ct_err = max(b1_abs, a), torch.maximum(ct_err, e)
        print(f"[kernels] torord_grl_step_v one step, celltype {ct:g}, all state sets and dt: per row "
              f"|k-w| beyond 1 ulp / max|increment|: {per_row(ct_err)}")
        require(bool((ct_err <= kc.IONIC_STEP_TOL).all()),
                f"torord_grl_step_v one-step increments agree with its twin, celltype {ct:g}")
        b1_err = torch.maximum(b1_err, ct_err)
        uniform = on_card(np.tile(table[i][:, None], (1, n)))
        a, b = S0.clone(), S0.clone()
        cuda_ode.torord_grl_step_v(a, v, 1.0, DT, table[i])
        cuda_ode.torord_grl_node_step_v(b, v, 1.0, DT, uniform)
        require(torch.equal(a, b), f"torord_grl_node_step_v on a uniform field of celltype {ct:g} gives "
                "torord_grl_step_v's bits")
        del uniform

    # the per-node form on a field of mixed celltypes, per celltype's nodes
    cts = rng.integers(0, len(kc.CELLTYPES), n)
    mixed = on_card(table[cts].T)
    groups = {f"celltype {ct:g}": torch.as_tensor(np.nonzero(cts == i)[0], device=dev)
              for i, ct in enumerate(kc.CELLTYPES)}
    node_abs, node_err = 0.0, {g: torch.zeros(S_, dtype=torch.float64, device=dev) for g in groups}
    for _, S in state_sets:
        for dt in (0.025, 0.05):
            out = kc.ionic_step_errors_by_group(cuda_ode.torord_grl_node_step_v, cuda_ode.torord_grl_step_v_twin,
                                                S, v, 1.0, dt, mixed, groups)
            for g, (a, e) in out.items():
                node_abs, node_err[g] = max(node_abs, a), torch.maximum(node_err[g], e)
    for g, e in node_err.items():
        print(f"[kernels] torord_grl_node_step_v one step, mixed field, {g}: per row {per_row(e)}")
        require(bool((e <= kc.IONIC_STEP_TOL).all()), f"torord_grl_node_step_v one-step increments agree, {g}")

    # B7: the LV's own layer index and table, every 97th node in no layer
    index, lv_table = solver._multi
    index = index.clone()
    index[::97] = -1
    layer_of = {i: f"celltype {CELLTYPES[m]:g}" for i, m in enumerate(sorted(CELLTYPES))}
    b7_groups = {name: torch.nonzero(index == i).flatten() for i, name in layer_of.items()}
    b7_groups["no layer"] = torch.nonzero(index < 0).flatten()
    lv_table_np = lv_table.double().cpu().numpy()

    def b7(S, v, t, dt, p):
        return cuda_ode.torord_grl_multi_step_v(S, v, index, t, dt, lv_table)

    def b7_twin(S, v, t, dt, p):
        return cuda_ode.torord_grl_multi_step_v_twin(S, v, index, t, dt, lv_table_np)

    b7_abs, b7_err = 0.0, {g: torch.zeros(S_, dtype=torch.float64, device=dev) for g in layer_of.values()}
    for _, S in state_sets:
        for dt in (0.025, 0.05):
            for g, (a, e) in kc.ionic_step_errors_by_group(b7, b7_twin, S, v, 1.0, dt, None, b7_groups).items():
                if g == "no layer":
                    require(a == 0.0, "torord_grl_multi_step_v leaves the nodes of no layer as they were")
                    continue
                b7_abs, b7_err[g] = max(b7_abs, a), torch.maximum(b7_err[g], e)
    for g, e in b7_err.items():
        print(f"[kernels] torord_grl_multi_step_v one step, {g} ({b7_groups[g].numel()} nodes): per row "
              f"{per_row(e)}")
        require(bool((e <= kc.IONIC_STEP_TOL).all()), f"torord_grl_multi_step_v one-step increments agree, {g}")

    # one paced beat (the model's own stimulus at 0-1 ms) of
    # TORORD_BEAT_CELLS cells per kernel: B1 in endo, the per-node form on
    # a mixed field, B7 on cells spread over the LV in their layers
    m = TORORD_BEAT_CELLS
    beat0 = on_card(np.tile(init[:, None], (1, m)) * (1 + 0.01 * rng.standard_normal((S_, m))))
    paced = np.stack([tor.init_parameter_values(celltype=ct) for ct in kc.CELLTYPES])
    cts_b = rng.integers(0, len(kc.CELLTYPES), m)
    mixed_b = on_card(paced[cts_b].T)
    sample = torch.as_tensor(np.linspace(0, n - 1, m).astype(np.int64), device=dev)
    index_b = solver._multi[0][sample].contiguous()
    paced_layers = np.stack([tor.init_parameter_values(celltype=CELLTYPES[mk]) for mk in sorted(CELLTYPES)])
    paced_layers_b = on_card(paced_layers)
    beats = {
        "torord_grl_step_v": (cuda_ode.torord_grl_step_v, cuda_ode.torord_grl_step_v_twin, paced[0],
                              {"celltype 0": None}),
        "torord_grl_node_step_v": (cuda_ode.torord_grl_node_step_v, cuda_ode.torord_grl_step_v_twin, mixed_b,
                                   {f"celltype {ct:g}": torch.as_tensor(np.nonzero(cts_b == i)[0], device=dev)
                                    for i, ct in enumerate(kc.CELLTYPES)}),
        "torord_grl_multi_step_v": (
            lambda S, v, t, dt, p: cuda_ode.torord_grl_multi_step_v(S, v, index_b, t, dt, paced_layers_b),
            lambda S, v, t, dt, p: cuda_ode.torord_grl_multi_step_v_twin(S, v, index_b, t, dt, paced_layers),
            None, {name: torch.nonzero(index_b == i).flatten() for i, name in layer_of.items()}),
    }
    for name, (step, twin, p, bgroups) in beats.items():
        tic = time.perf_counter()
        out = kc.ionic_beat_errors_by_group(step, twin, beat0, p, bgroups)
        took = time.perf_counter() - tic
        for g, (a, e) in out.items():
            print(f"[kernels] {name} one beat, {g} ({m} cells in all, {kc.BEAT_STEPS} steps of {kc.BEAT_DT} ms, "
                  f"{took:.1f} s), max|k-w| {a:.3e}; per row max|k-w| / max excursion: {per_row(e)}")
            require(bool((e <= kc.IONIC_BEAT_TOL).all()), f"{name} agrees with its twin over one beat, {g}")

    scratch = S0.clone()
    p0 = table[0]
    b1_bytes = (2 * S_ + 1) * n * f32
    rows["torord_grl_step_v"] = row(
        (b1_abs, float(b1_err.max())),
        time_ms(lambda: cuda_ode.torord_grl_step_v(scratch, v, 1.0, 0.025, p0)),
        time_ms(lambda: cuda_ode.torord_grl_step_v_twin(scratch, v, 1.0, 0.025, p0), launches=5, reps=3),
        bound(b1_bytes, TORORD_OPS_PER_NODE * n), None,
    )
    rows["torord_grl_node_step_v"] = row(
        (node_abs, max(float(e.max()) for e in node_err.values())),
        time_ms(lambda: cuda_ode.torord_grl_node_step_v(scratch, v, 1.0, 0.025, mixed)),
        time_ms(lambda: cuda_ode.torord_grl_step_v_twin(scratch, v, 1.0, 0.025, mixed), launches=5, reps=3),
        bound(b1_bytes + NP * n * f32, TORORD_OPS_PER_NODE * n), None,
    )
    rows["torord_grl_multi_step_v"] = row(
        (b7_abs, max(float(e.max()) for e in b7_err.values())),
        time_ms(lambda: b7(scratch, v, 1.0, 0.025, None)),
        time_ms(lambda: b7_twin(scratch, v, 1.0, 0.025, None), launches=5, reps=3),
        bound(b1_bytes + n * 4, TORORD_OPS_PER_NODE * n), None,
    )
    dev_us = {
        "torord_grl_step_v": device_us_per_call(lambda: cuda_ode.torord_grl_step_v(scratch, v, 1.0, 0.025, p0)),
        "torord_grl_node_step_v": device_us_per_call(
            lambda: cuda_ode.torord_grl_node_step_v(scratch, v, 1.0, 0.025, mixed)),
        "torord_grl_multi_step_v": device_us_per_call(lambda: b7(scratch, v, 1.0, 0.025, None)),
    }
    torch.cuda.synchronize()
    print("[kernels] device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    print_rows(rows)
    return rows


def phase_torord_lv_parity() -> None:
    from fenicsx_beat_tpu_torch.benchmarks.lv import run_lv

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_lv(psize=LV_CHECK_PSIZE, dt=DT, T=LV_T, device=DEVICE, precond="jacobi", model="torord_dyncl",
                 prepace=False)
    dev = {k: abs(res.probes[k] - v) for k, v in JAX_TORORD_LV_PSIZE03.items()}
    print(f"[torord_lv_parity] psize {LV_CHECK_PSIZE}, ToR-ORd layers unpaced: n={res.n_nodes}, probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items())
          + "; |probe - JAX| " + ", ".join(f"{k}={d:.3f}" for k, d in dev.items())
          + f"; activated share {res.activated_share:.4f} (JAX {JAX_TORORD_LV_PSIZE03_ACTIVATED}); "
          f"launches {json.dumps({k: w.launches for k, w in wrappers.items() if w.launches})}")
    require(res.all_finite, "psize 0.3 ToR-ORd LV states finite")
    require(wrappers["torord_grl_multi_step_v"].launches > 0, "the ToR-ORd LV runs torord_grl_multi_step_v")
    require(max(dev.values()) <= DT + 1e-6, "ToR-ORd LV probe activation times within one dt of the JAX values")


def phase_slab() -> dict:
    """The slab demo on the card: the dx=0.05 ToR-ORd bar, 20 ms."""
    from fenicsx_beat_tpu_torch.benchmarks.slab import run_slab

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_slab(dx=SLAB_DX, dt=DT, T=SLAB_T, device=DEVICE)
    launches = {name: w.launches for name, w in wrappers.items()}
    gaps = [abs(res.t1 - JAX_SLAB_PROBES[0]), abs(res.t2 - JAX_SLAB_PROBES[1])]
    print(f"[slab] dx={SLAB_DX} bar, n={res.n_nodes}, {res.simulated_ms:g} ms: t(x=0.3)={res.t1:.3f} "
          f"t(x=0.7)={res.t2:.3f} ms (JAX {JAX_SLAB_PROBES[0]}, {JAX_SLAB_PROBES[1]}; gaps {gaps[0]:.3f}, "
          f"{gaps[1]:.3f}); conduction velocity {res.cv_cm_per_ms} cm/ms; activated share "
          f"{res.activated_share:.4f}; host setup {res.setup_s:.2f} s; ms_per_s={res.ms_per_second:.3f}; "
          f"cg_iters max={res.cg_iters_max} mean={res.cg_iters_sum / res.n_steps:.3f}, host_syncs_per_step="
          f"{res.host_syncs / res.n_steps:.3f}; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    require(res.n_nodes == N_SLAB and res.all_finite, f"the dx={SLAB_DX} bar ({N_SLAB} nodes), states finite")
    require(max(gaps) <= DT + 1e-6, "slab probe activation times within one dt of the JAX values")
    for name in ("torord_grl_step_v", "stencil_spmv_sym", "cg_update", "axpy"):
        require(launches[name] > 0, f"{name} launched on the slab path")
    return launches


def field_solver(solver, ode_fun, field, states):
    """``solver``'s configuration with the ionic step ``ode_fun``, its
    parameters the node-aligned field ``field`` (NP, n) and the states
    ``states`` (S, n), both numpy."""
    import dataclasses

    return dataclasses.replace(solver, ode_fun=ode_fun, init_states=states, parameters=field, v_index=0,
                               ode_markers=None)


def phase_node_paths(lv_solver, t0: float) -> dict:
    """B1's per-node form on the two main paths: the Niederer solver with
    its TP06 vector as a uniform field (2 ms), and the ToR-ORd LV from its
    state at ``t0`` with its layers as a per-node field (10 ms); each run
    against the same run on its vector or table, every state and
    activation time equal."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.models import torord_dyncl as tor

    wrappers = kernel_wrappers()
    launches = {}
    # TP06: the main path's configuration
    ref = _build_solver(dx=0.1, theta=0.5, device=DEVICE)
    n = ref.V.ndofs
    fld = field_solver(ref, tp06.generalized_rush_larsen, np.tile(ref._params[:, None], (1, n)),
                       ref.states.double().cpu().numpy())
    ref.solve((0.0, 2.0), dt=DT)
    zero_launches(wrappers)
    fld.solve((0.0, 2.0), dt=DT)
    launches["tp06_grl_node_step_v"] = wrappers["tp06_grl_node_step_v"].launches
    same = torch.equal(fld.states, ref.states) and torch.equal(fld.activation_time, ref.activation_time)
    print(f"[node_paths] Niederer dx=0.1, TP06 parameters as a uniform ({fld._node_params.shape[0]}, {n}) field, "
          f"2 ms: states and activation times equal to the vector run: {same}; "
          f"max|dV| {float((fld.v - ref.v).abs().max()):.3e}; tp06_grl_node_step_v launches "
          f"{launches['tp06_grl_node_step_v']}, tp06_grl_step_v {wrappers['tp06_grl_step_v'].launches}")
    require(same, "the Niederer run on a uniform TP06 field equals the run on the vector")
    require(launches["tp06_grl_node_step_v"] > 0 and wrappers["tp06_grl_step_v"].launches == 0,
            "the field run launched tp06_grl_node_step_v and not tp06_grl_step_v")
    del ref, fld

    # ToR-ORd: the LV's layers as a per-node field, from the LV's state
    index, table = lv_solver._multi
    field = table.index_select(0, index.long()).T.double().cpu().numpy()
    fld = field_solver(lv_solver, tor.generalized_rush_larsen, field, lv_solver.states.double().cpu().numpy())
    fld.activation_time = lv_solver.activation_time.clone()
    zero_launches(wrappers)  # counted over the field run alone
    res = fld.run_chunk(t0, DT, 200)
    launches["torord_grl_node_step_v"] = wrappers["torord_grl_node_step_v"].launches
    multi_before = wrappers["torord_grl_multi_step_v"].launches
    lv_solver.run_chunk(t0, DT, 200)  # the same window on the layer table
    same = torch.equal(fld.states, lv_solver.states) and torch.equal(fld.activation_time, lv_solver.activation_time)
    print(f"[node_paths] ToR-ORd LV psize {LV_PSIZE}, layers as a ({field.shape[0]}, {field.shape[1]}) field, "
          f"{t0:g} to {res.t:g} ms: states and activation times equal to the B7 run: {same}; max|dV| "
          f"{float((fld.v - lv_solver.v).abs().max()):.3e}; torord_grl_node_step_v launches "
          f"{launches['torord_grl_node_step_v']}, torord_grl_multi_step_v {multi_before} in the field run")
    require(same, "the ToR-ORd LV on its per-node field equals the run on its layer table")
    require(launches["torord_grl_node_step_v"] > 0 and multi_before == 0,
            "the field run launched torord_grl_node_step_v and not torord_grl_multi_step_v")
    return launches


def zero_launches(wrappers: dict) -> None:
    for w in wrappers.values():
        w.launches = 0


def kernel_wrappers() -> dict:
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ell, cuda_ode, cuda_spmv, cuda_stencil

    return {
        "tp06_grl_step_v": cuda_ode.tp06_grl_step_v,
        "tp06_grl_node_step_v": cuda_ode.tp06_grl_node_step_v,
        "torord_grl_step_v": cuda_ode.torord_grl_step_v,
        "torord_grl_node_step_v": cuda_ode.torord_grl_node_step_v,
        "torord_grl_multi_step_v": cuda_ode.torord_grl_multi_step_v,
        "stencil_spmv_sym": cuda_spmv.stencil_spmv_sym,
        "cg_update": cuda_cg.cg_update,
        "axpy": cuda_cg.axpy,
        "tp06_grl_multi_step_v": cuda_ode.tp06_grl_multi_step_v,
        "csr_spmv": cuda_ell.csr_spmv,
        "stencil_spmv": cuda_stencil.stencil_spmv,
        "stencil_spmv_window": cuda_stencil.stencil_spmv_window,
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


def phase_lv_path(solver, setup_s: float, prepace_s: float = 0.0) -> tuple[dict, float]:
    """The full-width LV run on ``solver`` (TP06 layers, or the demo's
    pre-paced ToR-ORd layers); returns the launch counts and the time
    reached."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import run_lv_solver

    tag = "lv" if solver._ionic.name == "tp06" else "torord_lv"
    multi = solver._ionic.multi_step.__name__
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    torch.cuda.reset_peak_memory_stats()
    res = run_lv_solver(solver, LV_PSIZE, T=LV_T, dt=DT, setup_s=setup_s, prepace_s=prepace_s)
    launches = {name: w.launches for name, w in wrappers.items()}
    stimulated = solver._b_units[0] > 0
    stim_share = float(stimulated.double().mean())
    fired = bool((solver.activation_time[stimulated] >= 0).all())
    print(f"[{tag}] psize {LV_PSIZE} Strang dt={DT} {res.simulated_ms:g} ms, {res.model} layers: n={res.n_nodes} "
          f"nodes, {res.n_cells} cells, layers {res.layer_nodes}, host setup {res.setup_s:.1f} s, "
          f"pre-pacing {res.prepace_s:.2f} s")
    print(f"[{tag}] activated share {res.activated_share:.4f} (stimulated ENDO nodes: share "
          f"{stim_share:.4f}, all fired: {fired}); probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items()))
    print(f"[{tag}] ms_per_s={res.ms_per_second:.3f} (wall {res.wall_s:.3f} s), steps={res.n_steps}, "
          f"cg_iters max={res.cg_iters_max} mean={res.cg_iters_mean:.3f}, "
          f"host_syncs_per_step={res.host_syncs_per_step:.3f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{tag}] launches {json.dumps(launches)}")
    require(res.all_finite, "every LV state finite")
    require(fired, "every stimulated endocardial node activated")
    for name in (multi, "csr_spmv"):
        require(launches[name] > 0, f"{name} launched on the LV path")
    # the wave through the wall: on in 10 ms chunks until half the nodes fired
    t, share = res.simulated_ms, res.activated_share
    shares = [(t, share)]
    while share <= 0.5 and t < LV_T_MAX - 1e-9:
        more = run_lv_solver(solver, LV_PSIZE, T=10.0, dt=DT, t0=t)
        t, share = t + more.simulated_ms, more.activated_share
        shares.append((t, share))
        require(more.all_finite, "every LV state finite")
    print(f"[{tag}] activated share by time: " + ", ".join(f"{a:g} ms {b:.4f}" for a, b in shares))
    require(share > 0.5, f"more than half of the LV's nodes activated by {LV_T_MAX:g} ms")
    return launches, t


def general_stencil_csr(offsets, vals, n):
    """The general stencil ``(offsets, [K, n] vals)`` as a torch sparse CSR
    tensor on the card (B5's and B6's library yardstick)."""
    import torch

    r = torch.arange(n, device=vals.device)
    rows, cols, data = [], [], []
    for k, d in enumerate(offsets):
        lo, hi = max(0, -d), min(n, n - d)
        rows.append(r[lo:hi])
        cols.append(r[lo:hi] + d)
        data.append(vals[k, lo:hi])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(idx, torch.cat(data), (n, n)).coalesce().to_sparse_csr()


def phase_ecg_setup():
    """The operators of both ECG configurations, host setup timed: the
    dx=0.1 slab's recovery with the Niederer conductivity tensor (what
    Configuration 1 builds; B5) and Configuration 2's dx=0.05 slab with its
    electrodes (B6)."""
    import resource

    import torch

    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks.ecg_scale import build_ecg_scale
    from fenicsx_beat_tpu_torch.conductivities import default_conductivities, define_conductivity_tensor
    from fenicsx_beat_tpu_torch.ecg import ECGRecovery
    from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry

    tic = time.perf_counter()
    geo = get_3D_slab_geometry(None, dx=0.1, Lx=20.0, Ly=7.0, Lz=3.0)
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))
    main = ECGRecovery(v=fem.Function(fem.functionspace(geo.mesh, ("P", 1))), M=M, device=DEVICE)
    print(f"[ecg_setup] dx=0.1: n={main.V.ndofs}, kernel {main.kernel}, offsets {main.offsets}, "
          f"host setup {time.perf_counter() - tic:.1f} s (assembly {main.setup_s['assembly_s']:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    scale = build_ecg_scale(dx=0.05, device=DEVICE)
    e = scale.ecg
    peak = torch.cuda.max_memory_allocated() / 2**30
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[ecg_setup] dx=0.05: n={scale.V.ndofs}, {scale.n_cells} cells, kernel {e.kernel}, "
          f"clusters {window_spans(e.offsets)}; mesh {scale.mesh_build_s:.1f} s, recovery "
          f"{scale.recovery_setup_s:.1f} s (assembly {e.setup_s['assembly_s']:.1f} s, operators to the "
          f"card {e.setup_s['operators_s']:.1f} s), electrode weights {scale.electrode_weights_s:.1f} s; "
          f"peak device memory {peak:.2f} GiB, peak host memory of the process so far {host_gib:.1f} GiB")
    require(main.V.ndofs == N_MAIN and main.kernel == "B5", f"dx=0.1 recovery: {N_MAIN} nodes on B5")
    require(scale.V.ndofs == N_SCALE and e.kernel == "B6", f"dx=0.05 recovery: {N_SCALE} nodes on B6")
    return main, scale


def window_spans(offsets):
    """B6's offset clusters, as (smallest, largest) offset pairs."""
    from fenicsx_beat_tpu_torch.ops.cuda_stencil import WINDOW_TILE
    from fenicsx_beat_tpu_torch.ops.sparse import offset_clusters

    cl = offset_clusters(offsets, WINDOW_TILE)
    return [(lo, lo + s) for lo, s in zip(cl.lo, cl.span)]


def phase_stencil_kernels(main, scale, seed: int = 2) -> dict:
    """B5 and B6, plain and dot, against their twin on the mass and
    stiffness tables of both ECG configurations (n = 442,401 and 3,449,001),
    each timed at both sizes.  Returns B5's row at 442,401 and B6's at
    3,449,001 (the sizes their paths give them)."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_stencil as cs

    rng = np.random.default_rng(seed)
    kernels = {
        "stencil_spmv": (cs.stencil_spmv, cs.stencil_spmv_dot, cs.stencil_spmv_twin, cs.stencil_spmv_dot_twin),
        "stencil_spmv_window": (cs.stencil_spmv_window, cs.stencil_spmv_window_dot,
                                cs.stencil_spmv_twin, cs.stencil_spmv_dot_twin),
    }
    path_size = {"stencil_spmv": N_MAIN, "stencil_spmv_window": N_SCALE}
    rows = {}
    for ecg in (main, scale.ecg):
        n, offs = ecg.V.ndofs, ecg.offsets
        K = len(offs)
        x = torch.as_tensor(rng.uniform(-90.0, 40.0, n), device=DEVICE).float()
        S = general_stencil_csr(offs, ecg._mT, n)
        lib_ms = library_time(lambda: sparse_mv(S, x))
        if lib_ms is not None:
            y_ref = cs.stencil_spmv_twin(ecg._mT, x, offs)
            require(float((sparse_mv(S, x) - y_ref).abs().max()) <= REL_TOL * float(y_ref.abs().max()),
                    "the library SpMV of the stencil computes the same y")
        del S
        for name, (plain, dot_form, twin, dot_twin) in kernels.items():
            outk, outt = [], []
            for vT in (ecg._mT, ecg._kT):
                yk, dk = dot_form(vT, x, offs)
                yt, dt_ = dot_twin(vT, x, offs)
                outk += [yk, plain(vT, x, offs), dk]
                outt += [yt, yt, dt_]
            b2b_ms = [time_ms(lambda: plain(ecg._mT, x, offs)) for _ in range(STENCIL_REPEATS)]
            r = row(
                compare(outk, outt),
                statistics.median(b2b_ms),
                time_ms(lambda: twin(ecg._mT, x, offs)),
                bound((K + 2) * n * 4, 2 * K * n),
                lib_ms,
            )
            dot_ms = time_ms(lambda: dot_form(ecg._mT, x, offs))
            dev_us = [device_us_per_call(lambda: plain(ecg._mT, x, offs)) for _ in range(STENCIL_REPEATS)]
            dev_dot_us = device_us_per_call(lambda: dot_form(ecg._mT, x, offs))
            print(f"[kernels] {name} at n={n} (K={K}): device time per call (torch.profiler), "
                  f"{STENCIL_REPEATS} repeats: median {statistics.median(dev_us):.2f} us, "
                  f"all {[round(u, 2) for u in dev_us]}; {dev_dot_us:.2f} us with the dot; back to back "
                  f"{STENCIL_REPEATS} repeats {[round(m, 5) for m in b2b_ms]} ms, dot form {dot_ms:.4f} ms")
            print_rows({f"{name} n={n}": r})
            require(r["rel_err"] <= REL_TOL,
                    f"{name} agrees with its twin at n={n} (rel {r['rel_err']:.3e} <= {REL_TOL})")
            if n == path_size[name]:
                rows[name] = r
        torch.cuda.synchronize()
    return rows


def _sym_spmv_other_order(solver) -> None:
    """Route a twin solver's symmetric SpMV through the general stencil twin
    on the unpacked full table: the same operator, its products added in
    another order (what rounding alone puts between two correct runs)."""
    import torch

    from fenicsx_beat_tpu_torch.ops.cuda_stencil import stencil_spmv_twin

    pos = solver._pos
    offs = tuple(sorted({-d for d in pos} | set(pos)))
    tables = {}

    def full(vals):
        if vals.data_ptr() not in tables:
            n = vals.shape[1]
            F = vals.new_zeros(len(offs), n)
            for k, d in enumerate(pos):
                F[offs.index(d)] = vals[k]
                if d > 0:
                    F[offs.index(-d), d:] = vals[k, : n - d]
            tables[vals.data_ptr()] = (vals, F)
        return tables[vals.data_ptr()][1]

    def spmv(vals, x, _pos):
        return stencil_spmv_twin(full(vals), x, offs)

    def spmv_dot(vals, x, _pos):
        y = spmv(vals, x, _pos)
        return y, torch.dot(x, y)

    solver._spmv, solver._spmv_dot = spmv, spmv_dot


def _lead_gaps(a: dict, b: dict) -> dict:
    import numpy as np

    return {k: float(np.abs(np.subtract(a[k], b[k])).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}


def phase_ecg_main() -> dict:
    """Configuration 1: the dx=0.1 Strang slab, 40 ms, a pseudo-ECG frame
    every 1 ms, on the kernels (launches counted) and on the twins; a third
    run on the twins with the PDE SpMV summed in another order measures the
    float32 noise the kernel run is held to."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import niederer
    from fenicsx_beat_tpu_torch.benchmarks.ecg_scale import run_niederer_ecg

    kw = dict(dx=0.1, dt=DT, T=40.0, theta=0.5, frame_ms=1.0, device=DEVICE)
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(wrappers)
    res = run_niederer_ecg(**kw)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    twin = run_niederer_ecg(**kw, use_kernels=False)
    build = niederer._build_solver

    def build_other(*args, **kwargs):
        solver = build(*args, **kwargs)
        _sym_spmv_other_order(solver)
        return solver

    niederer._build_solver = build_other
    try:
        other = run_niederer_ecg(**kw, use_kernels=False)
    finally:
        niederer._build_solver = build

    for tag, r in (("kernels", res), ("twins", twin), ("twins, other order", other)):
        it = np.array(r["cg_iters_per_frame"])
        print(f"[ecg_main] {tag}: {r['n_frames']} frames of {r['frame_ms']:g} ms, kernel {r['kernel']}, "
              f"CG iterations per frame max {it.max()} mean {it.mean():.2f}, all converged "
              f"{all(r['cg_converged_per_frame'])}; host syncs per frame {r['ecg_host_syncs_per_frame']:.2f}; "
              f"ECG s per frame {r['ecg_s_per_frame']:.5f} (pull {r['pull_s_per_frame']:.5f}, solve "
              f"{r['solve_s_per_frame']:.5f} with upload {r['upload_s_per_frame']:.5f}, potentials "
              f"{r['potentials_s_per_frame']:.5f}); simulation {r['simulation_s']:.2f} s; setup: solver "
              f"{r['solver_setup_s']:.1f} s, recovery {r['recovery_setup_s']:.1f} s, weights "
              f"{r['electrode_weights_s']:.2f} s")
    print(f"[ecg_main] CG iterations per frame (kernels): {res['cg_iters_per_frame']}")
    print("[ecg_main] 12-lead extremes (kernels, min/max): " + ", ".join(
        f"{k} {min(v):.4e}/{max(v):.4e}" for k, v in res["leads"].items()))
    gap = _lead_gaps(res["leads"], twin["leads"])
    noise = _lead_gaps(other["leads"], twin["leads"])
    print("[ecg_main] per lead max|kernels - twins| / max|twins|: "
          + ", ".join(f"{k}={v:.2e}" for k, v in gap.items()))
    print("[ecg_main] per lead max|twins other order - twins| / max|twins|: "
          + ", ".join(f"{k}={v:.2e}" for k, v in noise.items()))
    print(f"[ecg_main] max lead gap {max(gap.values()):.3e} (limit {ECG_LEAD_TOL:g}); float32 noise "
          f"{max(noise.values()):.3e}; peak device memory {peak:.2f} GiB; launches {json.dumps(launches)}")
    for r in (res, twin, other):
        require(all(r["cg_converged_per_frame"]), "the ECG's CG converged in every frame")
        require(bool(np.isfinite(r["potentials"]).all()), "every electrode potential finite")
    require(res["kernel"] == "B5", "the dx=0.1 pseudo-ECG runs B5")
    require(launches["stencil_spmv"] > 0, "stencil_spmv launched on the dx=0.1 ECG path")
    require(max(gap.values()) <= ECG_LEAD_TOL,
            f"every lead of the kernel run within {ECG_LEAD_TOL:g} of the twin run (relative)")
    return launches


def phase_ecg_scale(scale) -> dict:
    """Configuration 2: the JAX package's production ECG run, dx=0.05, 10
    frames, on B6."""
    from fenicsx_beat_tpu_torch.benchmarks.ecg_scale import run_ecg_scale

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    out = run_ecg_scale(dx=0.05, n_frames=ECG_SCALE_FRAMES, setup=scale)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"[ecg_scale] {json.dumps(out)}")
    rel = abs(out["lead_I_sample"] - JAX_LEAD_I_SAMPLE) / abs(JAX_LEAD_I_SAMPLE)
    print(f"[ecg_scale] lead_I_sample {out['lead_I_sample']!r}, JAX package {JAX_LEAD_I_SAMPLE!r}: "
          f"relative gap {rel:.3e} (limit {LEAD_I_REL_TOL:g}); launches {json.dumps(launches)}")
    require(out["kernel"] == "B6" and out["n_nodes"] == N_SCALE, "the dx=0.05 ECG runs B6")
    require(all(out["cg_converged_per_frame"]), "the ECG's CG converged in every frame")
    require(out["potentials_finite"], "every electrode potential finite")
    require(rel <= LEAD_I_REL_TOL, f"lead_I_sample within {LEAD_I_REL_TOL:g} of the JAX value")
    require(launches["stencil_spmv_window"] > 0, "stencil_spmv_window launched on the dx=0.05 ECG path")
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
    steady, prepace_s = phase_steady_states()
    torord_lv, torord_lv_setup = phase_torord_lv_setup(steady)
    rows.update(phase_torord_kernels(torord_lv))
    phase_kernel_checks()
    phase_lv_parity()
    phase_torord_lv_parity()
    launches = phase_main_path()
    lv_launches, _ = phase_lv_path(lv_solver, lv_setup)
    for name in ("tp06_grl_multi_step_v", "csr_spmv"):
        launches[name] = lv_launches[name]
    del lv_solver
    torord_launches, t_end = phase_lv_path(torord_lv, torord_lv_setup + prepace_s, prepace_s)
    launches["torord_grl_multi_step_v"] = torord_launches["torord_grl_multi_step_v"]
    launches["torord_grl_step_v"] = phase_slab()["torord_grl_step_v"]
    launches.update(phase_node_paths(torord_lv, t_end))
    del torord_lv
    ecg_main, ecg_scale = phase_ecg_setup()
    rows.update(phase_stencil_kernels(ecg_main, ecg_scale))
    del ecg_main
    launches["stencil_spmv"] = phase_ecg_main()["stencil_spmv"]
    launches["stencil_spmv_window"] = phase_ecg_scale(ecg_scale)["stencil_spmv_window"]

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
