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
   - FitzHugh-Nagumo's B1, per-node form and B7 at the main path's width
     (n = 442,401; ``benchmarks/kernel_check.py:fhn_checks``): per state
     row, one step with the stimulus on and off, and one paced beat of
     every cell; B7 on make_multi_ode's storage layout (V in row 0);
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
   of the JAX package's value;
12. the bidomain Niederer slab at dx=0.1 (442,401 nodes; TP06's B1, B5 and
   the DCT u-block preconditioner), 5 ms of warm-up and a 10 ms timed
   window through ``benchmarks/bidomain_scale.py:run_slab``: monolithic
   (with the matched monodomain run), Gauss-Seidel (elliptic solve to
   3e-4), and monolithic on the twins; ms/s, CG iterations and host syncs
   per step, setup seconds and peak memory; every state finite and every
   CG converged; the kernel run held to the twin run at every node (v
   within 2e-2 mV, u_e within 3e-4 of its largest magnitude: 3x the
   float32 noise of the kernel run from states one ulp away), its v_max
   within 0.5 mV and its share of nodes with v > 0 within 0.5 percentage
   points; the card's float32 DCT solve within 1e-5 of a float64 host
   solve with TF32 matmuls off and on; B5 timed on the bidomain's operator
   streams;
13. the dx=0.2 bidomain slab (15 ms) and the psize 0.3 LV (Jacobi, B8,
   10 ms) on the kernels: v_max, max|u_e| and the v > 0 share each within
   its float32 tolerance of the JAX package's float64 value (three times
   the field's largest distance over the float32 witnesses of
   ``tests/torch_bidomain_reference.py``), CG iterations per step within 1
   of the witnesses' range; each also on its twins on the card, printed
   beside;
14. ``demos/bidomain_ue.py``'s configuration (nx=48, FHN, Strang, 40 ms):
   every saved (t, v_max, max|u_e|) row within its field's float32
   tolerance of the JAX package's; then the same run with FHN's parameters as a uniform
   node-aligned field (B1's per-node form) and as one marker layer (B7),
   each equal bit for bit to the vector run.

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
# FitzHugh-Nagumo forward-Euler operations per node, counted from
# csrc/fhn.cuh: 25 add/mul/div/neg and 3 compares.
FHN_OPS_PER_NODE = 28
# The bidomain Niederer slab (benchmarks/bidomain_scale.py): dx=0.1 at full
# width, monolithic and Gauss-Seidel (its elliptic solve to 3e-4), 5 ms of
# warm-up and a 10 ms timed window; the kernel run is held to the twin run.
BIDOMAIN_DX = 0.1
BIDOMAIN_GS_U_RTOL = 3e-4
BIDOMAIN_V_MAX_TOL = 0.5  # mV, kernels vs twins at 15 ms
BIDOMAIN_SHARE_TOL = 0.005  # the share of nodes with v > 0, kernels vs twins
# ... and at every node: max|v_k - v_w| (mV) and max|u_e_k - u_e_w| /
# max|u_e_w|, each 3x float32's noise there, which the phase measures and
# prints: the kernel run against itself from states one ulp away read
# 6.46e-3 mV and 8.74e-5 on an H100 (700 W), the wavefront amplifying
# rounding (kernels vs twins: 6.91e-3 mV and 9.49e-5)
BIDOMAIN_V_FIELD_TOL = 2e-2
BIDOMAIN_UE_FIELD_TOL = 3e-4
# CG iterations per 100-step chunk's worst step that the JAX package recorded
# on its dx=0.1 slab (BIDOMAIN_SCALE.json, mean over chunks): iteration
# counts of the same numerics, not times; a count over twice these is a
# finding, not a failure.
JAX_BIDOMAIN_ITERS = {"monolithic": 10.7, "gs": 14.0}
DCT_REL_TOL = 1e-5  # the card's float32 DCT solve vs a float64 host solve
# The JAX package's bidomain in float64 on the CPU, and the tolerances the
# card is held to, from
#   JAX_PLATFORMS=cpu python tests/torch_bidomain_reference.py --slab 0.2 --lv 0.3 --demo
# Each field's tolerance ("tol") is three times its largest distance from
# the float64 value over the port's float32 witnesses on the CPU (the run
# from the initial states and three runs from states moved by one ulp at
# random; the share of nodes with v > 0 to at least three nodes, 3/n): a
# card that rounds within float32's noise passes, a kernel that strays
# further does not.  CG iterations per step are held to the witnesses'
# range ("cg_iters_f32") within 1 (float64 solves to rtol 1e-8, float32 to
# 1e-6, so float64 takes more by construction); "cg_iters_f64" is the
# port's float64 count, whose per-chunk worst steps equal JAX's.
# The dx=0.2 slab (58,176 nodes) at 15 ms:
JAX_BIDOMAIN_SLAB02 = {"v_max": 32.92460214259786, "u_e_max_abs": 16.90570116741482,
                       "v_pos_share": 0.23729716721672167, "n_nodes": 58_176, "chunk_iters": [13, 16, 17],
                       "cg_iters_f64": 13.7, "cg_iters_f32": (8.09, 8.09),
                       "tol": {"v_max": 0.001932953672493909, "u_e_max_abs": 0.009826204270822814,
                               "v_pos_share": 5.156765676567657e-05}}
# The psize 0.3 LV (9,780 nodes), Jacobi, at 10 ms:
JAX_BIDOMAIN_LV03 = {"v_max": 25.371059848996335, "u_e_max_abs": 10.698734203049115,
                     "v_pos_share": 0.6597137014314929, "n_nodes": 9_780, "chunk_iters": [190, 188],
                     "cg_iters_f64": 149.18, "cg_iters_f32": (48.33, 49.485),
                     "tol": {"v_max": 0.0005906645427167234, "u_e_max_abs": 0.029071095381462797,
                             "v_pos_share": 0.00030674846625766873}}
# The demo (nx=48, 2,401 nodes): (t, v_max, max|u_e|) at every save, and
# each field's largest relative distance over every row and witness.
JAX_BIDOMAIN_DEMO_STRAY = {"v_max": 4.402667825734572e-05, "u_e_max_abs": 6.174984329169421e-05}
JAX_BIDOMAIN_DEMO = [
    (2.0, 128.0133864282921, 85.03049404928092), (4.0, 70.3813009747673, 59.59041916561341),
    (6.0, 52.3416009073036, 51.0761755835024), (8.0, 42.96592150124936, 46.27339804774597),
    (10.0, 37.14883982832212, 43.027126948467654), (12.0, 33.16008425808197, 40.6075101326946),
    (14.0, 30.228140838900277, 38.6836276328974), (16.0, 27.954497585533407, 37.08044653881406),
    (18.0, 26.112895952329353, 35.69584955850425), (20.0, 24.56600256979801, 34.46601765877898),
    (22.0, 23.226190762032004, 33.34895457902014), (24.0, 22.035374054733374, 32.31590183902734),
    (26.0, 20.953877429185056, 31.346514764540643), (28.0, 19.953948708958208, 30.426002654317713),
    (30.0, 19.015812180316644, 29.543357980773177), (32.0, 18.12515569268194, 28.690201410770456),
    (34.0, 17.27149230199026, 27.860031886175395), (36.0, 16.44708690934611, 27.047697950291116),
    (38.0, 15.64618107737431, 26.249036416487815), (40.0, 14.864500259765705, 25.46061169317759),
]

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
    "fhn_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_step.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "fhn_node_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_node.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "fhn_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_multi.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
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
        bound(2 * 19 * n * f32, TP06_OPS_PER_NODE * n),  # 18 rows and v read, 19 written
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
        bound((2 * 19 + 54) * n * f32, TP06_OPS_PER_NODE * n),
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
        bound((2 * 19 + 1) * n * f32, TP06_OPS_PER_NODE * n),  # and the model index
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
    b1_bytes = 2 * S_ * n * f32  # S - 1 rows and the injected v read, S rows written
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
    fld = field_solver(ref, tp06.generalized_rush_larsen, np.tile(np.asarray(ref.parameters)[:, None], (1, n)),
                       ref.states.double().cpu().numpy())
    ref.solve((0.0, 2.0), dt=DT)
    zero_launches(wrappers)
    fld.solve((0.0, 2.0), dt=DT)
    launches["tp06_grl_node_step_v"] = wrappers["tp06_grl_node_step_v"].launches
    same = torch.equal(fld.states, ref.states) and torch.equal(fld.activation_time, ref.activation_time)
    print(f"[node_paths] Niederer dx=0.1, TP06 parameters as a uniform {np.shape(fld.parameters)} field, "
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


def phase_fhn_kernels() -> dict:
    """FitzHugh-Nagumo's B1, its per-node form and B7 against their twins
    at the main path's width (n = 442,401) through
    ``benchmarks/kernel_check.py:fhn_checks``: one step per state row at two
    times (the stimulus on and off) and both dt, and one paced beat of every
    cell (the model's own 0-1 ms stimulus); B1's per-node form on a uniform
    field gives B1's bits.  B1's forms inject V into row 1; B7 works on
    make_multi_ode's storage layout (V in row 0)."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    n, f32 = N_MAIN, 4
    tic = time.perf_counter()
    out = kc.fhn_checks(n=n, device=DEVICE)
    took = time.perf_counter() - tic
    errs = {}
    for name, res in out["forms"].items():
        step_abs, worst = 0.0, 0.0

        def per_row(e):
            return " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(res["rows"], e))

        for (t, dt, g), (a, e) in res["step"].items():
            if g == "no layer":
                require(a == 0.0, f"{name} leaves the nodes of no layer as they were, V injected")
                continue
            print(f"[kernels] {name} one step, t={t:g}, dt={dt:g}, {g}: per row |k-w| beyond 1 ulp / "
                  f"max|increment|: {per_row(e)}")
            require(bool((e <= kc.IONIC_STEP_TOL).all()), f"{name} one-step increments agree, {g}")
            step_abs, worst = max(step_abs, a), max(worst, float(e.max()))
        for g, (a, e) in res["beat"].items():
            print(f"[kernels] {name} one beat, {g} ({n} cells in all, {kc.BEAT_STEPS} steps of {kc.BEAT_DT} ms), "
                  f"max|k-w| {a:.3e}; per row max|k-w| / max excursion: {per_row(e)}")
            require(bool((e <= kc.IONIC_BEAT_TOL).all()), f"{name} agrees with its twin over one beat, {g}")
        errs[name] = (step_abs, worst)
    print(f"[kernels] FitzHugh-Nagumo checks: {took:.1f} s")
    require(out["uniform_bits"], "fhn_node_step_v on a uniform field gives fhn_step_v's bits")

    x = out["inputs"]
    v, p0, field, b7, b7_twin = x["v"], x["table"][0], x["field"], x["b7"], x["b7_twin"]
    scratch, scratch_storage = x["S0"].clone(), x["S0_storage"].clone()
    b1_bytes = 2 * 2 * n * f32  # s and the injected v read, s and v written (row v is never read)
    rows = {
        "fhn_step_v": row(
            errs["fhn_step_v"], time_ms(lambda: cuda_ode.fhn_step_v(scratch, v, 2.0, 0.025, p0)),
            time_ms(lambda: cuda_ode.fhn_step_v_twin(scratch, v, 2.0, 0.025, p0)),
            bound(b1_bytes, FHN_OPS_PER_NODE * n), None),
        "fhn_node_step_v": row(
            errs["fhn_node_step_v"], time_ms(lambda: cuda_ode.fhn_node_step_v(scratch, v, 2.0, 0.025, field)),
            time_ms(lambda: cuda_ode.fhn_step_v_twin(scratch, v, 2.0, 0.025, field)),
            bound(b1_bytes + 11 * n * f32, FHN_OPS_PER_NODE * n), None),
        "fhn_multi_step_v": row(
            errs["fhn_multi_step_v"], time_ms(lambda: b7(scratch_storage, v, 2.0, 0.025, None)),
            time_ms(lambda: b7_twin(scratch_storage, v, 2.0, 0.025, None)),
            bound(b1_bytes + n * 4, FHN_OPS_PER_NODE * n), None),
    }
    dev_us = {
        "fhn_step_v": device_us_per_call(lambda: cuda_ode.fhn_step_v(scratch, v, 2.0, 0.025, p0)),
        "fhn_node_step_v": device_us_per_call(lambda: cuda_ode.fhn_node_step_v(scratch, v, 2.0, 0.025, field)),
        "fhn_multi_step_v": device_us_per_call(lambda: b7(scratch_storage, v, 2.0, 0.025, None)),
    }
    torch.cuda.synchronize()
    print("[kernels] device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    print_rows(rows)
    return rows


def phase_bidomain_slab() -> None:
    """The bidomain Niederer slab at dx=0.1 (442,401 nodes) through
    ``benchmarks/bidomain_scale.py:run_slab``: monolithic on the kernels
    (with the matched monodomain run), Gauss-Seidel on the kernels, and
    monolithic on the twins over the same 15 ms; the kernel run held to the
    twin run; the card's float32 DCT solve held to a float64 host solve with
    TF32 matmuls off and on; B5 timed on the bidomain's operator streams;
    20 steps of the monolithic run profiled."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call, profile_window
    from fenicsx_beat_tpu_torch.ops import cuda_stencil
    from fenicsx_beat_tpu_torch.ops.spectral import dct_solve

    wrappers = kernel_wrappers()
    runs, launches = {}, {}
    solvers = {}
    for tag, kw in (("monolithic", dict(scheme="monolithic")),
                    ("gs", dict(scheme="gs", gs_u_rtol=BIDOMAIN_GS_U_RTOL, monodomain=False)),
                    ("monolithic, twins", dict(scheme="monolithic", use_kernels=False, monodomain=False))):
        zero_launches(wrappers)
        r, solvers[tag] = bs.run_slab(BIDOMAIN_DX, dt=DT, device=DEVICE, return_solver=True, **kw)
        launches[tag] = {name: w.launches for name, w in wrappers.items() if w.launches}
        runs[tag] = r
        mono = (f"; matched monodomain {r['mono_ms_per_s']:.3f} ms/s (CG worst step {r['mono_cg_iters_max']}), "
                f"bidomain slowdown {r['bidomain_slowdown']:.2f}x") if "mono_ms_per_s" in r else ""
        print(f"[bidomain] dx={BIDOMAIN_DX} {tag}: n={r['n_nodes']}, u_precond {r['u_precond']}, host setup "
              f"{r['setup_s']:.1f} s; {r['timed_ms']:g} ms timed after 5 ms: ms_per_s={r['ms_per_s']:.3f} (wall "
              f"{r['wall_s']:.3f} s); CG per step {r['cg_iters_per_step']:.3f}, per-chunk worst step "
              f"{r['chunk_iters']} (mean {r['cg_iters_mean']:.2f}, max {r['cg_iters_max']}); host syncs per step "
              f"{r['host_syncs_per_step']:.3f}; peak device memory {r['peak_device_gib']:.2f} GiB; at 15 ms "
              f"v_max {r['v_max']:.4f}, max|u_e| {r['u_e_max_abs']:.4f}, v>0 share {r['v_pos_share']:.6f}, finite "
              f"{r['finite']}, converged {r['converged']}{mono}; launches {json.dumps(launches[tag])}")
        require(r["finite"] and r["converged"], f"bidomain slab {tag}: every state finite, every CG converged")
        jax_iters = JAX_BIDOMAIN_ITERS[r["scheme"]]
        if r["cg_iters_mean"] > 2 * jax_iters:
            print(f"[bidomain] finding: {tag} CG worst-step mean {r['cg_iters_mean']:.2f} is over twice the JAX "
                  f"package's {jax_iters}")
    for name in ("tp06_grl_step_v", "stencil_spmv"):
        require(launches["monolithic"].get(name, 0) > 0 and launches["gs"].get(name, 0) > 0,
                f"{name} launched on the bidomain slab path")
    require(not launches["monolithic, twins"], "the twin run launched no kernel")
    k, w = runs["monolithic"], runs["monolithic, twins"]
    bi, tw = solvers["monolithic"], solvers.pop("monolithic, twins")
    dv, dshare = abs(k["v_max"] - w["v_max"]), abs(k["v_pos_share"] - w["v_pos_share"])

    def field_gaps(a, b):
        return float((a.v - b.v).abs().max()), float((a.u_e - b.u_e).abs().max() / b.u_e.abs().max())

    dv_field, du_field = field_gaps(bi, tw)
    # float32's own noise at every node: the kernel run again, from states
    # moved by one ulp at random
    nz = bs.slab_solver(BIDOMAIN_DX, device=DEVICE, scheme="monolithic")
    bs.perturb_states(nz, 1)
    bs.timed_solve(nz, 5.0, 10.0, DT)
    nv, nu = field_gaps(nz, bi)
    del nz
    print(f"[bidomain] kernels vs twins at 15 ms, every node: max|v_k - v_w| {dv_field:.4e} mV (limit "
          f"{BIDOMAIN_V_FIELD_TOL}), max|u_e_k - u_e_w| / max|u_e_w| {du_field:.4e} (limit {BIDOMAIN_UE_FIELD_TOL}); "
          f"float32 noise (the kernel run from states one ulp away) {nv:.4e} mV and {nu:.4e}; "
          f"|v_max| gap {dv:.4e} mV (limit {BIDOMAIN_V_MAX_TOL}), v>0 share gap {dshare:.3e} (limit "
          f"{BIDOMAIN_SHARE_TOL}), max|u_e| {k['u_e_max_abs']:.4f} vs {w['u_e_max_abs']:.4f}; CG per step "
          f"{k['cg_iters_per_step']:.3f} vs {w['cg_iters_per_step']:.3f}")
    require(dv_field <= BIDOMAIN_V_FIELD_TOL and du_field <= BIDOMAIN_UE_FIELD_TOL,
            "bidomain kernel run's v and u_e agree with the twin run's at every node")
    require(dv <= BIDOMAIN_V_MAX_TOL and dshare <= BIDOMAIN_SHARE_TOL, "bidomain kernel run agrees with twin run")
    del tw, solvers

    # where a monolithic step's time goes: 20 steps from 15 ms, profiled
    amps, saved = bi.stimulus_amplitudes(), (bi.states.clone(), bi.u_e.clone())

    def reset():
        bi.states.copy_(saved[0])
        bi.u_e = saved[1].clone()

    w = profile_window(lambda: bi.run_chunk(15.0, DT, 20, amps).iters_sum, reset, tag="bidomain")
    print(f"[bidomain] 20 steps from 15 ms (monolithic, kernels): wall {w['wall_ms']:.3f} ms unprofiled, device "
          f"busy {w['device_busy_ms']:.3f} ms = {w['busy_share_of_wall']:.4f} of it; CG iterations {w['cg_iters']} "
          f"in each of the two runs")
    for k in w["kernels"][:12]:
        print(f"[bidomain]   {k['ms']:9.4f} ms {k['calls']:6d} calls {k['us_per_call']:8.3f} us/call  "
              f"{k['name'][:90]}")

    # the DCT solve on the card against a float64 host solve, with TF32
    # matmuls off and on: the transform must not depend on the setting
    r = torch.as_tensor(np.random.default_rng(6).standard_normal(bi._n), device=DEVICE).float()
    ref = dct_solve(r.double().cpu(), bi._u_lam.cpu(), bi._dims)
    before = torch.backends.cuda.matmul.allow_tf32
    gaps = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            z = dct_solve(r, bi._u_lam, bi._dims)
            gaps[tf32] = float((z.double().cpu() - ref).abs().max() / ref.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    dct_ms = time_ms(lambda: dct_solve(r, bi._u_lam, bi._dims))
    print(f"[bidomain] DCT solve on {bi._dims}: max|card - float64 host| / max|host| {gaps[False]:.3e} (TF32 off), "
          f"{gaps[True]:.3e} (TF32 on), limit {DCT_REL_TOL}; {dct_ms:.4f} ms back to back")
    require(max(gaps.values()) <= DCT_REL_TOL, "the card's DCT solve is float32-grade whatever TF32 allows")

    # B5 on the bidomain's streams: one SpMV of A = C_m M + dt/2 K_i, and a
    # monolithic matvec's four (A, K_i twice, K_ie)
    ops = bi._operators(float(np.float32(DT)))
    A = ops.A
    x = torch.as_tensor(np.random.default_rng(7).uniform(-90.0, 40.0, bi._n), device=DEVICE).float()
    K = len(bi._offsets)

    def four():
        return ops.mvA(x), ops.mvKi(x), ops.mvKi(x), ops.mvKie(x)

    b5 = {"one_ms": time_ms(lambda: ops.mvA(x)), "four_ms": time_ms(four),
          "device_us": device_us_per_call(lambda: cuda_stencil.stencil_spmv(A, x, bi._offsets)),
          "bound_ms": bound((K + 2) * bi._n * 4, 2 * K * bi._n)[0]}
    print(f"[bidomain] stencil_spmv on the bidomain operator A (K={K}): {b5['one_ms']:.4f} ms back to back, "
          f"{b5['device_us']:.2f} us device (torch.profiler), bound {b5['bound_ms']:.4f} ms; the four streams of "
          f"one monolithic matvec {b5['four_ms']:.4f} ms")


def phase_bidomain_references() -> None:
    """The dx=0.2 bidomain slab (15 ms) and the psize 0.3 LV (Jacobi, 10 ms)
    on the kernels, held to the JAX package's float64 values within the
    tolerances of ``tests/torch_bidomain_reference.py``; each also on its
    twins on the card, whose distance from JAX is printed beside: a kernel
    that strays shows as a kernel run further from JAX than its twin run."""
    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs

    def slab(use_kernels):
        r, solver = bs.run_slab(0.2, dt=DT, device=DEVICE, monodomain=False, return_solver=True,
                                use_kernels=use_kernels)
        r["cg_iters_all_steps"] = solver.cg_iterations / solver.steps  # 0-15 ms, as the reference counts
        return r

    def lv(use_kernels):
        r = bs.run_lv(LV_CHECK_PSIZE, dt=DT, T_warm=0.0, T_timed=10.0, device=DEVICE, use_kernels=use_kernels)
        r["cg_iters_all_steps"] = r["cg_iters_per_step"]  # no warm-up: the timed window is the run
        return r

    wrappers = kernel_wrappers()
    launches = {}
    for tag, run, ref in (("slab", slab, JAX_BIDOMAIN_SLAB02), ("LV", lv, JAX_BIDOMAIN_LV03)):
        zero_launches(wrappers)
        r = run(True)
        launches[tag] = {name: w.launches for name, w in wrappers.items() if w.launches}
        twin = run(False)
        tol = ref["tol"]
        gaps = {k: abs(r[k] - ref[k]) for k in tol}
        lo, hi = ref["cg_iters_f32"]
        print(f"[bidomain_ref] {r['case']}: n={r['n_nodes']}, u_precond {r['u_precond']}, setup {r['setup_s']:.1f} s, "
              f"ms_per_s={r['ms_per_s']:.3f}, host syncs per step {r['host_syncs_per_step']:.3f}; CG per step "
              f"{r['cg_iters_all_steps']:.3f} (twins on the card {twin['cg_iters_all_steps']:.3f}, float32 witnesses "
              f"on the CPU {lo}-{hi}, float64 {ref['cg_iters_f64']}), per-chunk worst step {r['chunk_iters']} "
              f"(twins {twin['chunk_iters']}, JAX float64 {ref['chunk_iters']}); "
              + ", ".join(f"{k} {r[k]:.6g} (JAX {ref[k]:.6g}, gap {gaps[k]:.3e}; twins on the card "
                          f"{twin[k]:.6g}, gap {abs(twin[k] - ref[k]):.3e}; limit {tol[k]:.3e})" for k in tol)
              + f"; launches {json.dumps(launches[tag])}")
        require(r["finite"] and r["converged"], f"bidomain {tag}: states finite, every CG converged")
        require(all(gaps[k] <= tol[k] for k in tol), f"bidomain {tag} within its float32 tolerances of JAX")
        require(lo - 1 <= r["cg_iters_all_steps"] <= hi + 1,
                f"bidomain {tag}: CG iterations per step within 1 of the float32 witnesses'")
    require(launches["slab"].get("stencil_spmv", 0) > 0 and launches["slab"].get("tp06_grl_step_v", 0) > 0,
            "the bidomain slab runs stencil_spmv and tp06_grl_step_v")
    require(launches["LV"].get("csr_spmv", 0) > 0 and launches["LV"].get("tp06_grl_step_v", 0) > 0,
            "the bidomain LV runs csr_spmv and tp06_grl_step_v")


def phase_bidomain_demo() -> dict:
    """``demos/bidomain_ue.py``'s configuration (nx=48, 40 ms, FHN, Strang,
    the DCT): the per-save rows held to the JAX package's float64 rows; then
    the same run with FHN's parameters as a uniform node-aligned field (B1's
    per-node form) and as one marker layer (B7), each equal bit for bit to
    the vector run.  Returns the launches of each kernel in its run."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs
    from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn

    wrappers = kernel_wrappers()
    launches = {}
    zero_launches(wrappers)
    res = bs.run_demo(nx=48, T=40.0, dt=0.1, device=DEVICE)
    launches["fhn_step_v"] = wrappers["fhn_step_v"].launches
    print(f"[demo] bidomain demo nx=48: n={res['n_nodes']}, status {res['status']}, setup {res['setup_s']:.2f} s, "
          f"ms_per_s={res['ms_per_s']:.3f}, CG per step {res['cg_iters_per_step']:.3f} (worst {res['cg_iters_max']}), "
          f"host syncs per step {res['host_syncs_per_step']:.3f}; launches "
          f"{json.dumps({k: w.launches for k, w in wrappers.items() if w.launches})}")
    gaps = []
    stray_v, stray_u = JAX_BIDOMAIN_DEMO_STRAY["v_max"], JAX_BIDOMAIN_DEMO_STRAY["u_e_max_abs"]
    for (t, vm, um), (tj, vj, uj) in zip(res["rows"], JAX_BIDOMAIN_DEMO):
        gaps.append(max(abs(vm - vj) / abs(vj) / stray_v, abs(um - uj) / abs(uj) / stray_u))
        print(f"[demo] t={t:6.1f}  v_max={vm:9.4f} (JAX {vj:9.4f})  |u_e|_max={um:8.4f} (JAX {uj:8.4f})")
    print(f"[demo] largest relative gap to JAX {max(gaps):.3f}x the float32 CPU witnesses' largest for its field "
          f"(v_max {stray_v:.3e}, max|u_e| {stray_u:.3e}; limit 3x)")
    require(res["status"] == "OK" and res["finite"] and len(gaps) == len(JAX_BIDOMAIN_DEMO),
            "the demo converged, its fields finite, every save made")
    require(max(gaps) <= 3.0, "the demo's rows within their float32 tolerances of JAX")

    # the same run on B1's per-node form (a uniform field) and on B7 (one
    # marker layer): the same formulas on the same values, so the same bits
    ref = bs.demo_solver(48, device=DEVICE)
    n = ref._n
    p = fhn.init_parameter_values(stim_amplitude=0.0)
    variants = {
        "fhn_node_step_v": dict(parameters=np.tile(p[:, None], (1, n))),
        "fhn_multi_step_v": dict(ode_fun={1: fhn.forward_euler}, init_states={1: fhn.init_state_values()},
                                 parameters={1: p}, v_index={1: 1}, ode_markers=np.ones(n, dtype=np.int64)),
    }
    ref.solve((0.0, 40.0), dt=0.1, save_freq=20)
    for name, kw in variants.items():
        other = bs.demo_solver(48, device=DEVICE, **kw)
        zero_launches(wrappers)
        other.solve((0.0, 40.0), dt=0.1, save_freq=20)
        launches[name] = wrappers[name].launches
        same = torch.equal(other.v, ref.v) and torch.equal(other.u_e, ref.u_e)
        print(f"[demo] {name} run: v and u_e at 40 ms equal to the vector run: {same}; launches {launches[name]}, "
              f"fhn_step_v {wrappers['fhn_step_v'].launches}")
        require(same and launches[name] > 0 and wrappers["fhn_step_v"].launches == 0,
                f"the demo on {name} equals the vector run bit for bit")
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
        "fhn_step_v": cuda_ode.fhn_step_v,
        "fhn_node_step_v": cuda_ode.fhn_node_step_v,
        "fhn_multi_step_v": cuda_ode.fhn_multi_step_v,
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
    rows.update(phase_fhn_kernels())
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
    del ecg_scale
    phase_bidomain_slab()
    phase_bidomain_references()
    launches.update(phase_bidomain_demo())

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
