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
   - the register gate: the registers and spill bytes of the ionic
     kernels of TP06, ToR-ORd dynCl and ToR-ORd dynCl + Land (each model's
     B1, its per-node form, B7 over every block and over a block list, in
     GRL and in forward Euler: twenty-four kernels, all reported, none
     spilling) from the library's ptxas
     report (kept beside the library, so the same whether it was built in
     this run or loaded);
   - B1-B4 and B2·B4 (B4's update folded into B2's pass: p', Ap', pAp and
     alpha, in its first-iteration and folded forms; its library yardstick
     the CSR product plus ``torch.addcmul``, each printed, and each
     library call's device time from ``torch.profiler``) at the shapes of
     the dx=0.1 Niederer main path (n = 442,401), then the PCG's two issue
     sequences on the main path's operator, in turns: the old one (B2 with
     its dot, a division, B3, a division, B4) and the new one (B2·B4, B3),
     200 iterations each, wall and device time and device launches per
     iteration; and the main path's solver for 40 steps: B2·B4 and B3
     once a CG iteration, no B4.
     The ionic kernel is held row by row for each TP06 celltype (endo,
     epi, mid): every state's one-step increment (at physiological values
     and with each slow concentration scaled, see
     ``benchmarks/kernel_check.py``), and every state over the first 100
     ms of one paced beat of 16,384 cells (the twin's step replayed as a CUDA graph; the three
     celltypes' beats side by side, a CUDA stream each).  B1's
     per-node form for TP06 at the same shapes: a uniform parameter field
     gives B1's bits exactly, a field of mixed celltypes is held by the
     same one-step limits;
   - B7 and B8 at the shapes of the psize 0.1 LV (n = 243,518): B7 with
     the LV's own transmural layers, held by the same per-row step and beat
     limits for each celltype (nodes of no layer must keep their states
     exactly), B8 on the LV's theta-system operators A and B, timed also
     with its few very long (apex) rows emptied, beside ``torch.mv``'s
     device time on the same operator; B8 must repeat its bits and stay
     within 1.5x its bound;
   - ToR-ORd dynCl, the single-cell steady states first: 2 beats at BCL
     1000 ms, dt 0.05, for each celltype, through ``get_steady_state`` on
     the card (B1 with one node), held to the JAX package's float64 states
     (V within 1 mV, every other state within 2% of its value, or both
     below float32's normal range); then ToR-ORd's B1, its per-node form
     and B7 at the psize 0.1 LV's shapes (n = 243,518; B7 with the LV's
     own layers), held per state row and celltype by the one-step limits
     (each slow row scaled) and over the first 50 ms of one paced beat of
     4,096 cells (the three forms' beats side by side, a CUDA stream each);
     B1's per-node
     form on a uniform field gives B1's bits;
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
   the launch count of every kernel in that run (B1, B2, B2·B4 and B3 must
   be > 0, B4 0: folded into B2·B4); then the same run with the old issue
   sequence patched into the solver: its CG iterations within 1% of the
   new run's, its ms/s beside;
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
   library's CSR product of the same operator (back to back and device
   time);
10. ECG Configuration 1: the dx=0.1 Strang slab for 40 ms with a pseudo-ECG
   frame every 1 ms (B5), through ``benchmarks/ecg_scale.py:run_niederer_ecg``,
   on the kernels and its first 20 ms on the twins; CG iterations, host
   syncs and seconds per frame, the 12-lead extremes, and every lead of the
   kernel run's first 20 frames held to the twin run within 3x the float32
   noise (measured with the PDE SpMV summed in another order, PERF.md);
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
   beside; the LV on its twins a second time, equal bit for bit (CG counts
   and fields: B8's twin sums in a fixed order);
14. ``demos/bidomain_ue.py``'s configuration (nx=48, FHN, Strang, 40 ms):
   every saved (t, v_max, max|u_e|) row within its field's float32
   tolerance of the JAX package's; then the same run with FHN's parameters as a uniform
   node-aligned field (B1's per-node form) and as one marker layer (B7),
   each equal bit for bit to the vector run;
15. the runtime ``.ode`` path (``demos/custom_ode.py``): the port's copies
   of the demo's inline FitzHugh-Nagumo and of a coverage source (every
   construct of the gotran subset) loaded by ``odefile.load_ode``, each
   model's library built by nvcc from ``csrc/ode_*.cu.in`` and its
   generated body (seconds and registers printed), then loaded again
   without a compile; the generated B1, per-node B1 and B7 of both sources
   and both schemes (GRL1, forward Euler) against their twins at
   n = 442,401 by FitzHugh-Nagumo's limits, timed; the generated forward
   Euler against the hand-written FHN kernels (rows mapped); every form on
   the dx=0.5 slab, the field and layer runs equal bit for bit to the
   vector run; the custom-ODE path at full width (dx=0.1, the inline FHN's
   GRL, Strang, a fixed 40 ms) on the kernels, on the twins and on both
   from states one ulp away: v at every node within 3x that noise, the
   generated B1 and B2-B4 launched; the demo's dx=0.5 configuration on
   the kernels against the JAX package's float64 values, within 3x the
   gaps of float32 witnesses on the CPU (``tests/torch_ode_reference.py``)
   and on the card, and against its twins at every node; the bidomain
   demo on the generated forward Euler against phase 14's hand-written
   run, row by row.

16. (run after 7, before the ECG) ToR-ORd dynCl + Land (52 states): each
   celltype's single-cell steady
   state (2 beats at BCL 1000 ms on Land's B1 with one node, the LV's
   pre-pacing and B1's path) against the JAX package's float64 states;
   Land's B1 and per-node form at n = 442,401 and B7 at the psize 0.1 LV's
   layers against their twins by the one-step limits (ToR-ORd's slow rows
   and Land's CaTrpn, TmB and Cd scaled) and over the first 50 ms of one
   paced beat of 4,096 cells, a uniform field giving B1's bits; the psize 0.3 Land LV's probes
   within one dt of the JAX package's; Path L, the psize 0.1 LV with
   pre-paced Land layers (30 ms timed, on until half the nodes fired; B7,
   B8), the probes' active tension, then its layers as a per-node field
   for 10 ms, equal bit for bit to the B7 run;
17. B7's mixed-model form at n = 442,401 against its twin, per model's
   nodes and state row: Path M's TP06 | Land split at x = 10 mm (union
   [52, n]) and TP06 | FHN | no marker drawn node by node (the swaps; the
   no-marker nodes bit for bit); one launch per model a step, blocks per
   model, each launch's time against its bound; Path M, the two-model
   Niederer slab at dx=0.1, Strang, 40 ms, through
   ``benchmarks/mixed.py:run_mixed_slab`` on the kernels (ms/s, CG and
   host syncs per step, P1-P9, launches per model, the share of blocks
   two models cover); its first 20 ms again (the TP06 half's wave reaching
   the Land half) on the kernels, from states one ulp away and on the
   twins (v at every node at 20 ms within 3x the kernels' one-ulp noise;
   the gap over each half printed); the same at dx=0.5 against the
   JAX package's float64 P1-P9 (``tests/torch_mixed_reference.py``), each
   within one dt.
18. (run after the per-node paths, before Land) the object-oriented path,
   ``MonodomainModel`` + the ODE adapters + ``MonodomainSplittingSolver``,
   on the kernels above (no kernel of its own): (a) the dx=0.1 Niederer
   slab, TP06 through ``DolfinODESolver``, Strang, dt 0.05, 40 ms, with a
   ``PerformanceMonitor`` (``benchmarks/niederer.py:run_niederer_oo``):
   ms/s, CG iterations, host syncs and voltage host crossings per step,
   the launches of B1, B2, B2·B4 and B3 (B1 twice a step, B2·B4 and B3
   once a CG iteration), the monitor's summary; P1-P9 from the host
   voltage each step writes, each within one dt of the JAX package's
   Strang values and of the fused main path's in this run; (b) the LV
   demo's own choreography at psize 0.1 (``benchmarks/lv_endocardial.py``:
   the pre-paced ToR-ORd layers through ``DolfinMultiODESolver``, Godunov,
   30 ms, the voltage range every 2 ms, the electrode potential at
   (2, 7, 0) through ``ECGRecovery``): every probe within one dt of the
   fused solver's at theta=1 from the same states and stimulus, with its
   PCG started from v + dv (its own start) and from v_prev (the OO
   model's), the activated share within 0.5 points of the run from v_prev
   and within 1.0 point of the converged share 0.235987, every state
   finite, ToR-ORd's B1 3 times a step, B8 launched; (c) the psize 0.3 OO
   LV for 40 steps on the kernels and on the twins from a shared state at
   5 ms (reached on the kernels): max |dv| < 1e-2; (d) B1 of the four hand-written models, both
   forms, given the state tensor's own voltage row as the OO adapters give
   it: the bits of B1 given a copy of the row; (e) spaces beyond P1
   (``build_niederer_oo``): Path P2, the dx=0.2 slab with the PDE and TP06
   on P2 (442,401 dofs, the CSR PCG around B8), Strang, 40 ms: ms/s, host
   setup seconds by part, CG iterations, host syncs and crossings per
   step, launches (B1 twice a step, B8, no stencil kernel), P1-P9 against
   the published dx=0.2 and dx=0.1 dt->0 rows beside the fused main
   path's, all nine fired, every step converged, every state finite;
   Path Q, the same slab with the PDE on P1 (58,176 nodes, B2·B4 and B3)
   and TP06 at the Quadrature_2 points (2,520,000), 10 ms, the same
   counts, B8 three times a step (its transfers: 2,520,000 x 58,176 and
   58,176 x 2,520,000, long rows), each transfer's B8 against its twin
   within 1e-4 of max|twin|; for each path, 40 steps from mid-run on the
   kernels and on the twins, max |dv| < 1e-2; and both at dx=0.5, 40 ms,
   P1-P9 within one dt of the JAX package's float64 values
   (``tests/torch_spaces_reference.py``).  Every line names the card and
   its power limit.
19. The differentiable solver (``adjoint.py``) on ``benchmarks/fit_scale.py``'s
   ``lv`` fit (psize 0.15, 78,968 nodes, TP06 GRL float32, 10 ms segments,
   one 10 ms window, carry_clip 1e3, cotangent scale 2**-64, window_outlier
   20): (a) B8's combination (``LaneCombo``: mass, fiber, transverse) on
   the card, forward, dx and dw against the twin's within 1e-4 of
   max|twin|, the same bits over two calls, device time of forward and
   backward beside ``torch.mv``'s; (b) one 10 ms window of
   ``host_segmented_value_and_grad`` through B8's combination and through
   the plain path (B8's twin), value and gradients within 3x the largest gap
   of each path to its runs from states one ulp away and with its rows
   summed in reverse (``ADJ_WITNESS_NOISE``, from ``fit_scale.py
   witness``), all finite, with
   seconds per segment forward and backward, CG iterations per step of the
   forward and adjoint solves, host syncs, B8 launches per step (forward
   and backward) and peak memory; (c) one step of the fit's Adam from the
   lane window's gradient: the loss, from a forward sweep, falls; (d) the
   lane window of the same fit at psize 0.5 (2,607 nodes) over 10 ms (two
   5 ms segments) against the CPU's float64 window of the same problem
   (``fit_scale.py reference``, its own process, started with the run),
   value and gradients within 3x the largest gap to it of the CPU's float32
   window and its runs from states one ulp away.  The adjoint's steps are
   launch-bound on the host: the 3-iteration fit and the finite-difference
   check (``fit_scale.py fdcheck``) run on their own, and on the CPU in
   ``tests/test_torch_adjoint_fit.py``.
20. SA-AMG (``ops/amg.py``: host setup, a V-cycle of B8 products on the
   card) and the biventricle: (a) the psize 0.15 BiV's (93,606 nodes)
   fibers' Laplace solve on AMG and on Jacobi, CG iterations, AMG setup
   seconds and levels, each solution against a float64 host solve (AMG's
   within 1e-4); the layers ``expand_layer_biv`` gives on the card against
   the float64 labels, every differing node within the card's error of a
   threshold; one V-cycle's B8 launches, back-to-back and device time
   against the sum of B8's bounds; (b) ``demos/biv_endocardial.py`` at that
   psize at full width (``benchmarks/biv_endocardial.py``: three ToR-ORd
   layers from phase 7's steady states, 20 activation sites, 20 ms, 1 ms
   checkpoints, the 12-lead ECG): setup seconds by part, ms/s, CG, host
   syncs and crossings per step, launches, the activated shares of the LV
   side and the RV free wall, how far the excitation reached, each lead's
   extremes; every state finite, every picked node fired, both shares
   above 0, every lead finite with a range; 40 steps from 10 ms on the
   kernels and on the twins, max |dv| < 1e-2; conduction: the demo's
   capacitance (1 uF/mm^2) keeps its excitation within about one element
   of each site, so the same BiV, sites and delays run 10 ms at 1 uF/cm^2
   from boxes of half-width 1 mm: nodes beyond 2 mm of every site fired,
   and half of all; (c) the psize 0.3 bidomain LV (TP06), monolithic and
   Gauss-Seidel, 5 ms, on ``u_precond="auto"`` (AMG) and Jacobi: AMG's
   worst step at most half of Jacobi's; v and u_e of each against the
   float64 run of the same LV on the CPU (``bidomain_scale.py
   --lv-reference``, its own process, started with the run) within 3x
   the largest gap to it of the CPU's float32 runs on the same
   preconditioner (from the same states and from one ulp away), and the
   two runs' difference within 3x the larger of those gaps.

21. (run after 17) the fused solver's remaining scope at full width:
   (a) merged Strang (``merge_strang_halves=True``, theta 0.5) on the
   main path (dx=0.1, TP06 GRL, 40 ms; B1, B2·B4, B3): P1-P9 each within
   one dt of the JAX package's merged row (``BENCH_r05.json``), within 5%
   of the converged row (JAX's 3.72% beside), ``n_steps + 1`` ionic
   launches a chunk, ms/s, CG and host syncs per step beside phase 6's
   unmerged run; (b) the main path with its S1 stimulus as a general
   expression equal to the TimeWindow, assembled each step (one B8
   launch a step): P1-P9 within one dt of phase 6's, its ms/s and the
   load's cost per step; (c) Path M with TP06's marker on a broadcast
   node-aligned field (B1's per-node form on that marker's nodes): every
   state and activation time after 2 ms equal to the table run bit for
   bit, the field step's gather and scatter beside the kernel; then a
   field of mixed celltypes, one step, kernels against twins by the
   one-step limits; (d) forward Euler of TP06, ToR-ORd dynCl and ToR-ORd
   dynCl + Land: each model's B1, per-node form and B7 one step against
   its twin (TP06 at n = 442,401, the others at 243,518) by the one-step
   limits, nodes of no layer equal, a uniform field giving B1's bits,
   each timed; on paths (the dx=0.1 slab, dt 0.002, 40 steps): TP06's B1
   on the kernels and the twins (max|dv| < 1e-2), ToR-ORd's and Land's
   B1, and six x bands, each model on a field and on a vector; (e) the
   operator disk cache: the dx=0.1 slab pair's cold assembly, its store
   and a warm load, equal bit for bit.  Every solver and ECG of the script
   passes ``operator_cache_key`` (``CACHE_KEY``; the bidomain its
   ``cache_key``) into a cache directory of the run's own, emptied at its
   start; at the end the seconds the cache saved are printed against phase
   21's and nvcc's for the forward-Euler sources.

22. (run last) the command line, ``python -m fenicsx_beat_tpu_torch`` in
   processes of its own: the psize 0.1 LV (243,518 nodes, 1,323,510
   tets) written as a binary Gmsh 4.1 file with its endocardial cells (a
   vertex on the ENDO facets) tagged, read back by ``io.read_msh`` to the
   same coordinates, cells and tags; ``run --mesh`` on it (TP06, dt 0.05,
   10 ms, a snapshot every ms, the stimulus on that tag: B1 and B8) with
   every activation time and snapshot equal bit for bit to the same solver
   built here from the arrays read (``cli.build_mesh_solver``), every state
   finite and every endocardial node fired; ``ecg`` on its checkpoint (10
   frames, B8, finite traces, seconds a frame) and ``post`` (its count of
   activated nodes that of ``run``); ``run`` on the slab at the command
   line's default dx=0.5 equal to ``run_niederer_benchmark``; one VTU
   frame of the LV through ``io.VTUWriter`` read back to the same values;
   the seconds of each part.

23. (run after 20) the sharded solvers (``fenicsx_beat_tpu_torch/parallel/``,
   SPMD over ``torch.distributed``), each world one spawn of ranks on the
   card through ``benchmarks/multichip.py:phase_rank``: world 2 on gloo
   (NCCL refuses two ranks on one device; the transfers staged through
   pinned host memory: a check, not a speed figure) beside the references
   on the card, then world 1 on NCCL alone.  (a) The dx=0.1 main path
   through ``ShardedMonodomainSolver`` (TP06 GRL, Strang, 40 ms): P1-P9
   within one dt of phase 6's and of JAX's Strang row, its ms/s, CG a step,
   exchanges and all-reduces a CG iteration beside phase 6's, B1 twice a
   step, B3 once a CG iteration, B4 and B5 launched, and no B2, B2·B4 or
   B8; (b) the psize 0.1 LV from ``init_state_values()`` (RCM, the
   tail-aware partition, B8), 10 ms: its probes within one dt of the fused
   LV's from the same start, the activated share within 0.5 points, the
   largest gap at nodes both fired printed; (c) the psize 0.3 bidomain LV
   on AMG (sharded level 0), 5 ms: v and u_e within 3x the gap to phase 20
   (c)'s float64 run of the CPU's float32 AMG runs (from the same states
   and one ulp away), the single-device card run printed beside; (d) the
   sharded adjoint on the slab of JAX's ``test_adjoint.py:1037`` at dx=0.1
   (14,091 nodes, FHN forward Euler, 16 steps, CG to rtol 1e-7),
   stimulated in the corner x <= 1, y <= 1 so that float32 resolves both
   components of dL/dg: the value and each component of dL/dg within 3x the largest gap
   in it to the single-device float64 run on the CPU of the single-device
   float32 runs on the card (from the initial states, from states one ulp
   away, and on the nodes numbered backwards, every sum in the other
   order), those gaps each under a third of the component; and one census
   row a world
   (``multichip.census_rank``).

``python3 chip_smoke.py --phase 20`` runs phase 20 alone (after the build
and phase 7's pacing) and prints no result line: a shorter run for work on
that phase, not the smoke run; ``--phase 21`` runs phase 21 alone (after
the build, phase 6's main path and Path M's setup), the same way;
``--phase 22`` runs phase 22 alone (after the build); ``--phase 23`` runs
phase 23 alone (after the build, with its own fused main path and phase 20
(c)'s CPU reference beside it).

After the build, three host processes of the run's own run beside it,
each on one or two of the host's cores at a lower priority with the card
hidden: ``chip_smoke.py --prefetch`` (phase 8's and phase 12's cold
assemblies into the run's operator cache), phase 19 (d)'s and phase 20
(c)'s CPU references.  ``[time]`` lines give each stretch's seconds as it
ends and all of them, the longest first, before the result.

Each path runs with every launch count set to 0 just before it and read
just after.  The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.  Any failed
check raises: the script exits non-zero and prints no result.  It needs a
CUDA card and the repository beside it.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
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
# The pre-paced ToR-ORd LV's activated share at 30 ms, converged: float64 at
# rtol 1e-10 on the CPU, and float32 on the card at rtol 1e-7 and 1e-8 from
# either CG start (benchmarks/lv_cg_start.py, PERF.md section 7.12); the OO
# LV at float32's clamp (rtol 1e-6) lands 0.71 points under it
LV_CONVERGED_SHARE = 0.235987
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
# The same with ToR-ORd dynCl + Land layers from init_state_values(), from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --psize 0.3 -T 30 --model torord_dyncl_land
JAX_LAND_LV_PSIZE03 = {
    "apex_endo": 2.05, "apical_endo": 1.3, "mid_endo": 1.65,
    "basal_endo": 2.5, "base_endo": 3.65, "mid_wall": -1.0,
}
JAX_LV_PSIZE03_PROBES = {
    "torord_dyncl": (JAX_TORORD_LV_PSIZE03, JAX_TORORD_LV_PSIZE03_ACTIVATED),
    "torord_dyncl_land": (JAX_LAND_LV_PSIZE03, 0.25),
}
LV_TAGS = {"tp06": "lv", "torord_dyncl": "torord_lv", "torord_dyncl_land": "land_lv"}  # print tags
# CG iterations a step of the full-width LV paths (by print tag) and of Path
# M in the run of the tree before ToR-ORd's and Land's kernels divided
# approximately (an H100 80GB HBM3 at 700 W): each run prints its count
# beside these, the ionic kernels' rounding seen through the PDE solve
PRIOR_CG_PER_STEP = {"lv": 4.878, "torord_lv": 4.198, "land_lv": 4.263, "mixed": 6.824}
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
# The same for ToR-ORd dynCl + Land (52 states; cai starts at Land's 1e-4;
# XS, Zetas, Zetaw and Cd stay 0 unstretched), from
#   JAX_PLATFORMS=cpu python tests/torch_lv_reference.py --steady-states --model torord_dyncl_land
JAX_LAND_STEADY = {
    0.0: [-89.71346313, 0.01099942657, 7.749076004e-05, 6.694099231e-05, 1.5500418, 1.548550129, 29.20697148,
          29.20694682, 147.7130744, 147.713034, 12.39656764, 12.39692232, 0.0006566025064, 0.8467108495,
          0.7008049828, 0.8467564031, 0.8466472995, 0.0001360116315, 0.5574859446, 0.3135656288,
          0.0008919979828, 0.0004544727058, 0.999669654, 0.5998798862, 0.9996696506, 0.6643472815, 0.0,
          0.9999999943, 0.9412891774, 0.9999999943, 0.9999007204, 0.9999853621, 0.9999999943, 0.9999999943,
          0.0005496799955, 0.0009667253263, 0.0006509155205, 0.000791286891, 0.9928892423, 0.0002867204918,
          9.637172037e-06, 0.2397057005, 0.0001591495384, 8.131076769e-77, 3.322264069e-62, 0.0001106248063,
          0.0001669134894, 0.00917113803, 0.9995554259, 0.0, 0.0, 0.0],
    1.0: [-89.84226968, 0.01105927912, 6.265937098e-05, 5.486656772e-05, 1.620200965, 1.617538307,
          29.20821125, 29.20819294, 147.7023296, 147.7022948, 12.38693763, 12.38720944, 0.0006385987745,
          0.8490379135, 0.7047426742, 0.8490745752, 0.8490000574, 0.0001327243608, 0.5628862759,
          0.3205084195, 0.0008842863364, 0.0004505419185, 0.999676996, 0.999675334, 0.9996769958,
          0.9996769044, 0.0, 0.9999999945, 0.9366960042, 0.9999999945, 0.9999066079, 0.9999815236,
          0.9999999945, 0.9999999945, 0.0002540152791, 0.0004255096606, 0.0006431948188, 0.0007837357719,
          0.9924869703, 0.000259836492, 8.670854023e-06, 0.2583656752, 0.0001568771973, 6.129026166e-76,
          1.941591572e-61, 6.652523342e-05, 0.0001005883414, 0.006014090994, 0.9997322075, 0.0, 0.0, 0.0],
    2.0: [-89.45799584, 0.01476531008, 7.515876139e-05, 6.232501718e-05, 1.594411604, 1.591422305,
          29.21514633, 29.21512424, 147.6610474, 147.6610342, 12.44470173, 12.44509173, 0.000693804808,
          0.8420019109, 0.6928883156, 0.8420220232, 0.8414112248, 0.0001427742398, 0.5355263803,
          0.2769317416, 0.0009074933493, 0.0004623711078, 0.9996545475, 0.5291915894, 0.9996545438,
          0.5817621263, 0.0, 0.9999999938, 0.8950977017, 0.9999999938, 0.9994605952, 0.9999284574,
          0.9999999938, 0.9999999938, 0.0004168274266, 0.0008594820055, 0.0007068064567, 0.0008050849914,
          0.9917837657, 0.000957628922, 3.273129719e-05, 0.3149525226, 0.0001637659441, 9.469421075e-65,
          1.688614592e-52, 0.0001032954405, 0.0001552029207, 0.00863146661, 0.999586179, 0.0, 0.0, 0.0],
}
JAX_STEADY_STATES = {"torord_dyncl": JAX_STEADY, "torord_dyncl_land": JAX_LAND_STEADY}
STEADY_V_TOL = 1.0  # mV
STEADY_REL_TOL = 0.02  # every other state, relative to the JAX value
# float32's smallest normal number: d, Jrel_np and Jrel_p rest below it in
# float64 (0, 1e-76 to 1e-53), where float32 holds a denormal or zero
F32_MIN_NORMAL = 1.1754944e-38
# B2-B4 and B8 kernel vs twin on the card, float32: per output vector,
# max|kernel - twin| / max|twin| (rounding-order noise is ~1e-6).  B1 and
# B7 are held per state row by the limits of benchmarks/kernel_check.py.
REL_TOL = 1e-4
# B8's device time at the psize 0.1 LV's operator, at most this share of its
# bound (11.6 us against 9.16 on an H100 at 700 W: 1.27x; with one thread
# for each apex row the kernel took 3.7x)
CSR_BOUND_SHARE_MAX = 1.5
BEAT_CELLS = 16_384  # cells of the TP06 ionic kernels' one-beat comparison
TORORD_BEAT_CELLS = 4_096  # cells of the ToR-ORd ionic kernels' one-beat comparisons
# steps of the beat comparisons at dt 0.05, short of the whole 400 ms beat
# to keep the script inside its time limit: TP06's first 100 ms, ToR-ORd's
# and Land's first 50 ms (the stimulus, the upstroke and the start of the
# plateau, where the kernels and the twins part most); the whole beat of
# the ToR-ORd models' B1 is still held to the JAX package's float64 by the
# steady-state pacing, 2 beats of each celltype, and the node form and B7
# share B1's body
TP06_BEAT_STEPS = 2_000
TORORD_BEAT_STEPS = 1_000
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
# an H100 (PERF.md, measured in every run of PRs 3-11); the kernel run sat at
# 1.1e-2.  The limit is 3x that noise.
ECG_LEAD_TOL = 5e-2
# the twin run's horizon (ms): the first 20 of the kernel run's 40 frames,
# the wave's spread from the corner over the slab's first half (the twins
# take ~0.5 s a simulated ms, against the script's time limit)
ECG_TWIN_T = 20.0
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
# ToR-ORd dynCl + Land: ToR-ORd's, and Land's mechanics counted from
# csrc/torord_land.cuh (about 70 add/mul/div/compare, 4 pow, 7 exp) and its
# dcai (6 more)
LAND_OPS_PER_NODE = TORORD_OPS_PER_NODE + 90
# FitzHugh-Nagumo forward-Euler operations per node, counted from
# csrc/fhn.cuh: 25 add/mul/div/neg and 3 compares.
FHN_OPS_PER_NODE = 28
IONIC_OPS_PER_NODE = {"tp06": TP06_OPS_PER_NODE, "torord_dyncl": TORORD_OPS_PER_NODE,
                      "torord_dyncl_land": LAND_OPS_PER_NODE, "fhn": FHN_OPS_PER_NODE}
# Path M, the two-model Niederer slab (benchmarks/mixed.py): TP06 on x < 10
# mm, ToR-ORd dynCl + Land (endo) on the rest, Strang, dt=0.05, 40 ms, on B7's
# mixed form; at dx=0.1 the kernel run is held to its twin run at every node
# (3x float32's noise, measured as for the custom-ODE path)
MIXED_DX, MIXED_T = 0.1, 40.0
# The kernel-vs-twin comparison reads v at 20 ms (the wave has crossed the
# TP06 half into the Land half: P9, at x = 10 mm, fires at 18.15 ms), not at
# 40 ms (Land's P3 and P7 fire at 33-34 ms): a twin run of the slab takes
# 1.4-2.4 s for each ms on an H100 (0.42-0.72 ms/s), and a window from the
# kernel run's states at 14 or 30 ms is no cheaper witness: its one-ulp
# noise over 6 ms (2.4e-3 mV) sits under the kernels' distance to the twins
# that 14 ms from the start built (1.28e-2 mV on an H100 at 700 W).  The
# noise is the kernels' one-ulp run's (the twins' own one-ulp run, 6.25e-3
# mV under the kernels' 1.206e-2 at 20 ms, is not repeated)
MIXED_TWIN_TIMES = (20.0,)
# ... and at dx=0.5 (4,305 nodes) to the JAX package's P1-P9 in float64 on
# the CPU, each within one dt (-1: not fired by 40 ms at this size), from
#   JAX_PLATFORMS=cpu python tests/torch_mixed_reference.py --dx 0.5 -T 40
JAX_MIXED_DX05 = {"P1": 1.2, "P2": -1.0, "P3": 36.25, "P4": -1.0, "P5": 13.95, "P6": -1.0, "P7": 35.3,
                  "P8": -1.0, "P9": 25.8}
JAX_MIXED_DX05_ACTIVATED = 0.7126596980255517
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

# The runtime .ode path (demos/custom_ode.py): the port's own copies of the
# gotran sources, loaded by fenicsx_beat_tpu_torch.odefile.load_ode; each
# gets B1, B1's per-node form and B7 for its GRL1 and forward-Euler steps,
# built by nvcc at the first launch.  The inline FitzHugh-Nagumo is the
# demo's model; the coverage source uses every construct of the gotran
# subset.  For each, the ranges the one-step checks draw every state from,
# the parameter sets of the per-node and multi-marker checks, and the
# states one beat starts from (inline FHN: depolarized past threshold, so
# most cells fire; coverage: its own 1-3 ms stimulus).
ODE_SOURCES = {
    "fhn_inline": dict(ranges={"v": (-90.0, 40.0), "w": (0.0, 60.0)}, sets=[{}, {"b": 0.02}, {"c_3": 1.5}],
                       rest={"v": (-85.0, -40.0)}),
    "coverage": dict(ranges={"h": (0.05, 0.95), "V": (-90.0, 30.0), "c": (0.5, 4.0), "n": (0.0, 1.0)},
                     sets=[{}, {"g": 1.0}, {"k_c": 0.03}], rest={"V": (-82.0, -78.0)}),
}
ODE_SCHEMES = {"grl": "generalized_rush_larsen", "fe": "forward_euler"}
ODE_BEAT_STEPS = 1_000  # 50 ms at dt 0.05: each generated model's upstroke and more
ODE_DX = 0.1  # the custom-ODE path at the main path's width (442,401 nodes)
ODE_T = 40.0  # a fixed horizon: the inline FHN's probes never fire on the slab
# The custom-ODE paths, kernel run vs twin run: max|v_k - v_w| at every node
# within 3x float32's noise there, which the phases measure from runs of the
# kernels and of the twins started from states one ulp away.
ODE_NOISE_FACTOR = 3.0
# demos/custom_ode.py's configuration (dx=0.5, the inline FHN's GRL, Strang,
# dt=0.05, 40 ms): v_max and v at P1-P9 of the JAX package's generated
# module in float64 on the CPU, and each value's largest distance from it
# over four float32 CPU witnesses of the port (its twins, from the initial
# states and from three one ulp away), from
#   JAX_PLATFORMS=cpu python tests/torch_ode_reference.py
# The card's kernel run is held to three times each value's largest
# distance over these and the card's own float32 runs: the twins from the
# initial states, and twins and kernels from states one ulp away
# (ODE_DEMO_SEEDS); at least three float32 ulps of the value.
JAX_CUSTOM_ODE_DX05 = {
    "v_max": -12.68717626562431, "v_P1": -12.68717626562431, "v_P2": -84.99999954330853,
    "v_P3": -84.99999997385451, "v_P4": -84.99999999998884, "v_P5": -81.45396470003766, "v_P6": -85.00001478237856,
    "v_P7": -84.99999999861613, "v_P8": -84.99999999965019, "v_P9": -85.00029564453423,
}
JAX_CUSTOM_ODE_DX05_CPU_GAP = {
    "v_max": 0.11180253991768296, "v_P1": 0.11180253991768296, "v_P2": 0.0006947315938106158,
    "v_P3": 0.0001525617451392236, "v_P4": 0.000785827647874271, "v_P5": 0.013405312830627736,
    "v_P6": 0.000526904633161962, "v_P7": 0.000770570231523493, "v_P8": 0.00020599330252935033,
    "v_P9": 0.0006809179657665254,
}
ODE_DEMO_SEEDS = (1, 2, 3)

# The OO path on spaces beyond P1 (phase 18 (e)): the Niederer slab at dx=0.2
# with the PDE on P2 (Path P2: 58,176 vertices + 384,225 edges, 315,000
# tets), and with the PDE on P1 and TP06 at the Quadrature_2 points (Path Q:
# 8 a tet); Path P2 runs 40 ms, Path Q 10 ms, each kernel check 40 steps from
# SPACES_CHECK_AT (Path Q from half its horizon); Path P2's P4 and P8 fire
# after 40 ms (P2 with the ionic step at its dofs conducts slower than P1 at
# dx=0.1; the JAX package's dx=0.5 run the same), so it runs on until all
# nine fired
SPACES_DX, SPACES_P2_T, SPACES_Q_T, SPACES_CHECK_AT = 0.2, 40.0, 10.0, 10.0
SPACES_P2_T_MAX = 60.0  # Path P2 goes on in 5 ms pieces until all nine probes fired
N_SPACES_P2, N_SPACES_Q_NODES, N_SPACES_Q_POINTS = 442_401, 58_176, 2_520_000
# ... and at dx=0.5 (P2: 30,537 dofs; Q: 4,305 nodes, 161,280 points), 40 ms:
# P1-P9 of the JAX package's OO path in float64 on the CPU (-1: not fired by
# 40 ms), from
#   JAX_PLATFORMS=cpu python tests/torch_spaces_reference.py --dx 0.5 -T 40
JAX_SPACES_DX05 = {
    "p2": [1.25, 32.45, 31.7, -1.0, 9.9, 32.45, 31.75, -1.0, 19.2],
    "q": [-1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0, -1.0],
}

# Phase 19, the differentiable solver (``fenicsx_beat_tpu_torch/adjoint.py``)
# on the fit of ``benchmarks/fit_scale.py``'s ``lv`` case: the LV at psize
# 0.15 (78,968 nodes), TP06 GRL in float32, dt 0.05, 10 ms segments, one
# 10 ms window (20 ms until phase 20 needed the time), carry_clip 1e3,
# cotangent scale 2**-64, window_outlier 20, the fiber and transverse
# components through B8's combination (lane path) and through B8's twin
# (the plain path); then one Adam step from the lane window's gradient
ADJ_PSIZE, ADJ_T = 0.15, 10.0
# The two paths' window is held to 3x the float32 noise of each quantity:
# the largest gap of each path to its run from states moved by one ulp
# (seed 1) and to its run with each row's entries summed in reverse order,
# from
#   python -m fenicsx_beat_tpu_torch.benchmarks.fit_scale witness -T 10
# on an H100 80GB HBM3 at 700 W (every kernel and sum on these paths is
# deterministic: the card repeats the windows bit for bit, and the lane
# and plain windows here).  The two paths differ in the order of their
# sums, and so do the reversed runs (over the 20 ms window the one-ulp
# runs moved the loss by 1.2e-9 and 2.5e-9, the reversed ones by 1.5e-8
# and 1.4e-8).  Over 10 ms the lane and plain windows were 2.590e-9,
# 9.015e-7 and 1.007e-5 apart.
ADJ_WITNESS_NOISE = {"loss": 5.835e-09, "dL/dg_l": 1.673e-06, "dL/dg_t": 2.271e-05}
TP06_STATES = 19

# the ionic sources whose kernels the register gate holds (phase 3): each
# model's B1, per-node form and B7 over every block and over a block list,
# in GRL and in forward Euler (its *_fe*.cu sources build the same kernels
# with the node body's scheme switch on): eight a model
IONIC_GATED = ("tp06_grl", "torord_grl", "torord_land_grl")
IONIC_GATED_KERNELS = 8

# Phase 21, the fused solver's remaining scope.  Every solver and ECG the
# script builds passes this key (the operator disk cache, its own empty
# directory each run): the content of mesh, conductivity and dtype decides
# a hit, so one key serves every mesh
CACHE_KEY = "chip_smoke"
# P1..P9 and the error against the converged row of the JAX package's
# merged Strang, dx=0.1 dt=0.05, from BENCH_r05.json (its activation times
# only: its TPU times are not the port's)
JAX_MERGED_DX01 = [1.25, 26.15, 32.40, 39.15, 8.20, 26.80, 32.90, 39.30, 18.45]
JAX_MERGED_MAX_REL_ERR = 0.0372
# forward Euler's path runs: TP06's gates make it unstable at 0.005 ms and
# above on the slab; JAX's float64 run is finite at FE_DT
# (tests/test_torch_ionic_fe.py:FE_DT)
FE_DT, FE_STEPS = 0.002, 40

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
    # B2·B4: B4's update folded into B2's pass (the PCG body, fused.py:545-551)
    "stencil_spmv_sym_dir_dot": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv_sym.cu",
                                 "fenicsx_beat_tpu/ops/pallas_spmv.py:175 + fenicsx_beat_tpu/ops/pallas_cg.py:124"),
    "cg_update": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
                  "fenicsx_beat_tpu/ops/pallas_cg.py:41"),
    "axpy": ("fenicsx_beat_tpu_torch/csrc/cg_update.cu",
             "fenicsx_beat_tpu/ops/pallas_cg.py:124"),
    "tp06_grl_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_grl_multi.cu",
                              "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "csr_spmv": ("fenicsx_beat_tpu_torch/csrc/csr_spmv.cu",
                 "fenicsx_beat_tpu/ops/pallas_ell.py:170"),
    # B8 under the differentiable solver's combination (adjoint.LaneCombo):
    # its forward and its backward, the JAX package's custom VJP around B8
    # (fenicsx_beat_tpu/adjoint.py:180-194)
    "csr_spmv[combination]": ("fenicsx_beat_tpu_torch/csrc/csr_spmv.cu",
                              "fenicsx_beat_tpu/ops/pallas_ell.py:170 (fenicsx_beat_tpu/adjoint.py:181)"),
    "csr_spmv[combination backward]": ("fenicsx_beat_tpu_torch/csrc/csr_spmv.cu",
                                       "fenicsx_beat_tpu/ops/pallas_ell.py:170 (fenicsx_beat_tpu/adjoint.py:187)"),
    "stencil_spmv": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv.cu",
                     "fenicsx_beat_tpu/ops/pallas_spmv.py:38"),
    "stencil_spmv_window": ("fenicsx_beat_tpu_torch/csrc/stencil_spmv_window.cu",
                            "fenicsx_beat_tpu/ops/pallas_spmv.py:358"),
    "fhn_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_step.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "fhn_node_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_node.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "fhn_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/fhn_multi.cu", "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "torord_land_grl_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_grl.cu",
                               "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_land_grl_node_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_grl_node.cu",
                                    "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_land_grl_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_grl_multi.cu",
                                     "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    # forward Euler of the hand-written models (phase 21): each GRL source built
    # with its node body's scheme switch
    "tp06_fe_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_fe.cu",
                      "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "tp06_fe_node_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_fe_node.cu",
                           "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "tp06_fe_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/tp06_fe_multi.cu",
                            "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "torord_fe_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_fe.cu",
                        "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_fe_node_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_fe_node.cu",
                             "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_fe_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_fe_multi.cu",
                              "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "torord_land_fe_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_fe.cu",
                             "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_land_fe_node_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_fe_node.cu",
                                  "fenicsx_beat_tpu/ops/pallas_ode.py:89"),
    "torord_land_fe_multi_step_v": ("fenicsx_beat_tpu_torch/csrc/torord_land_fe_multi.cu",
                                   "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    # B7's mixed-model form: each model's B7 kernel over its own blocks
    # (the JAX kernel's active[model, block] table, pallas_ode.py:375-383)
    "tp06_grl_multi_step_v[mixed]": ("fenicsx_beat_tpu_torch/csrc/tp06_grl_multi.cu",
                                     "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
    "torord_land_grl_multi_step_v[mixed]": ("fenicsx_beat_tpu_torch/csrc/torord_land_grl_multi.cu",
                                            "fenicsx_beat_tpu/ops/pallas_ode.py:325"),
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def prior_cg(tag: str, mean: float) -> str:
    """A path's CG iterations a step beside :data:`PRIOR_CG_PER_STEP`'s."""
    prior = PRIOR_CG_PER_STEP[tag]
    return f"before {prior:.3f}, {100 * (mean - prior) / prior:+.2f}%"


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


def lv_layers(solver):
    """The LV solver's B7 layer index (int32, one per node) and parameter
    table on the card: its one model's launch."""
    g = solver._ionic_groups[0]
    return g.index, g.table


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


def phase_kernels(seed: int = 0) -> tuple[dict, object]:
    """B1-B4 and B2·B4 against their twins at the Niederer main path's
    shapes; returns per-kernel rows for the final JSON and the main path's
    solver."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch._build import load_library, ptxas_resources
    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ode, cuda_spmv

    # The ionic kernels of TP06, ToR-ORd dynCl and ToR-ORd dynCl + Land (B1,
    # its per-node form, B7 over every block and over a block list, in GRL
    # and in forward Euler): registers a thread and spill bytes, from the
    # library's ptxas report; all twenty-four reported, none spilling
    resources = ptxas_resources(load_library().compiler_output)
    for prefix in IONIC_GATED:
        res = {name: r for name, r in resources.items() if f"{prefix}_" in name}
        print(f"[kernels] {prefix} kernels, registers / spill stores / spill loads (bytes): "
              + ", ".join(f"{name} {r[0]} / {r[1]} / {r[2]}" for name, r in sorted(res.items())))
        require(len(res) == IONIC_GATED_KERNELS,
                f"the build reports {prefix}'s {IONIC_GATED_KERNELS} kernels (got {sorted(res)})")
        require(all(r[1] == 0 and r[2] == 0 for r in res.values()), f"{prefix}'s kernels do not spill")

    tic = time.perf_counter()
    solver = _build_solver(dx=0.1, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
    n = solver.V.ndofs
    require(n == N_MAIN, f"dx=0.1 slab has {N_MAIN} nodes (got {n})")
    A, _, minv, (fused, update) = solver._operators(DT)
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
    # paced beat (TP06_BEAT_STEPS) of BEAT_CELLS cells, every row held by
    # its excursion.
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
    # the three celltypes' beats side by side, a CUDA stream each
    tic = time.perf_counter()
    beats = kc.ionic_beats_errors_by_group([
        (cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, beat0, tp06.init_parameter_values(celltype=ct),
         {"all": None}) for ct in kc.CELLTYPES
    ], n_steps=TP06_BEAT_STEPS)
    took = time.perf_counter() - tic
    for ct, out in zip(kc.CELLTYPES, beats):
        beat_abs, beat_err = out["all"]
        print(f"[kernels] tp06_grl_step_v one beat, celltype {ct:g} ({BEAT_CELLS} cells, "
              f"{TP06_BEAT_STEPS} steps of {kc.BEAT_DT} ms, the three celltypes' beats {took:.1f} s), "
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

    # B2·B4 on the same operator, through the main path's bound call: the
    # first-iteration form (p' = z) and the folded one; its library
    # yardstick is the CSR product plus torch.addcmul
    z, p_old = on_card(rng.uniform(-90.0, 40.0, n)), on_card(rng.uniform(-90.0, 40.0, n))
    rz_cur = on_card(np.float32(0.83)).reshape(())
    rz_prev = on_card(np.float32(1.37)).reshape(())
    errs = []
    for prev in (None, rz_prev):
        outk = fused(z, p_old, rz_cur, prev)
        outt = cuda_spmv.stencil_spmv_sym_dir_dot_twin(A, z, p_old, pos, rz_cur, prev)
        errs.append(compare(outk, outt))
        print(f"[kernels] stencil_spmv_sym_dir_dot, {'first' if prev is None else 'folded'} form: p', Ap', pAp, "
              "alpha max|k-w| / max|w|: " + " ".join(f"{e:.3e}" for e in (compare([a], [b])[1]
                                                                         for a, b in zip(outk, outt))))
    beta = rz_cur / rz_prev
    lib_mv = library_time(lambda: sparse_mv(S_A, z))
    lib_add = library_time(lambda: torch.addcmul(z, beta, p_old))
    print(f"[kernels] stencil_spmv_sym_dir_dot library yardstick: torch.mv (CSR) "
          f"{'refused' if lib_mv is None else f'{lib_mv:.4f} ms'}, torch.addcmul "
          f"{'refused' if lib_add is None else f'{lib_add:.4f} ms'}")
    rows["stencil_spmv_sym_dir_dot"] = row(
        (max(e[0] for e in errs), max(e[1] for e in errs)),
        time_ms(lambda: fused(z, p_old, rz_cur, rz_prev)),
        time_ms(lambda: cuda_spmv.stencil_spmv_sym_dir_dot_twin(A, z, p_old, pos, rz_cur, rz_prev)),
        # z, p_old and the columns read, p' and Ap' written; p' 2, the row 2 (2 Kp - 1), the dot 2 a row
        bound((kp + 4) * n * f32, (2 + 2 * (2 * kp - 1) + 2) * n),
        None if lib_mv is None or lib_add is None else lib_mv + lib_add,
    )
    # B3 and B4 on random vectors, the main path's Jacobi preconditioner
    xv, r, p, ap = (on_card(rng.standard_normal(n)) for _ in range(4))
    alpha = on_card(np.float32(0.37)).reshape(())
    beta = on_card(np.float32(0.61)).reshape(())
    # B3 through the main path's bound call, as B2·B4
    outk = update(xv, r, p, ap, minv, alpha)
    outt = cuda_cg.cg_update_twin(xv, r, p, ap, minv, alpha)
    rows["cg_update"] = row(
        compare(outk, outt),
        time_ms(lambda: update(xv, r, p, ap, minv, alpha)),
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
        "stencil_spmv_sym_dir_dot": device_us_per_call(lambda: fused(z, p_old, rz_cur, rz_prev)),
        "cg_update": device_us_per_call(lambda: update(xv, r, p, ap, minv, alpha)),
        "axpy": device_us_per_call(lambda: cuda_cg.axpy(xv, p, beta)),
    }
    print("[kernels] device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    lib_us = {"torch.mv (CSR, B2's operator)": device_us_per_call(lambda: sparse_mv(S_A, x)),
              "torch.addcmul": device_us_per_call(lambda: torch.addcmul(xv, beta, p))}
    print("[kernels] library calls, device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in lib_us.items()))
    for name in ("stencil_spmv_sym", "stencil_spmv_sym_dir_dot", "cg_update", "axpy"):
        require(rows[name]["rel_err"] <= REL_TOL,
                f"{name} agrees with its twin (rel {rows[name]['rel_err']:.3e} <= {REL_TOL})")
    return rows, solver


def phase_lv_setup():
    """The full-width LV solver (psize 0.1) on the card, its host setup timed."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import build_lv_solver, lv_probe_points

    tic = time.perf_counter()
    solver = build_lv_solver(
        psize=LV_PSIZE, device=DEVICE, precond="jacobi",
        probe_points=list(lv_probe_points(LV_PSIZE).values()), operator_cache_key=CACHE_KEY,
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - tic
    n = solver.V.ndofs
    model = lv_layers(solver)[0]
    print(f"[lv] psize {LV_PSIZE}: n={n} nodes, {solver.mesh.num_cells} cells, layers "
          f"(model index: count) {torch.bincount(model.long() + 1).tolist()[1:]}, "
          f"{solver._pde.mass.nnz} operator entries, host setup {setup:.1f} s")
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
    model, table = lv_layers(solver)
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

    # one paced beat (TP06_BEAT_STEPS) of BEAT_CELLS cells spread evenly over the LV, each
    # with its own layer's parameter set (the model's own pacing on)
    sample = torch.as_tensor(np.linspace(0, n - 1, BEAT_CELLS).astype(np.int64), device=dev)
    model_b = lv_layers(solver)[0][sample].contiguous()
    table_np = np.stack([tp06.init_parameter_values(celltype=CELLTYPES[m]) for m in sorted(CELLTYPES)])
    table_b = on_card(table_np)
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS))
                    * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))
    beat_groups = {name: torch.nonzero(model_b == i).flatten() for i, name in layer_of.items()}
    tic = time.perf_counter()
    beat = kc.ionic_beat_errors_by_group(  # the twin's table on the host: its graph needs no copy
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v(S, v, model_b, t, dt, table_b),
        lambda S, v, t, dt, p: cuda_ode.tp06_grl_multi_step_v_twin(S, v, model_b, t, dt, table_np),
        beat0, None, beat_groups, n_steps=TP06_BEAT_STEPS,
    )
    beat_s = time.perf_counter() - tic
    for g, (a, e) in beat.items():
        print(f"[kernels] tp06_grl_multi_step_v one beat, {g} ({beat_groups[g].numel()} of "
              f"{BEAT_CELLS} cells, {TP06_BEAT_STEPS} steps of {kc.BEAT_DT} ms, {beat_s:.1f} s for all), max|k-w| "
              f"{a:.3e}; per row max|k-w| / "
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
    A, B, _, _ = solver._operators(DT)
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
        dev_us["library"] = device_us_per_call(lambda: sparse_mv(S_A, x))
    share = dev_us["full"] / (1e3 * rows["csr_spmv"]["bound_ms"])
    print(f"[kernels] csr_spmv: n={n}, {A.nnz} entries, row length max {int(lengths.max())}, "
          f"mean {lengths.mean():.2f}; {long_rows.size} rows longer than {LONG_ROW} "
          f"({int(lengths[long_rows].sum())} entries), {A.long_rows.numel()} given a warp (longer than "
          f"{cuda_ell.LONG_ROW}): device time {dev_us['full']:.2f} us with them, {dev_us['short']:.2f} us "
          f"with them emptied ({dev_us['short'] / dev_us['full']:.3f}x), {share:.2f}x its bound; torch.mv "
          + ("refused" if "library" not in dev_us else f"{dev_us['library']:.2f} us")
          + " (torch.profiler)")
    print(f"[kernels] tp06_grl_multi_step_v: device time {dev_us['b7']:.2f} us per call (torch.profiler)")
    torch.cuda.synchronize()
    print_rows(rows)
    require(rows["csr_spmv"]["rel_err"] <= REL_TOL,
            f"csr_spmv agrees with its twin (rel {rows['csr_spmv']['rel_err']:.3e} <= {REL_TOL})")
    require(all(torch.equal(ys_k[0], cuda_ell.csr_spmv(A, x)) for _ in range(3)),
            "csr_spmv gives the same bits run after run")
    require(share <= CSR_BOUND_SHARE_MAX,
            f"csr_spmv's device time is within {CSR_BOUND_SHARE_MAX}x its bound (got {share:.2f}x)")
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


def phase_steady_states(model: str = "torord_dyncl") -> tuple[dict, float, int]:
    """Each celltype's single-cell steady state of ``model`` (ToR-ORd
    dynCl, or ToR-ORd dynCl + Land) on the card (the LV demo's pre-pacing,
    B1 with one node), held to the JAX package's float64 states; returns
    marker -> states, the pacing seconds and B1's launches."""
    import tempfile

    import numpy as np

    from fenicsx_beat_tpu_torch.benchmarks.lv import (
        CELLTYPES, MODELS, PREPACE_BCL, PREPACE_BEATS, lv_steady_states,
    )
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    m = MODELS[model]
    names = m._STATE_NAMES
    b1 = cuda_ode.ionic_model(m.generalized_rush_larsen).step
    tag = "steady" if model == "torord_dyncl" else "land_steady"
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:  # nothing cached: paced here
        tic = time.perf_counter()
        steady = lv_steady_states(dt=DT, device=DEVICE, outdir=cache, model=model)
        seconds = time.perf_counter() - tic
    launches = b1.launches
    steps = len(CELLTYPES) * PREPACE_BEATS * len(np.arange(0.0, PREPACE_BCL, DT))
    print(f"[{tag}] {model}: {PREPACE_BEATS} beats at BCL {PREPACE_BCL} ms, dt={DT}, 3 celltypes: "
          f"{seconds:.2f} s, {launches} {b1.__name__} launches ({1e6 * seconds / steps:.1f} us per step)")
    require(launches == steps, f"every pacing step launched {b1.__name__}")
    for marker, y in steady.items():
        ct = CELLTYPES[marker]
        ref = np.asarray(JAX_STEADY_STATES[model][ct])
        v_gap = abs(y[0] - ref[0])
        tiny = (np.abs(ref) < F32_MIN_NORMAL) & (np.abs(y) < F32_MIN_NORMAL)
        rel = np.where(tiny, 0.0, np.abs(y - ref) / np.maximum(np.abs(ref), 1e-300))
        rel[0] = 0.0
        worst = np.argsort(-rel)[:4]
        print(f"[{tag}] celltype {ct:g}: |V - V_jax| {v_gap:.4e} mV (limit {STEADY_V_TOL:g}); max relative "
              f"gap of the other states {rel.max():.3e} (limit {STEADY_REL_TOL:g}), largest "
              + ", ".join(f"{names[i]} {rel[i]:.2e}" for i in worst)
              + "; below float32's normal range in both: " + ", ".join(names[i] for i in np.nonzero(tiny)[0]))
        require(np.isfinite(y).all(), f"celltype {ct:g} steady state finite")
        require(v_gap <= STEADY_V_TOL, f"celltype {ct:g} steady V within {STEADY_V_TOL:g} mV of the JAX value")
        require(rel.max() <= STEADY_REL_TOL,
                f"celltype {ct:g} steady states within {STEADY_REL_TOL:g} of the JAX values")
    return steady, seconds, launches


def phase_torord_lv_setup(steady: dict, layers, model: str = "torord_dyncl"):
    """The demo's own LV at full width: ToR-ORd (or ToR-ORd + Land) layers
    from the pre-paced steady states, its host setup timed; ``layers`` is
    the TP06 LV's labelling of the same mesh (phase 3 times the labelling's
    Laplace solve)."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import build_lv_solver, lv_probe_points

    tic = time.perf_counter()
    solver = build_lv_solver(
        psize=LV_PSIZE, device=DEVICE, precond="jacobi", model=model, init_states=steady, layers=layers,
        probe_points=list(lv_probe_points(LV_PSIZE).values()), operator_cache_key=CACHE_KEY,
    )
    torch.cuda.synchronize()
    setup = time.perf_counter() - tic
    print(f"[{LV_TAGS[model]}] psize {LV_PSIZE}: n={solver.V.ndofs} nodes, {solver.states.shape[0]} states, "
          f"host setup {setup:.1f} s (the TP06 LV's layers)")
    require(solver.V.ndofs == N_LV and solver._ionic.name == model, f"the {model} LV at full width")
    return solver, setup


def phase_torord_kernels(solver, seed: int = 3, model: str = "torord_dyncl", n_b1: int | None = None) -> dict:
    """B1, its per-node form and B7 of ToR-ORd dynCl (or of ToR-ORd dynCl +
    Land: ``model``) against their twins: B1's forms at ``n_b1`` nodes (the
    LV's when None), B7 at the full-width LV's shapes with the LV's own
    layers and table."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES, MODELS
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    tor = MODELS[model]
    spec = cuda_ode.ionic_model(tor.generalized_rush_larsen)
    b1n, noden, b7n = spec.step.__name__, spec.node_step.__name__, spec.multi_step.__name__
    n = solver.V.ndofs
    n_b1 = n_b1 or n
    S_, NP, f32 = len(tor._STATE_NAMES), len(tor._PARAM_NAMES), 4
    names = tor._STATE_NAMES
    ops = IONIC_OPS_PER_NODE[model]

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32).contiguous()

    def per_row(e):
        return " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e))

    init = tor.init_state_values()
    S0 = on_card(kc.check_states(model, n_b1, rng))
    v = on_card(rng.uniform(-90.0, 40.0, n_b1))
    if n_b1 == n:
        S0_lv, v_lv = S0, v
    else:
        S0_lv = on_card(kc.check_states(model, n, rng))
        v_lv = on_card(rng.uniform(-90.0, 40.0, n))
    table = np.stack([tor.init_parameter_values(i_Stim_Amplitude=0.0, celltype=ct) for ct in kc.CELLTYPES])
    state_sets = kc.step_check_states(S0, model)
    rows = {}

    # B1 per celltype; its per-node form on each celltype's uniform field
    # gives B1's bits
    b1_abs, b1_err = 0.0, torch.zeros(S_, dtype=torch.float64, device=dev)
    for i, ct in enumerate(kc.CELLTYPES):
        ct_err = torch.zeros(S_, dtype=torch.float64, device=dev)
        for _, S in state_sets:
            for dt in (0.025, 0.05):
                a, e = kc.ionic_step_errors(spec.step, spec.step_twin, S, v, 1.0, dt, table[i])
                b1_abs, ct_err = max(b1_abs, a), torch.maximum(ct_err, e)
        print(f"[kernels] {b1n} one step, n={n_b1}, celltype {ct:g}, all state sets and dt: per row "
              f"|k-w| beyond 1 ulp / max|increment|: {per_row(ct_err)}")
        require(bool((ct_err <= kc.IONIC_STEP_TOL).all()),
                f"{b1n} one-step increments agree with its twin, celltype {ct:g}")
        b1_err = torch.maximum(b1_err, ct_err)
        uniform = on_card(np.tile(table[i][:, None], (1, n_b1)))
        a, b = S0.clone(), S0.clone()
        spec.step(a, v, 1.0, DT, table[i])
        spec.node_step(b, v, 1.0, DT, uniform)
        require(torch.equal(a, b), f"{noden} on a uniform field of celltype {ct:g} gives {b1n}'s bits")
        del uniform

    # the per-node form on a field of mixed celltypes, per celltype's nodes
    cts = rng.integers(0, len(kc.CELLTYPES), n_b1)
    mixed = on_card(table[cts].T)
    groups = {f"celltype {ct:g}": torch.as_tensor(np.nonzero(cts == i)[0], device=dev)
              for i, ct in enumerate(kc.CELLTYPES)}
    node_abs, node_err = 0.0, {g: torch.zeros(S_, dtype=torch.float64, device=dev) for g in groups}
    for _, S in state_sets:
        for dt in (0.025, 0.05):
            out = kc.ionic_step_errors_by_group(spec.node_step, spec.step_twin, S, v, 1.0, dt, mixed, groups)
            for g, (a, e) in out.items():
                node_abs, node_err[g] = max(node_abs, a), torch.maximum(node_err[g], e)
    for g, e in node_err.items():
        print(f"[kernels] {noden} one step, mixed field, {g}: per row {per_row(e)}")
        require(bool((e <= kc.IONIC_STEP_TOL).all()), f"{noden} one-step increments agree, {g}")

    # B7: the LV's own layer index and table, every 97th node in no layer
    index, lv_table = lv_layers(solver)
    index = index.clone()
    index[::97] = -1
    layer_of = {i: f"celltype {CELLTYPES[m]:g}" for i, m in enumerate(sorted(CELLTYPES))}
    b7_groups = {name: torch.nonzero(index == i).flatten() for i, name in layer_of.items()}
    b7_groups["no layer"] = torch.nonzero(index < 0).flatten()
    lv_table_np = lv_table.double().cpu().numpy()

    def b7(S, v, t, dt, p):
        return spec.multi_step(S, v, index, t, dt, lv_table)

    def b7_twin(S, v, t, dt, p):
        return spec.multi_step_twin(S, v, index, t, dt, lv_table_np)

    b7_abs, b7_err = 0.0, {g: torch.zeros(S_, dtype=torch.float64, device=dev) for g in layer_of.values()}
    for _, S in kc.step_check_states(S0_lv, model):
        for dt in (0.025, 0.05):
            for g, (a, e) in kc.ionic_step_errors_by_group(b7, b7_twin, S, v_lv, 1.0, dt, None, b7_groups).items():
                if g == "no layer":
                    require(a == 0.0, f"{b7n} leaves the nodes of no layer as they were")
                    continue
                b7_abs, b7_err[g] = max(b7_abs, a), torch.maximum(b7_err[g], e)
    for g, e in b7_err.items():
        print(f"[kernels] {b7n} one step, {g} ({b7_groups[g].numel()} nodes): per row {per_row(e)}")
        require(bool((e <= kc.IONIC_STEP_TOL).all()), f"{b7n} one-step increments agree, {g}")

    # one paced beat (the model's own stimulus at 0-1 ms) of
    # TORORD_BEAT_CELLS cells per kernel: B1 in endo, the per-node form on
    # a mixed field, B7 on cells spread over the LV in their layers
    m = TORORD_BEAT_CELLS
    beat0 = on_card(np.tile(init[:, None], (1, m)) * (1 + 0.01 * rng.standard_normal((S_, m))))
    paced = np.stack([tor.init_parameter_values(celltype=ct) for ct in kc.CELLTYPES])
    cts_b = rng.integers(0, len(kc.CELLTYPES), m)
    mixed_b = on_card(paced[cts_b].T)
    sample = torch.as_tensor(np.linspace(0, n - 1, m).astype(np.int64), device=dev)
    index_b = lv_layers(solver)[0][sample].contiguous()
    paced_layers = np.stack([tor.init_parameter_values(celltype=CELLTYPES[mk]) for mk in sorted(CELLTYPES)])
    paced_layers_b = on_card(paced_layers)
    beats = {
        b1n: (spec.step, spec.step_twin, paced[0], {"celltype 0": None}),
        noden: (spec.node_step, spec.step_twin, mixed_b,
                {f"celltype {ct:g}": torch.as_tensor(np.nonzero(cts_b == i)[0], device=dev)
                 for i, ct in enumerate(kc.CELLTYPES)}),
        b7n: (
            lambda S, v, t, dt, p: spec.multi_step(S, v, index_b, t, dt, paced_layers_b),
            lambda S, v, t, dt, p: spec.multi_step_twin(S, v, index_b, t, dt, paced_layers),
            None, {name: torch.nonzero(index_b == i).flatten() for i, name in layer_of.items()}),
    }
    tic = time.perf_counter()  # the three beats side by side, a CUDA stream each
    outs = kc.ionic_beats_errors_by_group([(step, twin, beat0, p, bgroups)
                                           for step, twin, p, bgroups in beats.values()],
                                          n_steps=TORORD_BEAT_STEPS)
    took = time.perf_counter() - tic
    for name, out in zip(beats, outs):
        for g, (a, e) in out.items():
            print(f"[kernels] {name} one beat, {g} ({m} cells in all, {TORORD_BEAT_STEPS} steps of {kc.BEAT_DT} ms, "
                  f"the three forms' beats {took:.1f} s), max|k-w| {a:.3e}; per row max|k-w| / max excursion: "
                  f"{per_row(e)}")
            require(bool((e <= kc.IONIC_BEAT_TOL).all()), f"{name} agrees with its twin over one beat, {g}")

    scratch, scratch_lv = S0.clone(), S0_lv.clone()
    p0 = table[0]
    b1_bytes = 2 * S_ * n_b1 * f32  # S - 1 rows and the injected v read, S rows written
    rows[b1n] = row(
        (b1_abs, float(b1_err.max())),
        time_ms(lambda: spec.step(scratch, v, 1.0, 0.025, p0)),
        time_ms(lambda: spec.step_twin(scratch, v, 1.0, 0.025, p0), launches=5, reps=3),
        bound(b1_bytes, ops * n_b1), None,
    )
    rows[noden] = row(
        (node_abs, max(float(e.max()) for e in node_err.values())),
        time_ms(lambda: spec.node_step(scratch, v, 1.0, 0.025, mixed)),
        time_ms(lambda: spec.step_twin(scratch, v, 1.0, 0.025, mixed), launches=5, reps=3),
        bound(b1_bytes + NP * n_b1 * f32, ops * n_b1), None,
    )
    rows[b7n] = row(
        (b7_abs, max(float(e.max()) for e in b7_err.values())),
        time_ms(lambda: b7(scratch_lv, v_lv, 1.0, 0.025, None)),
        time_ms(lambda: b7_twin(scratch_lv, v_lv, 1.0, 0.025, None), launches=5, reps=3),
        bound(2 * S_ * n * f32 + n * 4, ops * n), None,  # and the model index
    )
    dev_us = {
        b1n: device_us_per_call(lambda: spec.step(scratch, v, 1.0, 0.025, p0)),
        noden: device_us_per_call(lambda: spec.node_step(scratch, v, 1.0, 0.025, mixed)),
        b7n: device_us_per_call(lambda: b7(scratch_lv, v_lv, 1.0, 0.025, None)),
    }
    torch.cuda.synchronize()
    print(f"[kernels] device time per call (torch.profiler, us; B1's forms at n={n_b1}, B7 at n={n}): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    print_rows(rows)
    return rows


def phase_torord_lv_parity(model: str = "torord_dyncl") -> None:
    from fenicsx_beat_tpu_torch.benchmarks.lv import MODELS, run_lv
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    b7 = cuda_ode.ionic_model(MODELS[model].generalized_rush_larsen).multi_step.__name__
    ref, ref_share = JAX_LV_PSIZE03_PROBES[model]
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_lv(psize=LV_CHECK_PSIZE, dt=DT, T=LV_T, device=DEVICE, precond="jacobi", model=model,
                 prepace=False)
    dev = {k: abs(res.probes[k] - v) for k, v in ref.items()}
    print(f"[{LV_TAGS[model]}_parity] psize {LV_CHECK_PSIZE}, {model} layers unpaced: n={res.n_nodes}, probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.probes.items())
          + "; |probe - JAX| " + ", ".join(f"{k}={d:.3f}" for k, d in dev.items())
          + f"; activated share {res.activated_share:.4f} (JAX {ref_share}); "
          f"launches {json.dumps({k: w.launches for k, w in wrappers.items() if w.launches})}")
    require(res.all_finite, f"psize 0.3 {model} LV states finite")
    require(wrappers[b7].launches > 0, f"the {model} LV runs {b7}")
    require(max(dev.values()) <= DT + 1e-6, f"{model} LV probe activation times within one dt of the JAX values")


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
    require(launches["torord_grl_step_v"] > 0, "torord_grl_step_v launched on the slab path")
    require_structured_pcg(launches, "the slab path")
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

    wrappers = kernel_wrappers()
    launches = {}
    # TP06: the main path's configuration
    ref = _build_solver(dx=0.1, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
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

    launches.update(lv_node_path(lv_solver, t0))
    return launches


def lv_node_path(lv_solver, t0: float) -> dict:
    """The LV of ``lv_solver`` (ToR-ORd or ToR-ORd + Land layers) from its
    state at ``t0`` for 10 ms with its layers as a per-node parameter field
    (B1's per-node form), against the same window on its layer table (B7):
    every state and activation time equal.  Returns the per-node form's
    launches."""
    import torch

    spec = lv_solver._ionic_groups[0].model
    node, multi = spec.node_step.__name__, spec.multi_step.__name__
    wrappers = kernel_wrappers()
    index, table = lv_layers(lv_solver)
    field = table.index_select(0, index.long()).T.double().cpu().numpy()
    fld = field_solver(lv_solver, spec.module.generalized_rush_larsen, field,
                       lv_solver.states.double().cpu().numpy())
    fld.activation_time = lv_solver.activation_time.clone()
    zero_launches(wrappers)  # counted over the field run alone
    res = fld.run_chunk(t0, DT, 200)
    launches = {node: wrappers[node].launches}
    multi_before = wrappers[multi].launches
    lv_solver.run_chunk(t0, DT, 200)  # the same window on the layer table
    same = torch.equal(fld.states, lv_solver.states) and torch.equal(fld.activation_time, lv_solver.activation_time)
    print(f"[node_paths] {spec.name} LV psize {LV_PSIZE}, layers as a ({field.shape[0]}, {field.shape[1]}) field, "
          f"{t0:g} to {res.t:g} ms: states and activation times equal to the B7 run: {same}; max|dV| "
          f"{float((fld.v - lv_solver.v).abs().max()):.3e}; {node} launches {launches[node]}, {multi} "
          f"{multi_before} in the field run")
    require(same, f"the {spec.name} LV on its per-node field equals the run on its layer table")
    require(launches[node] > 0 and multi_before == 0, f"the field run launched {node} and not {multi}")
    return launches


def phase_mixed_setup():
    """Path M's solver at full width (the dx=0.1 slab, TP06 | Land at x =
    10 mm), its host setup timed, and its mixed groups."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.mixed import build_mixed_solver
    from fenicsx_beat_tpu_torch.benchmarks.niederer import benchmark_points

    tic = time.perf_counter()
    solver = build_mixed_solver(dx=MIXED_DX, device=DEVICE, probe_points=np.array(list(benchmark_points().values())),
                                operator_cache_key=CACHE_KEY)
    torch.cuda.synchronize()
    setup = time.perf_counter() - tic
    print(f"[mixed] dx={MIXED_DX}: n={solver.V.ndofs} nodes, union states {tuple(solver.states.shape)} "
          f"({solver.states.numel() * 4 / 1e6:.1f} MB), {solver._ionic.name}, blocks per model "
          + ", ".join(f"{g.model.name} {g.blocks.numel()}" for g in solver._ionic_groups)
          + f", host setup {setup:.1f} s")
    require(solver.V.ndofs == N_MAIN and solver._ionic.name == "tp06+torord_dyncl_land",
            "Path M at full width, TP06 and Land")
    return solver, setup


def _mixed_step_check(tag: str, step, twin, S0, v, groups: dict, state_models, rows_of: dict) -> tuple:
    """One step of B7's mixed form (``step``) and its twin from ``S0`` and
    each of the models' slow-row sets, both dt: per group of nodes, every
    state row within the one-step limit; nodes of no marker bit for bit.
    Returns each model group's (max abs, worst per-row error)."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc

    sets = [("physiological", S0)]
    for model in state_models:
        sets += kc.step_check_states(S0, model)[1:]
    worst_abs = dict.fromkeys(groups, 0.0)
    err = {g: torch.zeros(S0.shape[0], dtype=torch.float64, device=S0.device) for g in groups}
    for _, S in sets:
        for dt in (0.025, 0.05):
            for g, (a, e) in kc.ionic_step_errors_by_group(step, twin, S, v, 1.0, dt, None, groups).items():
                if g == "no marker":
                    require(a == 0.0, f"{tag}: the nodes of no marker keep their states, V injected, bit for bit")
                    continue
                worst_abs[g], err[g] = max(worst_abs[g], a), torch.maximum(err[g], e)
    for g, e in err.items():
        if g == "no marker":
            continue
        names = rows_of[g]
        print(f"[mixed_kernels] {tag}, {g} nodes ({groups[g].numel()}), all state sets and dt: per row |k-w| "
              "beyond 1 ulp / max|increment|: " + " ".join(f"{nm}={float(x):.2e}" for nm, x in zip(names, e)))
        require(bool((e[: len(names)] <= kc.IONIC_STEP_TOL).all()), f"{tag}: one-step increments agree, {g}")
        require(bool((e[len(names):] == 0).all()), f"{tag}: rows beyond {g}'s own stay as they were")
    return {g: (worst_abs[g], float(e.max())) for g, e in err.items() if g != "no marker"}


def phase_mixed_kernels(solver, seed: int = 5) -> dict:
    """B7's mixed-model form against its twin at the main path's width
    (n = 442,401), in two cases: Path M's own groups (TP06 | Land split at
    x = 10 mm; the union [52, n]) and TP06 | FHN | no marker drawn node by
    node (every block holds all three; FHN's voltage row 1 exercises the
    swaps).  Launches per model, blocks per model, each launch's time
    against its bound."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.mixed import LAND_MARKER, TP06_MARKER, mixed_markers
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.models import torord_dyncl_land as land
    from fenicsx_beat_tpu_torch.ops import cuda_ode
    from fenicsx_beat_tpu_torch.splitting import check_ionic_scope, ionic_layer

    rng = np.random.default_rng(seed)
    dev = torch.device(DEVICE)
    n, f32 = solver.V.ndofs, 4

    def on_card(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(torch.float32).contiguous()

    # case A: Path M's groups, TP06 nodes from TP06's check states, Land's from Land's
    groups = solver._ionic_groups
    markers = mixed_markers(solver.V.dof_coords)
    S = np.zeros((52, n))
    S[:19] = kc.check_states("tp06", n, rng)
    land_nodes = markers == LAND_MARKER
    S[:, land_nodes] = kc.check_states("torord_dyncl_land", n, rng)[:, land_nodes]
    S0, v = on_card(S), on_card(rng.uniform(-90.0, 40.0, n))
    node_groups = {"tp06": torch.as_tensor(np.nonzero(markers == TP06_MARKER)[0], device=dev),
                   "torord_dyncl_land": torch.as_tensor(np.nonzero(land_nodes)[0], device=dev)}

    def step(S_, v_, t, dt, _p):
        return cuda_ode.mixed_multi_step(S_, v_, groups, t, dt)

    def twin(S_, v_, t, dt, _p):
        return cuda_ode.mixed_multi_step_twin(S_, v_, groups, t, dt)

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    step(S0.clone(), v, 1.0, DT, None)
    once = {g.model.name: g.model.multi_step.launches for g in groups}
    print(f"[mixed_kernels] one mixed step: launches per model {json.dumps(once)}")
    require(all(c == 1 for c in once.values()), "one launch per model a step")
    errs = _mixed_step_check("TP06 | Land along x", step, twin, S0, v, node_groups, ("tp06", "torord_dyncl_land"),
                             {"tp06": tp06._STATE_NAMES, "torord_dyncl_land": land._STATE_NAMES})

    # case B: TP06 | FHN | no marker, node by node, on the union [19, n]
    mk = rng.choice([1, 2, 9], n)
    funs = {1: tp06.generalized_rush_larsen, 2: fhn.generalized_rush_larsen}
    init = {1: tp06.init_state_values(), 2: fhn.init_state_values()}
    params = {1: tp06.init_parameter_values(stim_amplitude=0.0), 2: fhn.init_parameter_values(b=0.02)}
    v_idx = {1: tp06.state_index("V"), 2: fhn.state_index("v")}
    layers = [ionic_layer(check_ionic_scope(funs, mk, init, params, v_idx), funs, mk, init, params, v_idx, n, dev,
                          torch.float32, k) for k in (True, False)]
    SB = kc.check_states("tp06", n, rng)
    SB[0, mk == 2] = rng.uniform(-90.0, 40.0, int((mk == 2).sum()))  # FHN's v, stored in row 0
    SB[1, mk == 2] = rng.uniform(0.0, 60.0, int((mk == 2).sum()))  # FHN's s, in v's own row
    groups_b = {"tp06": torch.as_tensor(np.nonzero(mk == 1)[0], device=dev),
                "fhn": torch.as_tensor(np.nonzero(mk == 2)[0], device=dev),
                "no marker": torch.as_tensor(np.nonzero(mk == 9)[0], device=dev)}
    _mixed_step_check("TP06 | FHN | no marker inside blocks", lambda S_, v_, t, dt, _p: layers[0].step(S_, v_, t, dt),
                      lambda S_, v_, t, dt, _p: layers[1].step(S_, v_, t, dt), on_card(SB), v, groups_b, ("tp06",),
                      {"tp06": tp06._STATE_NAMES, "fhn": ["v", "s"]})
    print("[mixed_kernels] TP06 | FHN | no marker: blocks per model "
          + ", ".join(f"{g.model.name} {g.blocks.numel()}" for g in layers[0].groups) + f" of {-(-n // 256)}")

    # timings: each model's launch over its blocks, and the whole step
    scratch = S0.clone()
    rows, dev_us = {}, {}
    total_bound = 0.0
    for g in groups:
        S_m = g.model.num_states
        own = int((g.index >= 0).sum())
        in_blocks = min(int(g.blocks.numel()) * 256, n)
        nbytes = own * 2 * S_m * f32 + in_blocks * 4  # S-1 rows and v read, S written; the blocks' index
        b = bound(nbytes, IONIC_OPS_PER_NODE[g.model.name] * own)
        total_bound += b[0]
        name = f"{g.model.multi_step.__name__}[mixed]"
        rows[name] = row(
            errs[g.model.name],
            time_ms(lambda g=g: g.model.multi_step(scratch, v, g.index, 1.0, 0.025, g.table, blocks=g.blocks)),
            time_ms(lambda g=g: cuda_ode.mixed_multi_step_twin(scratch, v, [g], 1.0, 0.025), launches=5, reps=3),
            b, None,
        )
        dev_us[name] = device_us_per_call(
            lambda g=g: g.model.multi_step(scratch, v, g.index, 1.0, 0.025, g.table, blocks=g.blocks))
        print(f"[mixed_kernels] {name}: {own} own nodes in {g.blocks.numel()} blocks, {nbytes / 1e6:.1f} MB, "
              f"bound {b[0] * 1e3:.2f} us ({b[1]})")
    whole = time_ms(lambda: cuda_ode.mixed_multi_step(scratch, v, groups, 1.0, 0.025))
    whole_us = device_us_per_call(lambda: cuda_ode.mixed_multi_step(scratch, v, groups, 1.0, 0.025))
    torch.cuda.synchronize()
    print("[mixed_kernels] device time per call (torch.profiler, us): "
          + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items())
          + f"; the whole mixed step {whole:.4f} ms back to back, {whole_us:.2f} us device, bound "
          f"{total_bound * 1e3:.2f} us")
    print_rows(rows)
    return rows


def phase_mixed_path(solver, setup_s: float) -> dict:
    """Path M at full width: the dx=0.1 two-model slab, Strang, dt=0.05,
    40 ms, through ``benchmarks/mixed.py:run_mixed_slab`` on the kernels
    (launch counts zeroed before, read after: both models' B7 and B2-B4 > 0):
    ms/s, CG iterations and host syncs per step, P1-P9, launches per model,
    the share of blocks that hold two models.  Then the first
    MIXED_TWIN_TIMES again on the kernels, from the same states and from
    states one ulp away, and on the twins: at each of MIXED_TWIN_TIMES, v at
    every node of the kernel run within 3x float32's noise (the distance of
    the kernels' one-ulp run to their own, as phase 13 holds the bidomain)
    of the twin run, the gap over each model's nodes printed."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.bidomain_scale import perturb_states
    from fenicsx_beat_tpu_torch.benchmarks.mixed import TP06_MARKER, build_mixed_solver, mixed_markers, run_mixed_slab
    from fenicsx_beat_tpu_torch.benchmarks.niederer import benchmark_points

    init, act0 = solver.states.clone(), solver.activation_time.clone()
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_mixed_slab(dx=MIXED_DX, T=MIXED_T, solver=solver)
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"[mixed] dx={MIXED_DX} {res.model}, {res.n_nodes} nodes (markers {res.marker_nodes}), Strang dt={DT} "
          f"{res.simulated_ms:g} ms: ms_per_s={res.ms_per_second:.3f} (wall {res.wall_s:.3f} s, host setup "
          f"{setup_s:.1f} s), cg_iters max={res.cg_iters_max} mean={res.cg_iters_mean:.3f} "
          f"({prior_cg('mixed', res.cg_iters_mean)}), host_syncs_per_step="
          f"{res.host_syncs_per_step:.3f}; B7 launches per model {json.dumps(res.launches)}, blocks per model "
          f"{json.dumps(res.blocks_per_model)} of {res.n_blocks}, two-model share {res.two_model_share:.3e}")
    print("[mixed] P1-P9: " + ", ".join(f"{k}={v:.2f}" for k, v in res.activation_times.items()))
    print(f"[mixed] launches {json.dumps({k: v for k, v in launches.items() if v})}")
    require(res.all_finite, "Path M's states finite")
    for name in ("tp06_grl_multi_step_v", "torord_land_grl_multi_step_v"):
        require(launches[name] > 0, f"{name} launched on Path M")
    require_structured_pcg(launches, "Path M")
    require(res.activation_times["P1"] >= 0 and res.activation_times["P3"] >= 0,
            "Path M's wave started in the TP06 half and reached the Land half")

    def windows(x, seed):
        """v at each of MIXED_TWIN_TIMES of ``x`` from the initial states,
        moved by one ulp at random when ``seed`` is given; (vs, seconds)."""
        x.states, x.activation_time = init.clone(), act0.clone()
        if seed is not None:
            perturb_states(x, seed)
        torch.cuda.synchronize()
        tic, t0, vs = time.perf_counter(), 0.0, []
        for t1 in MIXED_TWIN_TIMES:
            x.solve((t0, t1), dt=DT)
            vs.append(x.v.double().clone())
            t0 = t1
        torch.cuda.synchronize()
        return vs, time.perf_counter() - tic

    twin = build_mixed_solver(dx=MIXED_DX, device=DEVICE, use_kernels=False,
                              probe_points=np.array(list(benchmark_points().values())), operator_cache_key=CACHE_KEY)
    (vk, _), (vk2, _) = windows(solver, None), windows(solver, 1)
    vw, wall_w = windows(twin, None)
    require(bool(torch.isfinite(twin.states).all()), "Path M's twin run is finite")
    tp06_half = torch.as_tensor(mixed_markers(solver.V.dof_coords) == TP06_MARKER, device=vk[0].device)
    print(f"[mixed] {MIXED_TWIN_TIMES[-1]:g} ms on the twins: {MIXED_TWIN_TIMES[-1] / wall_w:.3f} ms/s")
    for i, t in enumerate(MIXED_TWIN_TIMES):
        d, dk = (vk[i] - vw[i]).abs(), (vk[i] - vk2[i]).abs()
        gap, noise = float(d.max()), float(dk.max())
        halves = {name: (float(d[m].max()), float(dk[m].max())) for name, m in (("TP06", tp06_half), ("Land", ~tp06_half))}
        print(f"[mixed] at {t:g} ms: twins v_max {float(vw[i].max()):.3f} mV, share above 0 mV "
              f"{float((vw[i] > 0).double().mean()):.4f}; kernels vs twins max|dv| {gap:.3e} mV at every node, "
              f"float32 noise (the kernel run from states one ulp away) {noise:.3e} mV "
              f"(limit {ODE_NOISE_FACTOR:g}x, {gap / noise:.2f}x); per half, gap / kernels' noise: "
              + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b) in halves.items()))
        require(gap <= ODE_NOISE_FACTOR * noise, f"Path M's kernel run within 3x float32's noise of its twin "
                                                 f"run at {t:g} ms")
    return {"tp06_grl_multi_step_v[mixed]": launches["tp06_grl_multi_step_v"],
            "torord_land_grl_multi_step_v[mixed]": launches["torord_land_grl_multi_step_v"]}


def phase_mixed_dx05() -> None:
    """Path M at dx=0.5 on the kernels against the JAX package's float64
    P1-P9: each within one dt (those that do not fire by 40 ms at this
    size on either side: -1 on both)."""
    from fenicsx_beat_tpu_torch.benchmarks.mixed import run_mixed_slab

    res = run_mixed_slab(dx=0.5, T=MIXED_T, device=DEVICE)
    gaps = {k: abs(res.activation_times[k] - v) for k, v in JAX_MIXED_DX05.items()}
    print(f"[mixed_dx05] n={res.n_nodes}, {res.simulated_ms:g} ms: P1-P9 "
          + ", ".join(f"{k}={v:.2f}" for k, v in res.activation_times.items())
          + "; |P - P_jax| " + ", ".join(f"{k}={d:.3f}" for k, d in gaps.items())
          + f"; launches per model {json.dumps(res.launches)}")
    require(res.all_finite, "Path M at dx=0.5 finite")
    require(max(gaps.values()) <= DT + 1e-6, "Path M's dx=0.5 probes within one dt of the JAX values")


class CacheLedger:
    """The operator disk cache over one run, as the solvers use it: every
    assembly given a ``cache_key`` (``fem``'s two entry points) timed, the
    slot it read or wrote, each slot's cold assembly (its miss, the store
    apart) and store, and each hit.  Saved = the sum over hits of the slot's
    cold assembly less the hit, less every store.  The first cold pair (the
    dx=0.1 slab's, phase 3) is kept for phase 21 (e)."""

    def __init__(self):
        from fenicsx_beat_tpu_torch import cache, fem

        self.cold, self.stores, self.hits = {}, {}, []
        self.first = None  # (slot, pair)
        self._read = None
        load, store = cache.load_arrays, fem._operator_cache_store

        def read(path):
            out = load(path)
            self._read = (path, out is not None)
            return out

        def timed_store(path, mass, stiff):
            tic = time.perf_counter()
            store(path, mass, stiff)
            self.stores[path] = time.perf_counter() - tic

        cache.load_arrays = read
        fem._operator_cache_store = timed_store
        for name in ("assemble_mass_stiffness_stencil", "assemble_mass_stiffness"):
            setattr(fem, name, self._timed(getattr(fem, name)))

    def _timed(self, fn):
        def timed(*args, **kw):
            if kw.get("cache_key") is None:
                return fn(*args, **kw)
            self._read = None
            tic = time.perf_counter()
            out = fn(*args, **kw)
            seconds = time.perf_counter() - tic
            if out is None or self._read is None:
                return out  # a stencil the mesh declined: no slot
            path, hit = self._read
            if hit:
                self.hits.append((path, seconds))
            else:
                self.cold[path] = seconds - self.stores.get(path, 0.0)
                if self.first is None:
                    self.first = (path, out)
            return out

        return timed

    def adopt(self, proc) -> dict:
        """Wait for the :func:`prefetch` process ``proc`` and take its
        slots' cold assemblies and stores as this run's (its hits here
        saved them); returns its report."""
        out, err = proc.communicate(timeout=900)
        require(proc.returncode == 0, f"chip_smoke.py --prefetch ran on the host (exit {proc.returncode}): "
                                      f"{err[-2000:]}")
        report = json.loads(out.strip().splitlines()[-1])
        self.cold.update({Path(k): v for k, v in report["cold"].items()})
        self.stores.update({Path(k): v for k, v in report["stores"].items()})
        return report

    def saved(self) -> tuple[float, float]:
        """(seconds the hits saved less the stores, seconds of the stores)."""
        gained = sum(self.cold[path] - s for path, s in self.hits if path in self.cold)
        stored = sum(self.stores.values())
        return gained - stored, stored


def cache_summary(ledger: CacheLedger, phase21_s: float) -> None:
    """The operator cache over the run: slots, hits, seconds saved, against
    phase 21's seconds and nvcc's for the forward-Euler sources."""
    from fenicsx_beat_tpu_torch._build import load_library, source_seconds

    saved, stored = ledger.saved()
    fe = {k: v for k, v in source_seconds(load_library().compiler_output).items() if "_fe" in k}
    nvcc_fe = sum(cpu for _, cpu in fe.values())
    built = load_library().build_seconds
    print(f"[cache] {len(ledger.cold)} pairs assembled and stored ({stored:.1f} s of stores), {len(ledger.hits)} "
          f"loads: {saved:.1f} s saved net of the stores; phase 21 {phase21_s:.1f} s and nvcc for the "
          f"forward-Euler sources {nvcc_fe:.1f} s (CPU seconds of each source's nvcc, summed; wall from the "
          "parallel build's start: " + ", ".join(f"{k} {w:.1f} / {c:.1f}" for k, (w, c) in sorted(fe.items()))
          + f"; the whole build {built:.1f} s wall): {phase21_s + nvcc_fe:.1f} s against {saved:.1f} s saved")


def fe_form_rows(seed: int = 21) -> dict:
    """Phase 21 (d): one step of each forward-Euler kernel (B1 with one
    parameter set, B1's per-node form on a field of mixed celltypes, B7
    with the celltypes as layers and 2% of the nodes in none) against its
    twin at its path's width (TP06 n = 442,401, ToR-ORd and Land the psize
    0.1 LV's 243,518), every state row by the one-step limits, nodes of no
    layer equal; B1's per-node form on a uniform field gives B1's bits.
    Each timed beside its twin (no library call computes it).  Returns the
    rows."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.lv import MODELS
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    rng = np.random.default_rng(seed)
    rows = {}
    for name, module, n in (("tp06", tp06, N_MAIN), ("torord_dyncl", MODELS["torord_dyncl"], N_LV),
                            ("torord_dyncl_land", MODELS["torord_dyncl_land"], N_LV)):
        spec = cuda_ode.ionic_model(module.forward_euler)
        S_, NP = spec.num_states, spec.num_params
        stim = "stim_amplitude" if "stim_amplitude" in module._PARAM_NAMES else "i_Stim_Amplitude"
        table = np.stack([module.init_parameter_values(**{stim: 0.0}, celltype=ct) for ct in kc.CELLTYPES])
        states = kc.check_states(name, n, rng)
        v = rng.uniform(-90.0, 40.0, n)
        tic = time.perf_counter()
        res = kc.ionic_form_checks(spec, states, v, table, None, rng, beat_steps=0)
        for form, r in res["forms"].items():
            worst, top = 0.0, 0.0
            for (t, dt, g), (a, e) in r["step"].items():
                if g == "no layer":
                    require(a == 0.0, f"{form} leaves the nodes of no layer as they were")
                    continue
                worst, top = max(worst, float(e.max())), max(top, a)
            print(f"[fused_scope] (d) {form} one step at n={n}, t 0.5 and 2.0 ms, dt 0.025 and 0.05: "
                  f"max|k-w| {top:.3e}, worst row |k-w| beyond 1 ulp / max|increment| {worst:.3e} "
                  f"(limit {kc.IONIC_STEP_TOL:g})")
            require(worst <= kc.IONIC_STEP_TOL, f"{form} one-step increments agree with its twin")
            res["forms"][form]["err"] = (top, worst)
        require(res["uniform_bits"], f"{spec.node_step.__name__} on a uniform field gives "
                                     f"{spec.step.__name__}'s bits")
        inp = res["inputs"]
        S0, S0s, vk, fld = inp["S0"], inp["S0_storage"], inp["v"], inp["field"]
        scratch, scratch_s = S0.clone(), S0s.clone()
        ops = IONIC_OPS_PER_NODE[name] * n  # the GRL count: forward Euler drops the gates' exp
        b1_bytes = 2 * S_ * n * 4  # S - 1 rows and v read, S rows written
        timed = {
            spec.step.__name__: (lambda: spec.step(scratch, vk, 1.0, 0.025, table[0]),
                                 lambda: spec.step_twin(scratch, vk, 1.0, 0.025, table[0]), b1_bytes),
            spec.node_step.__name__: (lambda: spec.node_step(scratch, vk, 1.0, 0.025, fld),
                                      lambda: spec.step_twin(scratch, vk, 1.0, 0.025, fld),
                                      b1_bytes + NP * n * 4),
            spec.multi_step.__name__: (lambda: inp["b7"](scratch_s, vk, 1.0, 0.025, None),
                                       lambda: inp["b7_twin"](scratch_s, vk, 1.0, 0.025, None),
                                       b1_bytes + n * 4),  # and the model index
        }
        for form, (kern, twin, nbytes) in timed.items():
            rows[form] = row(res["forms"][form]["err"], time_ms(kern), time_ms(twin, launches=5, reps=3),
                             bound(nbytes, ops), None)
        dev_us = {form: device_us_per_call(kern) for form, (kern, _, _) in timed.items()}
        torch.cuda.synchronize()
        print("[fused_scope] (d) device time per call (torch.profiler, us): "
              + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
        print(f"[fused_scope] (d) {spec.name}: checks and timings {time.perf_counter() - tic:.1f} s")
        del res, inp, scratch, scratch_s
    print_rows(rows)
    return rows


def fe_paths(base) -> dict:
    """Phase 21 (d): every forward-Euler kernel on a path, the dx=0.1
    Niederer slab at dt :data:`FE_DT` for :data:`FE_STEPS` steps, Strang:
    TP06's B1 on the kernels and on the twins (max|dv| < 1e-2), ToR-ORd's
    and Land's B1, then one marker layer of six x bands, each model on a
    field (B1's per-node form) and on a vector (B7's mixed form); counts
    set to 0 before each run and read after it, every state finite."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import THRESHOLD
    from fenicsx_beat_tpu_torch.benchmarks.lv import MODELS
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    models = {"tp06": tp06, "torord_dyncl": MODELS["torord_dyncl"], "torord_dyncl_land": MODELS["torord_dyncl_land"]}
    specs = {k: cuda_ode.ionic_model(m.forward_euler) for k, m in models.items()}
    wrappers = {f.__name__: f for s in specs.values() for f in (s.step, s.node_step, s.multi_step)}

    def params(m, **kw):
        stim = "stim_amplitude" if "stim_amplitude" in m._PARAM_NAMES else "i_Stim_Amplitude"
        return m.init_parameter_values(**{stim: 0.0}, **kw)

    def run(solver, tag):
        zero_launches(wrappers)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        solver.solve((0.0, FE_STEPS * FE_DT), dt=FE_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        finite = bool(torch.isfinite(solver.states).all())
        print(f"[fused_scope] (d) {tag}: {FE_STEPS} steps of {FE_DT} ms in {wall:.3f} s, finite {finite}, "
              f"v range [{float(solver.v.min()):.2f}, {float(solver.v.max()):.2f}] mV, launches {json.dumps(counts)}")
        require(finite, f"{tag}: every state finite")
        return counts

    launches = {}
    for key, m in models.items():
        s = dataclasses.replace(base, ode_fun=m.forward_euler, init_states=m.init_state_values(),
                                parameters=params(m), v_index=0)
        counts = run(s, f"{specs[key].name} B1 on the slab")
        name = specs[key].step.__name__
        require(counts.get(name, 0) == 2 * FE_STEPS, f"{name} twice a step")
        launches[name] = counts.get(name, 0)
        if key == "tp06":
            twin = dataclasses.replace(s, use_kernels=False)
            twin.solve((0.0, FE_STEPS * FE_DT), dt=FE_DT)
            dv = float((s.v.double() - twin.v.double()).abs().max())
            print(f"[fused_scope] (d) TP06 forward Euler, dx=0.1 slab, dt {FE_DT} ms (JAX's float64 run finite "
                  f"there, tests/test_torch_ionic_fe.py), {FE_STEPS} steps: kernels vs twins max|dv| {dv:.3e} "
                  f"(limit {THRESHOLD:g})")
            require(dv < THRESHOLD, "the TP06 forward-Euler slab run's kernels vs twins max|dv| < 1e-2")
            del twin
        del s
    x = base.V.dof_coords[:, 0]
    n = x.shape[0]
    markers = np.digitize(x, np.linspace(0.0, 20.0, 7)[1:-1]).astype(np.int64)
    funs, init, prm = {}, {}, {}
    cts = np.random.default_rng(5).integers(0, 3, n).astype(float)
    for k, (key, m) in enumerate(models.items()):
        field = np.tile(params(m)[:, None], (1, n))
        field[m.parameter_index("celltype")] = cts
        funs[2 * k], init[2 * k], prm[2 * k] = m.forward_euler, m.init_state_values(), field
        funs[2 * k + 1], init[2 * k + 1], prm[2 * k + 1] = m.forward_euler, m.init_state_values(), params(m)
    layer = dataclasses.replace(base, ode_fun=funs, init_states=init, parameters=prm,
                                v_index={k: 0 for k in funs}, ode_markers=markers)
    del prm
    counts = run(layer, "six bands: each model on a field and on a vector")
    for spec in specs.values():
        for f in (spec.node_step, spec.multi_step):
            require(counts.get(f.__name__, 0) == 2 * FE_STEPS, f"{f.__name__} twice a step in the six bands")
            launches[f.__name__] = counts.get(f.__name__, 0)
    return launches


def phase_fused_scope(main: dict, mixed, ledger: CacheLedger) -> tuple[dict, dict, float]:
    """Phase 21: the fused solver's remaining scope on the card, (a)-(e)
    (module docstring).  ``main`` is phase 6's main path (P1-P9, ms/s, CG
    and host syncs per step), ``mixed`` Path M's solver.  Returns the
    forward-Euler kernels' rows and path launches and the phase's seconds."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch import fem, stimulation
    from fenicsx_beat_tpu_torch.benchmarks.mixed import TP06_MARKER, mixed_ionic
    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver, benchmark_points, run_niederer_benchmark
    from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    tic0 = time.perf_counter()
    wrappers = kernel_wrappers()
    part = Laps("[fused_scope]")

    # (a) merged Strang on the main path at full width
    zero_launches(wrappers)
    res = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, merge_strang_halves=True,
                                 operator_cache_key=CACHE_KEY)
    counts = {name: w.launches for name, w in wrappers.items() if w.launches}
    chunk = int(round(20.0 / DT))  # run_niederer_benchmark's chunks of 20 ms
    n_chunks = res.n_steps // chunk + 1  # and its warm-up chunk
    # the unmerged main path again, right after (the host sets ms/s: phase
    # 6's run is printed beside)
    unmerged = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
    at = [res.activation_times[f"P{i}"] for i in range(1, 10)]
    gaps = [abs(a - b) for a, b in zip(at, JAX_MERGED_DX01)]
    err = res.error_vs_published()
    per_chunk = counts["tp06_grl_step_v"] / n_chunks
    print(f"[fused_scope] (a) merged Strang, dx=0.1, {res.simulated_ms:g} ms: P1-P9 "
          + " ".join(f"{a:.2f}" for a in at) + "; |P - P_jax merged| "
          + ", ".join(f"P{i + 1}={g:.3f}" for i, g in enumerate(gaps))
          + f"; max_rel_err_vs_converged={err:.4%} (JAX's {JAX_MERGED_MAX_REL_ERR:.2%}); ms_per_s="
          f"{res.ms_per_second:.3f} beside the unmerged run after it {unmerged.ms_per_second:.3f} and phase 6's "
          f"{main['ms_per_s']:.3f}; cg_iters mean "
          f"{res.cg_iters_mean:.3f} (unmerged {main['cg_mean']:.3f}), host_syncs_per_step "
          f"{res.host_syncs_per_step:.3f} (unmerged {main['syncs']:.3f}); ionic launches per chunk of {chunk} "
          f"steps {per_chunk:g} (unmerged {2 * chunk}); launches {json.dumps(counts)}")
    require(max(gaps) <= DT + 1e-6, "merged P1-P9 within one dt of the JAX package's merged values")
    require(err is not None and err <= 0.05, "merged Strang within 5% of the converged published row")
    require(per_chunk == chunk + 1, "merged Strang: n_steps + 1 ionic launches a chunk")
    require_structured_pcg(counts, "the merged main path")

    part("(a)")
    # (b) the main path with its stimulus as a general space-time expression
    base = _build_solver(dx=0.1, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY,
                         probe_points=np.array(list(benchmark_points().values())))
    s1 = base.I_s
    w = s1.expr

    def window(x, t):
        return w.amplitude * ((t >= w.start) & (t <= w.start + w.duration)) * torch.ones_like(x[0])

    gen = dataclasses.replace(base, I_s=stimulation.Stimulus(expr=window, dZ=s1.dZ, marker=s1.marker))
    require(gen._b_units is None and gen._stim_terms[0][3] is None, "the general stimulus is assembled each step")
    amps = gen.stimulus_amplitudes()
    init, act0 = gen.states.clone(), gen.activation_time.clone()
    gen.run_chunk(0.0, DT, chunk, amps, probed=True)  # warm-up, discarded, as run_niederer_benchmark
    gen.states, gen.activation_time, gen.host_syncs, gen.cg_iterations = init, act0, 0, 0
    zero_launches(wrappers)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    t, probes = 0.0, None
    for _ in range(int(round(40.0 / (chunk * DT)))):
        probes = gen.run_chunk(t, DT, chunk, amps, probed=True).probes
        t += chunk * DT
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    counts = {name: w_.launches for name, w_ in wrappers.items() if w_.launches}
    gen_at = probes.cpu().numpy().tolist()
    steps = int(round(t / DT))
    quad, expr = gen._stim_terms[0][1], gen._stim_terms[0][2]
    load_ms = time_ms(lambda: quad.assemble_load(expr, 1.0, device=gen.device, dtype=gen.dtype))
    gaps = [abs(a - b) for a, b in zip(gen_at, main["at"])]
    print(f"[fused_scope] (b) the main path's S1 stimulus as a general expression, 40 ms: P1-P9 "
          + " ".join(f"{a:.2f}" for a in gen_at) + "; |P - P_TimeWindow| "
          + ", ".join(f"P{i + 1}={g:.3f}" for i, g in enumerate(gaps))
          + f"; ms_per_s={t / wall:.3f} (TimeWindow {main['ms_per_s']:.3f}); B8 launches {counts.get('csr_spmv', 0)} "
          f"in {steps} steps; the load's assembly {load_ms:.4f} ms a step ({quad.W.shape[0]} cells x "
          f"{quad.W.shape[1]} points, one B8 product); launches {json.dumps(counts)}")
    require(max(gaps) <= DT + 1e-6, "the general-stimulus P1-P9 within one dt of the TimeWindow run's")
    require(counts.get("csr_spmv", 0) == steps, "the general stimulus: one B8 launch a step")
    del gen

    part("(b)")
    # (c) Path M with TP06's parameters as a node-aligned field
    funs, init_m, params, v_idx = mixed_ionic()
    n = mixed.V.ndofs
    field = dict(params)
    field[TP06_MARKER] = np.tile(np.asarray(params[TP06_MARKER], dtype=np.float64)[:, None], (1, n))
    tab = dataclasses.replace(mixed, ode_fun=funs, init_states=init_m, parameters=params, v_index=v_idx)
    fld = dataclasses.replace(mixed, ode_fun=funs, init_states=init_m, parameters=field, v_index=v_idx)
    g = fld._ionic_fields[0]
    tab.solve((0.0, 2.0), dt=DT)
    zero_launches(wrappers)
    fld.solve((0.0, 2.0), dt=DT)
    counts = {name: w_.launches for name, w_ in wrappers.items() if w_.launches}
    same = torch.equal(fld.states, tab.states) and torch.equal(fld.activation_time, tab.activation_time)
    S = fld.states.clone()
    v = fld.v.clone()
    sub = S[: g.model.num_states].index_select(1, g.nodes).contiguous()
    step_ms = time_ms(lambda: cuda_ode.field_step(S, v, g, 1.0, DT))
    kernel_ms = time_ms(lambda: g.model.node_step(sub, v[: sub.shape[1]], 1.0, DT, g.field))
    print(f"[fused_scope] (c) Path M, TP06's marker on a broadcast ({g.field.shape[0]}, {n}) field, 2 ms: states "
          f"and activation times equal to the table run: {same}; max|dV| {float((fld.v - tab.v).abs().max()):.3e}; "
          f"launches {json.dumps(counts)}; the field marker's step {step_ms:.4f} ms ({g.nodes.numel()} nodes: "
          f"gather, B1's per-node form {kernel_ms:.4f} ms, scatter; {step_ms - kernel_ms:.4f} ms a step beside the "
          f"kernel)")
    require(same, "Path M on a broadcast TP06 field equals its table run bit for bit")
    require(counts.get("tp06_grl_node_step_v", 0) > 0 and counts.get("tp06_grl_multi_step_v", 0) == 0,
            "the field run launched TP06's per-node form and not its B7")
    del tab
    # a field that varies in space: one step, kernels against twins
    rng = np.random.default_rng(7)
    cts = rng.integers(0, 3, n).astype(float)
    varying = dict(params)
    varying[TP06_MARKER] = field[TP06_MARKER].copy()
    varying[TP06_MARKER][tp06.parameter_index("celltype")] = cts
    fld = dataclasses.replace(fld, ode_fun=funs, init_states=init_m, parameters=varying, v_index=v_idx)
    g = fld._ionic_fields[0]
    S = fld.states.clone()
    S[:19] = torch.as_tensor(kc.check_states("tp06", n, rng), device=S.device).to(S.dtype)
    v = torch.as_tensor(rng.uniform(-90.0, 40.0, n), device=S.device).to(S.dtype)
    worst = 0.0
    for _, Sx in kc.step_check_states(S, "tp06"):
        for dt in (0.025, 0.05):
            out = kc.ionic_step_errors_by_group(
                lambda a, b, t, d, p: cuda_ode.field_step(a, b, g, t, d, True),
                lambda a, b, t, d, p: cuda_ode.field_step(a, b, g, t, d, False), Sx, v, 1.0, dt, None,
                {"tp06": g.nodes})
            worst = max(worst, float(out["tp06"][1].max()))
    print(f"[fused_scope] (c) a TP06 field of mixed celltypes: one step, kernels vs twins on the marker's nodes, "
          f"worst row |k-w| beyond 1 ulp / max|increment| {worst:.3e} (limit {kc.IONIC_STEP_TOL:g})")
    require(worst <= kc.IONIC_STEP_TOL, "the varying field's step agrees with its twin")
    del fld, S

    part("(c)")
    # (d) forward Euler: the nine kernels against their twins, then on paths
    rows = fe_form_rows()
    launches = fe_paths(base)

    part("(d)")
    # (e) the cache: the dx=0.1 slab pair, cold (phase 3) and warm
    slot, cold_pair = ledger.first
    tic = time.perf_counter()
    warm = fem.assemble_mass_stiffness_auto(base.V, as_cell_tensors(base.M, base.mesh), cache_key=CACHE_KEY)
    warm_s = time.perf_counter() - tic
    del base
    equal = all(a.offsets == b.offsets and torch.equal(a.vals, b.vals) for a, b in zip(warm, cold_pair))
    print(f"[fused_scope] (e) the dx=0.1 slab pair ({slot.name}): cold assembly {ledger.cold[slot]:.2f} s, its "
          f"store {ledger.stores[slot]:.2f} s, warm load {warm_s:.2f} s; the warm pair equals the cold one bit "
          f"for bit: {equal}")
    require(equal, "the warm operator-cache load equals the cold assembly bit for bit")
    part("(e)")
    took = time.perf_counter() - tic0
    print(f"[fused_scope] phase 21: {took:.1f} s")
    return rows, launches, took


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
        r, solvers[tag] = bs.run_slab(BIDOMAIN_DX, dt=DT, device=DEVICE, return_solver=True, cache_key=CACHE_KEY, **kw)
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
    nz = bs.slab_solver(BIDOMAIN_DX, device=DEVICE, scheme="monolithic", cache_key=CACHE_KEY)
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
    that strays shows as a kernel run further from JAX than its twin run.
    The LV runs on its twins twice, and the two runs must be equal bit for
    bit (B8's twin sums in a fixed order)."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs

    def slab(use_kernels):
        r, solver = bs.run_slab(0.2, dt=DT, device=DEVICE, monodomain=False, return_solver=True,
                                use_kernels=use_kernels)
        r["cg_iters_all_steps"] = solver.cg_iterations / solver.steps  # 0-15 ms, as the reference counts
        return r

    lv_twins = []

    def lv(use_kernels):
        (r,), (solver,) = bs.run_lv(LV_CHECK_PSIZE, dt=DT, T_warm=0.0, T_timed=10.0, preconds=("jacobi",),
                                    device=DEVICE, use_kernels=use_kernels)
        r["cg_iters_all_steps"] = r["cg_iters_per_step"]  # no warm-up: the timed window is the run
        if not use_kernels:
            lv_twins.append((r, solver.states.clone(), solver.u_e.clone()))
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
    # B8's twin sums each row in a fixed order (no float atomics): a second
    # twin run of the LV repeats the first bit for bit
    lv(False)
    (r1, s1, u1), (r2, s2, u2) = lv_twins
    same = (r1["chunk_iters"] == r2["chunk_iters"] and r1["cg_iters_per_step"] == r2["cg_iters_per_step"]
            and torch.equal(s1, s2) and torch.equal(u1, u2))
    print(f"[bidomain_ref] LV on its twins, two runs: CG per step {r1['cg_iters_per_step']:.4f} and "
          f"{r2['cg_iters_per_step']:.4f}, per-chunk worst {r1['chunk_iters']} and {r2['chunk_iters']}; states and "
          f"u_e equal bit for bit: {same}")
    require(same, "two twin runs of the bidomain LV repeat their CG counts and fields bit for bit")
    require(launches["slab"].get("stencil_spmv", 0) > 0 and launches["slab"].get("tp06_grl_step_v", 0) > 0,
            "the bidomain slab runs stencil_spmv and tp06_grl_step_v")
    require(launches["LV"].get("csr_spmv", 0) > 0 and launches["LV"].get("tp06_grl_step_v", 0) > 0,
            "the bidomain LV runs csr_spmv and tp06_grl_step_v")


def phase_bidomain_demo() -> dict:
    """``demos/bidomain_ue.py``'s configuration (nx=48, 40 ms, FHN, Strang,
    the DCT): the per-save rows held to the JAX package's float64 rows; then
    the same run with FHN's parameters as a uniform node-aligned field (B1's
    per-node form) and as one marker layer (B7), each equal bit for bit to
    the vector run.  Returns the launches of each kernel in its run, and
    the rows."""
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
    return launches, res["rows"]


def ode_source(name: str) -> tuple[str, str]:
    """(template, TPU kernel it replaces) of a generated model's kernel."""
    form = "multi" if "_multi_" in name else "node" if "_node_" in name else "step"
    return (f"fenicsx_beat_tpu_torch/csrc/ode_{form}.cu.in",
            "fenicsx_beat_tpu/ops/pallas_ode.py:" + ("325" if form == "multi" else "89"))


def ode_specs(ode: dict) -> dict:
    """``{(source, scheme): IonicModel}`` of the loaded generated models."""
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    return {(name, sch): cuda_ode.ionic_model(getattr(m, fn)) for name, m in ode.items()
            for sch, fn in ODE_SCHEMES.items()}


def ode_wrappers(ode: dict) -> dict:
    return {w.__name__: w for spec in ode_specs(ode).values()
            for w in (spec.step, spec.node_step, spec.multi_step)}


def ode_ops_per_node(cuda_source: str, scheme: str) -> int:
    """Operations of one node's step, counted from the generated body's
    function for ``scheme``: each arithmetic operator, comparison, select
    and function call once."""
    import re

    body = cuda_source[cuda_source.index(f"void {scheme}_node("):]
    body = body[body.index("{"): body.index("\n}\n")]
    expr = " ".join(line.split("=", 1)[1] for line in body.splitlines() if " = " in line and "row[" not in line)
    expr = re.sub(r"\d+\.\d+e[+-]\d+F", "c", expr)  # literals, whose exponent signs are no operations
    return len(re.findall(r"[-+*/?]|[<>]=?|==|!=|&&|\|\||\b\w+f\(", expr))


def phase_ode_build() -> dict:
    """Load the port's copies of the inline FitzHugh-Nagumo and the coverage
    source; build each model's library (nvcc, three templates with the
    generated body) and load it a second time, which must not compile.
    Returns ``{source: module}``."""
    import sympy

    from fenicsx_beat_tpu_torch import _build, odefile

    print(f"[ode] sympy {sympy.__version__}")
    ode = {}
    for name in ODE_SOURCES:
        tic = time.perf_counter()
        m = odefile.load_ode(odefile.ODES / f"{name}.ode")
        gen_s = time.perf_counter() - tic
        tic = time.perf_counter()
        kl = _build.load_model_library(m.cuda_source)
        load_s = time.perf_counter() - tic
        tic = time.perf_counter()
        again = _build.load_model_library.__wrapped__(m.cuda_source)  # past the in-process cache
        again_s = time.perf_counter() - tic
        print(f"[ode] {name}: {m.num_states} states, {m.num_parameters} parameters, {len(m.code.splitlines())} "
              f"torch lines, {len(m.cuda_source.splitlines())} CUDA lines, generated in {gen_s:.2f} s; "
              f"{kl.path.name}: nvcc {kl.build_seconds:.1f} s (loaded in {load_s:.1f} s); "
              f"second load {again_s:.3f} s, compiled {again.build_seconds:.1f} s")
        require(again.build_seconds == 0.0 and again.path == kl.path, f"a second load of {name} compiles nothing")
        entry = None
        for line in kl.compiler_output.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry is not None and "finalize" not in entry:
                form = "multi" if "multi" in entry else "node" if "node_step" in entry else "step"
                scheme = "fe" if "ILi1E" in entry else "grl"
                print(f"[ode]   {name} {scheme} {form}: {line.strip()}")
            elif "spill" in line and entry is not None and "finalize" not in entry:
                require(" 0 bytes spill stores" in line, f"{name}'s kernels do not spill")
        ode[name] = m
    return ode


def phase_ode_kernels(ode: dict) -> dict:
    """The generated B1, B1's per-node form and B7 of each source and scheme
    against their twins at the main path's width (n = 442,401), through
    ``kernel_check.ionic_form_checks`` with FitzHugh-Nagumo's limits: per
    state row, one step with the stimulus window off and on (t = 0.5 and
    2.0) and two dt, one beat of every cell; the per-node form on a uniform
    field gives B1's bits; nodes of no layer keep their states exactly.
    Times each kernel beside its twin and its bound."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call

    n, f32 = N_MAIN, 4
    rows, dev_us = {}, {}
    for (name, sch), spec in ode_specs(ode).items():
        m, cfg = ode[name], ODE_SOURCES[name]
        names = list(m._STATE_NAMES)
        rng = np.random.default_rng(11)
        states = np.stack([rng.uniform(*cfg["ranges"][x], n) for x in names])
        v = rng.uniform(*cfg["ranges"][names[spec.v_index]], n)
        table = np.stack([m.init_parameter_values(**kw) for kw in cfg["sets"]])

        def rest(r, m=m, names=names, cfg=cfg):
            x = np.tile(m.init_state_values()[:, None], (1, n))
            for state, (lo, hi) in cfg["rest"].items():
                x[names.index(state)] = r.uniform(lo, hi, n)
            return x

        tic = time.perf_counter()
        out = kc.ionic_form_checks(spec, states, v, table, rest, rng, device=DEVICE, beat_steps=ODE_BEAT_STEPS)
        took = time.perf_counter() - tic
        require(out["uniform_bits"], f"{spec.node_step.__name__} on a uniform field gives {spec.step.__name__}'s bits")
        errs = {}
        for form, res in out["forms"].items():
            step_abs, worst, beat = 0.0, 0.0, 0.0
            for (t, dt, g), (a, e) in res["step"].items():
                if g == "no layer":
                    require(a == 0.0, f"{form} leaves the nodes of no layer as they were, V injected")
                    continue
                require(bool((e <= kc.IONIC_STEP_TOL).all()), f"{form} one-step increments agree, t={t}, {g}")
                step_abs, worst = max(step_abs, a), max(worst, float(e.max()))
            for g, (a, e) in res["beat"].items():
                require(bool((e <= kc.IONIC_BEAT_TOL).all()), f"{form} agrees with its twin over one beat, {g}")
                beat = max(beat, float(e.max()))
            print(f"[ode] {form}: one step, worst row |k-w| beyond 1 ulp / max|increment| {worst:.2e} (limit "
                  f"{kc.IONIC_STEP_TOL:g}); one beat ({ODE_BEAT_STEPS} steps), worst row max|k-w| / excursion "
                  f"{beat:.2e} (limit {kc.IONIC_BEAT_TOL:g}); rows {res['rows']}")
            errs[form] = (step_abs, worst)
        print(f"[ode] {spec.name} checks: {took:.1f} s")

        x = out["inputs"]
        scratch, storage, vk, field, p0 = x["S0"].clone(), x["S0_storage"].clone(), x["v"], x["field"], table[0]
        S, NP = m.num_states, m.num_parameters
        b1_bytes = 2 * S * n * f32  # every row written, every row but V's read, and the injected v
        ops = ode_ops_per_node(m.cuda_source, sch) * n
        b7, b7_twin = x["b7"], x["b7_twin"]
        calls = {
            spec.step.__name__: (lambda: spec.step(scratch, vk, 2.0, 0.025, p0),
                                 lambda: spec.step_twin(scratch, vk, 2.0, 0.025, p0), b1_bytes),
            spec.node_step.__name__: (lambda: spec.node_step(scratch, vk, 2.0, 0.025, field),
                                      lambda: spec.step_twin(scratch, vk, 2.0, 0.025, field),
                                      b1_bytes + NP * n * f32),
            spec.multi_step.__name__: (lambda: b7(storage, vk, 2.0, 0.025, None),
                                       lambda: b7_twin(storage, vk, 2.0, 0.025, None), b1_bytes + n * 4),
        }
        for form, (kern, twin, nbytes) in calls.items():
            rows[form] = row(errs[form], time_ms(kern), time_ms(twin), bound(nbytes, ops), None)
            dev_us[form] = device_us_per_call(kern)
    torch.cuda.synchronize()
    print("[ode] device time per call (torch.profiler, us): " + ", ".join(f"{k} {u:.2f}" for k, u in dev_us.items()))
    print_rows(rows)
    return rows


def phase_ode_vs_fhn(ode: dict) -> None:
    """The generated inline FHN's forward Euler against the hand-written
    FitzHugh-Nagumo kernels (fhn_step_v, fhn_node_step_v, fhn_multi_step_v)
    on the same 442,401 nodes: the same formulas in another association
    order, the rows mapped (v, w against s, v; both B7 layouts hold v in
    row 0), the hand-written model's stimulus off.  Held by the one-step
    limit per row; the largest difference printed in float32 ulps."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
    from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    n = N_MAIN
    m = ode["fhn_inline"]
    spec = cuda_ode.ionic_model(m.forward_euler)
    rng = np.random.default_rng(13)
    sets = ODE_SOURCES["fhn_inline"]["sets"]
    gen_table = np.stack([m.init_parameter_values(**kw) for kw in sets])
    hand_table = np.stack([fhn.init_parameter_values(stim_amplitude=0.0, **kw) for kw in sets])
    S = torch.tensor(np.stack([rng.uniform(-90.0, 40.0, n), rng.uniform(0.0, 60.0, n)]), dtype=torch.float32,
                     device=DEVICE)
    v = torch.tensor(rng.uniform(-90.0, 40.0, n), dtype=torch.float32, device=DEVICE)
    which = rng.integers(0, len(sets), n)
    index = torch.as_tensor(which.astype(np.int32), device=DEVICE)

    def on(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=DEVICE)

    def flipped(hand_step, args):  # the hand-written kernel on the generated model's row order
        def step(w, v_, t, dt, p):
            h = w.flip(0).contiguous()
            hand_step(h, v_, *args(t, dt))
            w.copy_(h.flip(0))
        return step

    pairs = {
        "fhn_step_v": (lambda k, v_, t, dt, p: spec.step(k, v_, t, dt, gen_table[0]),
                       flipped(cuda_ode.fhn_step_v, lambda t, dt: (t, dt, hand_table[0]))),
        "fhn_node_step_v": (lambda k, v_, t, dt, p: spec.node_step(k, v_, t, dt, on(gen_table[which].T)),
                            flipped(cuda_ode.fhn_node_step_v, lambda t, dt: (t, dt, on(hand_table[which].T)))),
        "fhn_multi_step_v": (lambda k, v_, t, dt, p: spec.multi_step(k, v_, index, t, dt, on(gen_table)),
                             lambda w, v_, t, dt, p: cuda_ode.fhn_multi_step_v(w, v_, index, t, dt, on(hand_table))),
    }
    for hand, (gen_step, hand_step) in pairs.items():
        worst, ulps = 0.0, 0.0
        for t in (0.5, 2.0):
            for dt in (0.025, 0.05):
                a, e = kc.ionic_step_errors(gen_step, hand_step, S, v, t, dt, None, v_index=0)
                k, w = S.clone(), S.clone()
                gen_step(k, v, t, dt, None)
                hand_step(w, v, t, dt, None)
                top = w.abs().amax(dim=1, keepdim=True)  # each row's largest value
                ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
                ulps = max(ulps, float(((k - w).abs() / ulp).max()))
                require(bool((e <= kc.IONIC_STEP_TOL).all()),
                        f"the generated forward Euler agrees with {hand} per row, t={t}, dt={dt}")
                worst = max(worst, float(e.max()))
        print(f"[ode] {spec.name} vs {hand}: worst row |gen - hand| beyond 1 ulp / max|increment| {worst:.2e} "
              f"(limit {kc.IONIC_STEP_TOL:g}); largest difference {ulps:.1f} float32 ulps of its row's largest value")


def _timed_run(build, seed: int | None, T: float, dt: float):
    """``build()``'s solver run over (0, T), from states moved by one ulp
    at random when ``seed`` is given; (solver, seconds of the run)."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.bidomain_scale import perturb_states

    solver = build()
    if seed is not None:
        perturb_states(solver, seed)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    solver.solve((0.0, T), dt=dt)
    torch.cuda.synchronize()
    return solver, time.perf_counter() - tic


def phase_ode_main(ode: dict) -> dict:
    """The custom-ODE path at full width: the Niederer slab at dx=0.1
    (442,401 nodes) with the generated inline FHN's GRL, Strang, dt=0.05,
    a fixed 40 ms, through ``benchmarks/niederer.py:_build_solver(model=)``:
    on the kernels (launch counts zeroed before, read after: the generated
    B1, B2, B3 and B4 > 0), on the twins, and on both from states one ulp
    away (float32's noise: the larger distance of such a run to its own).
    v at every node of the kernel run within 3x that noise of the twin
    run; max|v|, the share of nodes above 0 mV, CG iterations and host
    syncs per step, ms/s."""
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    m = ode["fhn_inline"]
    wrappers = {**kernel_wrappers(), **ode_wrappers(ode)}

    def build(use_kernels=True):
        return _build_solver(dx=ODE_DX, theta=0.5, model=m, device=DEVICE, use_kernels=use_kernels,
                             operator_cache_key=CACHE_KEY)

    tic = time.perf_counter()
    zero_launches(wrappers)
    k, wall = _timed_run(build, None, ODE_T, DT)
    launches = {name: w.launches for name, w in wrappers.items() if w.launches}
    setup_and_run = time.perf_counter() - tic
    w, _ = _timed_run(lambda: build(False), None, ODE_T, DT)
    k2, _ = _timed_run(build, 1, ODE_T, DT)
    w2, _ = _timed_run(lambda: build(False), 1, ODE_T, DT)
    vk, vw, vk2, vw2 = (s.v.double() for s in (k, w, k2, w2))
    gap = float((vk - vw).abs().max())
    noise_k, noise_w = float((vk - vk2).abs().max()), float((vw - vw2).abs().max())
    noise = max(noise_k, noise_w)
    steps = round(ODE_T / DT)
    print(f"[ode_main] dx={ODE_DX} custom ODE ({m.__name__} GRL), {k._n} nodes, {ODE_T:g} ms: ms_per_s="
          f"{ODE_T / wall:.3f} (setup and run {setup_and_run:.1f} s), CG per step {k.cg_iterations / steps:.3f}, "
          f"host syncs per step {k.host_syncs / steps:.3f}; max|v| {float(vk.abs().max()):.4f} mV, v_max "
          f"{float(vk.max()):.4f} mV, share of nodes above 0 mV {float((vk > 0).double().mean()):.3e}; "
          f"kernels vs twins max|dv| {gap:.3e} mV, float32 noise (runs from states one ulp away: kernels "
          f"{noise_k:.3e}, twins {noise_w:.3e} mV; limit {ODE_NOISE_FACTOR:g}x the larger, {gap / noise:.2f}x); "
          f"launches {json.dumps(launches)}")
    require(bool(torch.isfinite(k.states).all() and torch.isfinite(w.states).all()), "the custom-ODE run is finite")
    require(gap <= ODE_NOISE_FACTOR * noise, "the custom-ODE kernel run within 3x float32's noise of its twin run")
    grl = cuda_ode.ionic_model(m.generalized_rush_larsen).step.__name__
    require(launches.get(grl, 0) > 0, f"{grl} launched on the custom-ODE path")
    require_structured_pcg(launches, "the custom-ODE path")
    return {grl: launches.get(grl, 0)}


def phase_ode_demo(ode: dict) -> None:
    """demos/custom_ode.py's configuration (the slab at dx=0.5, the inline
    FHN's GRL, Strang, dt=0.05, 40 ms) on the kernels: v_max and v at
    P1-P9 within 3x each value's largest gap to the JAX package's float64
    values over the float32 witnesses (the CPU's of
    ``tests/torch_ode_reference.py``; the card's twins from the initial
    states, twins and kernels from states one ulp away); and v at every
    node within 3x float32's noise (the largest distance of a run from
    one ulp away to its own run, kernels or twins) of the twin run."""
    import numpy as np

    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver, benchmark_points

    def build(use_kernels=True):
        return _build_solver(dx=0.5, theta=0.5, model=ode["fhn_inline"], device=DEVICE, use_kernels=use_kernels)

    v = {}
    for seed in (None, *ODE_DEMO_SEEDS):
        for route, use_kernels in (("kernels", True), ("twins", False)):
            s, _ = _timed_run(lambda: build(use_kernels), seed, ODE_T, DT)
            v[route if seed is None else f"{route}+{seed}"] = s.v.double().cpu().numpy()
    coords = np.asarray(s.mesh.geometry.x)
    nodes = [int(np.argmin(((coords - np.array(p)) ** 2).sum(axis=1))) for p in benchmark_points().values()]
    got = {tag: {"v_max": float(x.max()), **{f"v_P{i + 1}": float(x[k]) for i, k in enumerate(nodes)}}
           for tag, x in v.items()}
    witnesses = [tag for tag in got if tag != "kernels"]
    for key, ref in JAX_CUSTOM_ODE_DX05.items():
        card = max(abs(got[tag][key] - ref) for tag in witnesses)
        ulps = 3.0 * float(np.spacing(np.float32(abs(ref))))
        tol = max(3.0 * max(JAX_CUSTOM_ODE_DX05_CPU_GAP[key], card), ulps)
        gap = abs(got["kernels"][key] - ref)
        print(f"[ode_demo] {key} {got['kernels'][key]:.6f} mV (JAX float64 {ref:.6f}, gap {gap:.3e}; twins on the "
              f"card gap {abs(got['twins'][key] - ref):.3e}; largest gap of the card's witnesses {card:.3e}, of "
              f"the CPU's {JAX_CUSTOM_ODE_DX05_CPU_GAP[key]:.3e}; limit {tol:.3e})")
        require(gap <= tol, f"the dx=0.5 custom-ODE demo's {key} within its float32 tolerance of JAX")
    gap = float(np.abs(v["kernels"] - v["twins"]).max())
    noise = max(float(np.abs(v[route] - v[f"{route}+{seed}"]).max())
                for route in ("kernels", "twins") for seed in ODE_DEMO_SEEDS)
    print(f"[ode_demo] kernels vs twins max|dv| {gap:.3e} mV at every node, float32 noise (runs from states one "
          f"ulp away) {noise:.3e} mV (limit {ODE_NOISE_FACTOR:g}x)")
    require(gap <= ODE_NOISE_FACTOR * noise, "the dx=0.5 custom-ODE kernel run within 3x float32's noise of its twins")


def phase_ode_bidomain(ode: dict, hand_rows: list) -> dict:
    """demos/bidomain_ue.py's configuration (nx=48, Strang, dt=0.1, 40 ms)
    on the generated inline FHN's forward Euler: every saved (t, v_max,
    max|u_e|) row within phase 14's tolerance (3x the float32 witnesses'
    largest stray per field) of the hand-written FHN run's row."""
    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    m = ode["fhn_inline"]
    spec = cuda_ode.ionic_model(m.forward_euler)
    spec.step.launches = 0
    res = bs.run_demo(nx=48, T=40.0, dt=0.1, device=DEVICE, ode_fun=m.forward_euler,
                      init_states=m.init_state_values(), parameters=m.init_parameter_values(), v_index=0)
    launches = spec.step.launches
    stray_v, stray_u = JAX_BIDOMAIN_DEMO_STRAY["v_max"], JAX_BIDOMAIN_DEMO_STRAY["u_e_max_abs"]
    gaps = [max(abs(vm - vh) / abs(vh) / stray_v, abs(um - uh) / abs(uh) / stray_u)
            for (_, vm, um), (_, vh, uh) in zip(res["rows"], hand_rows)]
    print(f"[ode_bidomain] demo on {spec.step.__name__}: status {res['status']}, ms_per_s={res['ms_per_s']:.3f}, "
          f"CG per step {res['cg_iters_per_step']:.3f}; launches {launches}; largest relative gap to the "
          f"hand-written run {max(gaps):.3f}x the witnesses' stray (limit 3x); last row {res['rows'][-1]}, "
          f"hand-written {hand_rows[-1]}")
    require(res["status"] == "OK" and res["finite"] and len(gaps) == len(hand_rows) > 0,
            "the bidomain demo on the generated FE converged, finite, every save made")
    require(max(gaps) <= 3.0, "the bidomain demo on the generated FE within phase 14's tolerance of the hand-written")
    require(launches > 0, f"{spec.step.__name__} launched in the bidomain demo")
    return {spec.step.__name__: launches}


def phase_ode_paths(ode: dict) -> dict:
    """Each generated form on a solver path: the slab at dx=0.5, Strang,
    5 ms, for each source and scheme on B1 (the parameter vector), on B1's
    per-node form (the vector as a uniform node-aligned field) and on B7
    (one marker layer over every node); the field and layer runs equal the
    vector run bit for bit.  Returns each form's launches in its run (the
    custom-ODE path's and the bidomain demo's B1 counts come from those
    runs)."""
    import dataclasses

    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.niederer import _build_solver

    wrappers = ode_wrappers(ode)
    launches = {}
    for (name, sch), spec in ode_specs(ode).items():
        m = ode[name]
        fun = getattr(m, ODE_SCHEMES[sch])
        ref = _build_solver(dx=0.5, theta=0.5, model=m, scheme=ODE_SCHEMES[sch], device=DEVICE)
        n = ref._n
        p = np.asarray(ref.parameters)
        variants = {
            spec.step.__name__: {},
            spec.node_step.__name__: dict(parameters=np.tile(p[:, None], (1, n))),
            spec.multi_step.__name__: dict(ode_fun={1: fun}, init_states={1: m.init_state_values()},
                                           parameters={1: p}, v_index={1: spec.v_index},
                                           ode_markers=np.ones(n, dtype=np.int64)),
        }
        base = None
        for form, kw in variants.items():
            solver = dataclasses.replace(ref, **kw) if kw else ref
            zero_launches(wrappers)
            solver.solve((0.0, 5.0), dt=DT)
            launches[form] = wrappers[form].launches
            v = solver.v.clone()
            if base is None:
                base = v
            same = torch.equal(v, base) and bool(torch.isfinite(solver.states).all())
            print(f"[ode_paths] {form}: dx=0.5, 5 ms, launches {launches[form]}, v_max {float(v.max()):.4f} mV, "
                  f"v equal to the vector run: {same}")
            require(same and launches[form] > 0, f"{form} runs the slab, equal bit for bit to the vector run")
    return launches


def require_structured_pcg(launches: dict, where: str) -> None:
    """The structured PCG ran on its kernels: B2 (A x0, B v), B2·B4 and
    B3, and no B4 of its own (folded into B2·B4)."""
    for name in ("stencil_spmv_sym", "stencil_spmv_sym_dir_dot", "cg_update"):
        require(launches.get(name, 0) > 0, f"{name} launched on {where}")
    require(launches.get("axpy", 0) == 0, f"axpy not launched on {where} (folded into stencil_spmv_sym_dir_dot)")


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
        "stencil_spmv_sym_dir_dot": cuda_spmv.stencil_spmv_sym_dir_dot,
        "cg_update": cuda_cg.cg_update,
        "axpy": cuda_cg.axpy,
        "tp06_grl_multi_step_v": cuda_ode.tp06_grl_multi_step_v,
        "csr_spmv": cuda_ell.csr_spmv,
        "stencil_spmv": cuda_stencil.stencil_spmv,
        "stencil_spmv_window": cuda_stencil.stencil_spmv_window,
        "fhn_step_v": cuda_ode.fhn_step_v,
        "fhn_node_step_v": cuda_ode.fhn_node_step_v,
        "fhn_multi_step_v": cuda_ode.fhn_multi_step_v,
        "torord_land_grl_step_v": cuda_ode.torord_land_grl_step_v,
        "torord_land_grl_node_step_v": cuda_ode.torord_land_grl_node_step_v,
        "torord_land_grl_multi_step_v": cuda_ode.torord_land_grl_multi_step_v,
    }


def old_pde_solve(solver, ops, v_prev, x0, t_stim, dt, amps):
    """The structured PCG as the port ran it before B2·B4, for comparison
    only: each iteration B2 with its dot, rz / pAp, B3, rz_new / rz and B4
    (six launches: B3's dot has a second pass, B2's no longer)."""
    import torch

    from fenicsx_beat_tpu_torch.ops import cuda_spmv

    A, B, minv, _ = ops
    rtol, atol = float(solver._opts["ksp_rtol"]), float(solver._opts["ksp_atol"])
    maxiter, pos = int(solver._opts["ksp_max_it"]), solver._pos
    b = solver._assemble_rhs(B, v_prev, t_stim, dt, amps)
    r = b - cuda_spmv.stencil_spmv_sym(A, x0, pos)
    z = r * minv
    rz, rr = torch.dot(r, z), torch.dot(r, r)
    tol2 = torch.clamp(rtol * torch.sqrt(torch.dot(b, b)), min=atol) ** 2
    x, p, k = x0, z, 0
    while k < maxiter:
        solver.host_syncs += 1
        if not bool(rr > tol2):
            break
        x, r, z, rz, rr, p = old_iteration(A, pos, minv, x, r, z, rz, p)
        k += 1
    return x, k, rr, k < maxiter or bool(rr <= tol2)


def old_iteration(A, pos, minv, x, r, z, rz, p):
    """One PCG iteration in the old sequence: B2 dot, division, B3,
    division, B4."""
    from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_spmv

    Ap, pAp = cuda_spmv.stencil_spmv_sym_dot(A, p, pos)
    x, r, z, rz_new, rr = cuda_cg.cg_update(x, r, p, Ap, minv, rz / pAp)
    return x, r, z, rz_new, rr, cuda_cg.axpy(z, p, rz_new / rz)


def phase_pcg_sequences(solver) -> dict:
    """The structured PCG's two issue sequences on the main path's
    theta-system operator, in turns (old, new, new, old): 200 iterations,
    25 solves of 8 from one right-hand side (the main path takes about 7
    a step), each iteration with the main path's exit test read back to
    the host (never met); wall time per iteration on the host clock, and
    device time and device launches per iteration under torch.profiler,
    the exit test's own device events (a comparison and the copy to the
    host) counted apart.  Then 40 steps of the main path's solver from its
    initial state: its launches per CG iteration and per step."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_events_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_spmv

    solves, per_solve = 25, 8
    A, _, minv, (dir_dot, update) = solver._operators(DT)
    pos, n = solver._pos, solver._n
    rng = np.random.default_rng(11)
    x0 = torch.as_tensor(rng.uniform(-90.0, 40.0, n), device=A.device).to(A.dtype)
    b = cuda_spmv.stencil_spmv_sym(A, x0 + torch.as_tensor(rng.uniform(-1.0, 1.0, n), device=A.device).to(A.dtype), pos)
    r0 = b - cuda_spmv.stencil_spmv_sym(A, x0, pos)
    z0 = r0 * minv
    rz0, rr0 = torch.dot(r0, z0), torch.dot(r0, r0)
    never = torch.zeros((), dtype=A.dtype, device=A.device)

    def old():
        x, r, z, rz, rr, p = x0, r0, z0, rz0, rr0, z0
        for _ in range(per_solve):
            require(bool(rr > never), "the exit test holds")
            x, r, z, rz, rr, p = old_iteration(A, pos, minv, x, r, z, rz, p)

    def new():
        x, r, z, rz, rr, p, rz_prev = x0, r0, z0, rz0, rr0, None, None
        for _ in range(per_solve):
            require(bool(rr > never), "the exit test holds")
            p, ap, _, alpha = dir_dot(z, p, rz, rz_prev)
            x, r, z, rz_new, rr = update(x, r, p, ap, minv, alpha)
            rz_prev, rz = rz, rz_new

    _, exit_events = device_events_per_call(lambda: bool(rr0 > never), calls=solves * per_solve)
    print(f"[pcg] the exit test's device events: {json.dumps(exit_events)}")
    out = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        fn = {"old": old, "new": new}[name]
        fn()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(solves):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6 / (solves * per_solve)
        dev_us, events = device_events_per_call(fn, calls=solves)
        launches = (sum(events.values()) - per_solve * sum(exit_events.values())) / per_solve
        out[name].append((wall_us, dev_us / per_solve, launches))
        print(f"[pcg] {name} sequence, {solves * per_solve} iterations: wall {wall_us:.2f} us, device "
              f"{dev_us / per_solve:.2f} us per iteration; {launches:g} launches per iteration besides the exit "
              f"test; device events per solve of {per_solve}: "
              + json.dumps({k[:70]: c for k, c in events.items()}))
    # the old sequence: B2 with its dot (one launch since its redesign),
    # two divisions, B3 and its second pass, B4
    for name, want in (("old", 6), ("new", 3)):
        require(all(r[2] == want for r in out[name]),
                f"the {name} sequence launches {want} kernels an iteration besides the exit test")
    print("[pcg] per iteration, mean of two runs each: "
          + "; ".join(f"{k} wall {statistics.mean(r[0] for r in v):.2f} us, device "
                      f"{statistics.mean(r[1] for r in v):.2f} us" for k, v in out.items()))
    # the main path's own solver: launches per CG iteration and per step
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = solver.run_chunk(0.0, DT, 40, solver.stimulus_amplitudes())
    torch.cuda.synchronize()
    it = res.iters_sum
    per_it = {k: wrappers[k].launches / it for k in ("stencil_spmv_sym_dir_dot", "cg_update", "axpy")}
    print(f"[pcg] main path solver, 40 steps, {it} CG iterations: launches per iteration "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_it.items())
          + f"; stencil_spmv_sym per step {wrappers['stencil_spmv_sym'].launches / 40:.3f}")
    require(per_it == {"stencil_spmv_sym_dir_dot": 1.0, "cg_update": 1.0, "axpy": 0.0},
            "each main-path PCG iteration launches B2·B4 and B3 once and no B4")
    return {k: statistics.mean(r[0] for r in v) for k, v in out.items()}


def phase_main_path() -> tuple[dict, dict]:
    import math

    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark
    from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
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
    print(f"[main] launches {json.dumps(launches)}; B2·B4 {launches['stencil_spmv_sym_dir_dot']} and B3 "
          f"{launches['cg_update']} (once a CG iteration, the warm-up chunk's included), B4 {launches['axpy']}")
    require(err is not None and err <= 0.05, "max error vs the converged published row <= 5%")
    require(max(dev) <= DT + 1e-6, "P1-P9 within one dt of the JAX Strang values")
    require(launches["tp06_grl_step_v"] > 0, "tp06_grl_step_v launched on the main path")
    require_structured_pcg(launches, "the main path")
    require(launches["stencil_spmv_sym_dir_dot"] == launches["cg_update"],
            "B2·B4 and B3 launched once each a CG iteration on the main path")

    # the same run with the old issue sequence patched in: its CG
    # iterations (and probes) are the same computation's
    new_pde_solve = FusedMonodomainSolver._pde_solve
    FusedMonodomainSolver._pde_solve = old_pde_solve
    try:
        old = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
    finally:
        FusedMonodomainSolver._pde_solve = new_pde_solve
    old_at = [old.activation_times[f"P{i}"] for i in range(1, 10)]
    gap = abs(res.cg_iters_sum - old.cg_iters_sum) / old.cg_iters_sum
    print(f"[main] old sequence (B2 dot, division, B3, division, B4): ms_per_s={old.ms_per_second:.3f}, "
          f"cg_iters sum={old.cg_iters_sum} mean={old.cg_iters_mean:.3f} (B2·B4: {res.cg_iters_sum}, "
          f"{gap:.3%} apart), host_syncs_per_step={old.host_syncs_per_step:.3f}; P1-P9 "
          + " ".join(f"{a:.2f}" for a in old_at))
    require(gap <= 0.01, "the main path's CG iterations within 1% of the old sequence's")
    return launches, {"at": at, "ms_per_s": res.ms_per_second, "cg_mean": res.cg_iters_mean,
                      "syncs": res.host_syncs_per_step}


def phase_lv_path(solver, setup_s: float, prepace_s: float = 0.0) -> tuple[dict, float]:
    """The full-width LV run on ``solver`` (TP06 layers, or the demo's
    pre-paced ToR-ORd layers); returns the launch counts and the time
    reached."""
    import math

    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import run_lv_solver

    tag = LV_TAGS[solver._ionic.name]
    multi = solver._ionic_groups[0].model.multi_step.__name__
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
          f"cg_iters max={res.cg_iters_max} mean={res.cg_iters_mean:.3f} ({prior_cg(tag, res.cg_iters_mean)}), "
          f"host_syncs_per_step={res.host_syncs_per_step:.3f}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[{tag}] launches {json.dumps(launches)}")
    if res.active_tension is not None:
        print(f"[{tag}] Land active tension at the probes at {res.simulated_ms:g} ms (kPa): "
              + ", ".join(f"{k}={v:.4e}" for k, v in res.active_tension.items()))
        require(all(math.isfinite(v) for v in res.active_tension.values()), "the probes' active tension finite")
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
    if res.active_tension is not None:
        from fenicsx_beat_tpu_torch.benchmarks.lv import probe_active_tension

        print(f"[{tag}] Land active tension at the probes at {t:g} ms (kPa): "
              + ", ".join(f"{k}={v:.4e}" for k, v in zip(res.active_tension, probe_active_tension(solver))))
    return launches, t


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if not hasattr(card, "line"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        card.line = smi.stdout.strip().splitlines()[0]
    return card.line


def oo_launches(wrappers: dict) -> dict:
    return {k: w.launches for k, w in wrappers.items() if w.launches}


def phase_oo_niederer(main_at: list) -> None:
    """The OO path on the main path's configuration: ``MonodomainModel``
    (PDE theta 0.5) + ``DolfinODESolver`` (TP06's B1) +
    ``MonodomainSplittingSolver(theta=0.5)``, dx=0.1, dt 0.05, 40 ms, with
    a ``PerformanceMonitor`` (``benchmarks/niederer.py:run_niederer_oo``);
    P1-P9 from the host voltage each step writes, held to the JAX
    package's Strang values and to the fused main path's in this run."""
    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_oo
    from fenicsx_beat_tpu_torch.telemetry import PerformanceMonitor

    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    mon = PerformanceMonitor(log_frequency=0)
    res = run_niederer_oo(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, monitor=mon)
    launches = oo_launches(wrappers)
    at = [res.activation_times[f"P{i}"] for i in range(1, 10)]
    dev_jax = [abs(a - b) for a, b in zip(at, JAX_STRANG_DX01)]
    dev_main = [abs(a - b) for a, b in zip(at, main_at)]
    tag = f"[oo_niederer] ({card()})"
    print(f"{tag} dx=0.1 Strang dt={DT} {res.simulated_ms:g} ms, n={res.n_nodes}: P1-P9 "
          + " ".join(f"{a:.2f}" for a in at) + f"; max |P - P_jax| {max(dev_jax):.3f}, max |P - P_fused| "
          f"{max(dev_main):.3f}; host setup {res.setup_s:.1f} s")
    print(f"{tag} ms_per_s={res.ms_per_second:.3f} (wall {res.wall_time_s:.3f} s, {res.n_steps} steps, the monitor's "
          f"synchronize at every section's end included), cg_iters mean={res.cg_iters_mean:.3f}, "
          f"host_syncs_per_step={res.host_syncs_per_step:.3f}, voltage host crossings per step "
          f"{res.host_transfers_per_step:.3f} ({4 * res.n_nodes} B each)")
    print(f"{tag} launches {json.dumps(launches)}: B1 {launches.get('tp06_grl_step_v', 0)}, B2·B4 "
          f"{launches.get('stencil_spmv_sym_dir_dot', 0)}, B3 {launches.get('cg_update', 0)}, B2 "
          f"{launches.get('stencil_spmv_sym', 0)}")
    for line in "\n".join(mon._summary_lines()).splitlines():
        if line.strip():
            print(f"{tag} {line}")
    require(res.status.name == "OK", "every OO Niederer CG converged")
    require(max(dev_jax) <= DT + 1e-6, "OO Niederer P1-P9 within one dt of the JAX Strang values")
    require(max(dev_main) <= DT + 1e-6, "OO Niederer P1-P9 within one dt of the fused main path's in this run")
    require(launches.get("tp06_grl_step_v", 0) == 2 * res.n_steps, "the OO Niederer launches B1 twice a step")
    require_structured_pcg(launches, "the OO Niederer path")
    require(launches.get("stencil_spmv_sym_dir_dot") == launches.get("cg_update") == res.cg_iters_sum,
            "the OO Niederer PCG launches B2·B4 and B3 once a CG iteration")


def phase_oo_lv(torord_lv, steady: dict) -> None:
    """The LV demo's own choreography at psize 0.1 through the OO API
    (``benchmarks/lv_endocardial.py``): the pre-paced ToR-ORd dynCl layers,
    Godunov, 30 ms, the voltage range every 2 ms and the electrode
    potential at (2, 7, 0); held to the fused solver at theta=1 from the
    same states and stimulus (``torord_lv`` reset and rerun): its PCG
    warm-started from v + dv as it runs, and from v_prev as the OO model's
    starts (the JAX package's ``BaseModel``; ``_pde_solve`` overridden on
    this instance only).  Every probe within one dt of both; the activated
    share, which at rtol 1e-6 in float32 moves with the CG's start alone
    (``benchmarks/lv_cg_start.py``), within 0.5 points of the run that
    starts where the OO model does and within 1.0 point of the converged
    share (:data:`LV_CONVERGED_SHARE`)."""
    import math

    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES, lv_probe_points, run_lv_solver
    from fenicsx_beat_tpu_torch.benchmarks.lv_endocardial import build_oo_lv, electrode_potential, run_oo_lv
    from fenicsx_beat_tpu_torch.convert import states_from_numpy

    tag = f"[oo_lv] ({card()})"
    markers = np.array(sorted(CELLTYPES))[torord_lv._ionic_groups[0].index.cpu().numpy()]
    tic = time.perf_counter()
    solver = build_oo_lv(torord_lv.mesh, markers, torord_lv.M, torord_lv.I_s, steady, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    oo = run_oo_lv(solver, LV_T, DT, lv_probe_points(LV_PSIZE), verbose=False)
    launches = oo_launches(wrappers)
    phi = electrode_potential(solver.pde, torord_lv.M)
    for t, lo, hi in oo.v_range:
        print(f"{tag} t={t:6.1f}  v_range=[{lo:8.2f}, {hi:8.2f}]")
    print(f"{tag} Electrode potential: {phi:.6e}")
    # the fused solver at theta=1 from the same pre-paced states: its PCG
    # warm-started from v + dv, then from v_prev as the OO model's is
    refs = {}
    torord_lv.theta = 1.0
    warm = torord_lv._pde_solve
    for name in ("fused, CG from v + dv", "fused, CG from v_prev"):
        torord_lv.states = states_from_numpy(np.asarray(torord_lv.init_states), torord_lv.device, torord_lv.dtype)
        torord_lv.activation_time.fill_(-1.0)
        if name.endswith("v_prev"):
            torord_lv._pde_solve = lambda ops, v, x0, t, dt, amps: warm(ops, v, v, t, dt, amps)
        try:
            ref = run_lv_solver(torord_lv, LV_PSIZE, T=LV_T, dt=DT)
        finally:
            vars(torord_lv).pop("_pde_solve", None)
        act = torord_lv.activation_time.double().cpu().numpy()
        both = (act >= 0) & (oo.activation >= 0)
        refs[name] = ref
        print(f"{tag} {name}: probes " + ", ".join(f"{k}={v:.2f}" for k, v in ref.probes.items())
              + f"; max |OO - fused| {max(abs(oo.probes[k] - v) for k, v in ref.probes.items()):.3f}; activated "
              f"share {ref.activated_share:.4f} (OO {oo.activated_share:.4f}); nodes activated in one run only "
              f"{int(((act >= 0) != (oo.activation >= 0)).sum())}, max |OO - fused| activation time over both "
              f"{float(np.abs(act - oo.activation)[both].max()):.3f} ms; ms_per_s={ref.ms_per_second:.3f}, "
              f"cg_iters mean={ref.cg_iters_mean:.3f}")
    n = solver.pde.V.ndofs
    print(f"{tag} psize {LV_PSIZE} Godunov dt={DT} {oo.simulated_ms:g} ms, n={n}, OO setup {setup_s:.1f} s: OO probes "
          + ", ".join(f"{k}={v:.2f}" for k, v in oo.probes.items()) + f"; activated share {oo.activated_share:.4f}")
    print(f"{tag} OO ms_per_s={oo.ms_per_second:.3f} (wall {oo.wall_s:.3f} s), cg_iters mean="
          f"{oo.cg_iters_sum / oo.n_steps:.3f}, host_syncs_per_step={oo.host_syncs / oo.n_steps:.3f}, voltage host "
          f"crossings per step {oo.host_transfers / oo.n_steps:.3f} ({4 * n} B each)")
    print(f"{tag} launches {json.dumps(launches)}")
    require(oo.all_finite and math.isfinite(phi), "every OO LV state and the electrode potential finite")
    for name, ref in refs.items():
        require(max(abs(oo.probes[k] - v) for k, v in ref.probes.items()) <= DT + 1e-6,
                f"OO LV probes within one dt of the {name} run's")
    # the share at rtol 1e-6 in float32 moves with the CG's start (PERF.md
    # section 7.12): held against the run that starts where the OO model
    # does, and against the converged share within float32's clamp
    gap = abs(oo.activated_share - LV_CONVERGED_SHARE)
    print(f"{tag} activated share {oo.activated_share:.6f} against the converged {LV_CONVERGED_SHARE} "
          f"({100 * gap:.2f} points; limit 1.0)")
    require(abs(oo.activated_share - refs["fused, CG from v_prev"].activated_share) <= 0.005,
            "OO LV activated share within 0.5 points of the fused theta=1 run's (CG from v_prev)")
    require(gap <= 0.01, "OO LV activated share within 1.0 point of the converged share")
    require(launches.get("torord_grl_step_v", 0) == 3 * oo.n_steps, "the OO LV launches ToR-ORd's B1 3 times a step")
    require(launches.get("csr_spmv", 0) > 0, "the OO LV runs B8")


def phase_oo_kernel_check(steady: dict) -> None:
    """The OO LV at psize 0.3 (the pre-paced ToR-ORd layers, Godunov), 40
    steps on the kernels and on the twins from the state the kernels reach
    at the kernel check's start (after the stimulated layer's upstroke):
    max |dv| < 1e-2, ``kernel_check``'s limit."""
    import numpy as np

    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import LV_CHECK_START, THRESHOLD
    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES, lv_amplitude, lv_layers
    from fenicsx_beat_tpu_torch.benchmarks.lv_endocardial import build_oo_lv
    from fenicsx_beat_tpu_torch.conductivities import default_conductivities, define_conductivity_tensor
    from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu_torch.stimulation import define_stimulus
    from fenicsx_beat_tpu_torch.units import ureg

    geo = get_lv_ellipsoid_geometry(psize_ref=LV_CHECK_PSIZE, cache=False)
    layers = lv_layers(geo, fem.functionspace(geo.mesh, ("P", 1)), precond="jacobi", device=DEVICE)
    M = define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer"))

    def build(use_kernels):
        I_s = define_stimulus(mesh=geo.mesh, chi=1400.0 * ureg("cm**-1"), time=fem.Constant(0.0),
                              subdomain_data=geo.ffun, marker=geo.markers["ENDO"][0], mesh_unit="cm",
                              amplitude=lv_amplitude(LV_CHECK_PSIZE), duration=1.0)
        return build_oo_lv(geo.mesh, layers, M, I_s, steady, device=DEVICE, use_kernels=use_kernels)

    def march(solver, t0, n_steps):
        for i in range(n_steps):
            solver.step((t0 + i * DT, t0 + (i + 1) * DT))

    ref = build(True)  # the shared start comes from the kernels (the twins' 5 ms cost more)
    march(ref, 0.0, int(round(LV_CHECK_START / DT)))
    wrappers = kernel_wrappers()
    v = {}
    for k in (True, False):
        solver = build(k)
        for m in CELLTYPES:
            solver.ode.values(m).copy_(ref.ode.values(m))
        solver.pde.state.x.array[:] = ref.pde.state.x.array
        solver.pde.assign_previous()
        zero_launches(wrappers)
        march(solver, LV_CHECK_START, 40)
        v[k] = np.array(solver.pde.state.x.array)
        launches = oo_launches(wrappers)
        print(f"[oo_kernel_check] ({card()}) {'kernels' if k else 'twins'}: launches {json.dumps(launches)}")
        if k:
            require(launches.get("torord_grl_step_v", 0) == 3 * 40 and launches.get("csr_spmv", 0) > 0,
                    "the OO LV kernel run launches ToR-ORd's B1 3 times a step and B8")
        else:
            require(not launches, "the OO LV twin run launches no kernel")
    dv = float(np.abs(v[True] - v[False]).max())
    print(f"[oo_kernel_check] ({card()}) OO LV psize {LV_CHECK_PSIZE}, n={v[True].size}, 40 steps from "
          f"{LV_CHECK_START:g} ms: max|dv| kernels vs twins {dv:.3e} (limit {THRESHOLD:g})")
    require(dv < THRESHOLD, "OO LV kernels vs twins max|dv| < 1e-2")


def phase_oo_row_aliasing() -> None:
    """B1 as the OO adapters call it, with the state tensor's own voltage
    row as its voltage input (B1 reads V from that input and writes the
    row), against B1 given a copy of the row: the same bits after 3 steps
    at the Niederer slab's width, for the four hand-written models in both
    B1 forms, from states spread over the action potential (V from -90 to
    40 mV; the staged ToR-ORd and Land kernels prefetch states with
    ``cp.async``)."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.models import fitzhughnagumo, tentusscher_panfilov_2006, torord_dyncl
    from fenicsx_beat_tpu_torch.models import torord_dyncl_land
    from fenicsx_beat_tpu_torch.ops import cuda_ode

    rng = np.random.default_rng(7)
    for model in (tentusscher_panfilov_2006, torord_dyncl, torord_dyncl_land, fitzhughnagumo):
        spec = cuda_ode.IONIC_MODELS[model.generalized_rush_larsen]
        init = np.asarray(model.init_state_values(), dtype=np.float64)
        states = np.tile(init[:, None], (1, N_MAIN)) * (1.0 + 0.01 * rng.standard_normal((init.size, N_MAIN)))
        states[spec.v_index] = rng.uniform(-90.0, 40.0, N_MAIN)
        params = np.asarray(model.init_parameter_values(), dtype=np.float64)
        field = torch.tensor(np.tile(params[:, None], (1, N_MAIN)), dtype=torch.float32, device=DEVICE)
        for form, step, p in (("vector", spec.step, params), ("field", spec.node_step, field)):
            a = torch.tensor(states, dtype=torch.float32, device=DEVICE)
            b = a.clone()
            for k in range(3):
                step(a, a[spec.v_index], DT * k, DT, p)
                step(b, b[spec.v_index].clone(), DT * k, DT, p)
            torch.cuda.synchronize()
            same = bool(torch.equal(a, b))
            print(f"[oo_aliasing] ({card()}) {model.__name__.rsplit('.', 1)[1]} {form} form, n={N_MAIN}, 3 steps: "
                  f"B1 with its own voltage row {'gives' if same else 'does not give'} a copy's bits")
            require(same and bool(torch.isfinite(a).all()),
                    f"{model.__name__} B1 ({form} form) with its own voltage row gives a copy's bits")
        del field


def march_oo(setup, T: float, snap_at: float | None = None, t0: float = 0.0, act=None) -> dict:
    """Step :func:`build_niederer_oo`'s solver from ``t0`` to ``T`` by
    ``DT`` as ``run_niederer_oo`` does (the host activation stamp ``act``
    at every PDE dof after each step, new when None); with ``snap_at``,
    copy the ODE states and the PDE voltage after the step ending there (a
    kernel check's start)."""
    import numpy as np
    import torch

    solver = setup.solver
    pde, ode = solver.pde, solver.ode
    k0, n_steps = int(round(t0 / DT)), int(round((T - t0) / DT))
    snap_step = None if snap_at is None else int(round(snap_at / DT))
    act = np.full(pde.V.ndofs, -1.0) if act is None else act
    cg0, syncs0, cross0 = pde.cg_iterations, pde._pde.host_syncs, solver.host_transfers
    converged, snap = True, None
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for k in range(k0, k0 + n_steps):
        solver.step((k * DT, (k + 1) * DT))
        converged &= pde._last_solve_converged
        v = pde.state.x.array
        act[(v > 0.0) & (act < 0)] = k * DT
        if k + 1 == snap_step:
            snap = (ode.values.clone(), v.copy())
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    probes = setup.probes(act)
    return {
        "probes": [probes[f"P{i}"] for i in range(1, 10)], "n_steps": n_steps, "wall": wall, "act": act,
        "ms_per_s": n_steps * DT / wall, "cg": (pde.cg_iterations - cg0) / n_steps,
        "syncs": (pde._pde.host_syncs - syncs0) / n_steps, "crossings": (solver.host_transfers - cross0) / n_steps,
        "converged": converged, "snap": snap,
        "finite": bool(torch.isfinite(ode.values).all()) and bool(np.isfinite(pde.state.x.array).all()),
    }


def spaces_kernel_check(kernel_setup, snap, t0: float, build_twin) -> float:
    """40 steps from ``snap`` (ODE states, PDE voltage at ``t0``) on the
    kernels (``kernel_setup``, reset to the snapshot) and on the twins (a
    solver ``build_twin`` makes): max |dv| at the PDE dofs."""
    import numpy as np

    wrappers = kernel_wrappers()
    v = {}
    for k, setup in ((True, kernel_setup), (False, build_twin())):
        solver = setup.solver
        solver.ode.values.copy_(snap[0])
        solver.pde.state.x.array[:] = snap[1]
        solver.pde.assign_previous()
        zero_launches(wrappers)
        for i in range(40):
            solver.step((t0 + i * DT, t0 + (i + 1) * DT))
        v[k] = np.array(solver.pde.state.x.array)
        launches = oo_launches(wrappers)
        if k:
            require(launches.get("tp06_grl_step_v", 0) == 2 * 40, "the kernel check's kernel run launches B1")
        else:
            require(not launches, "the kernel check's twin run launches no kernel")
    return float(np.abs(v[True] - v[False]).max())


def spaces_line(tag: str, r: dict, launches: dict, setup_s: dict, n: int, n_ode: int) -> None:
    print(f"{tag} dx={SPACES_DX} Strang dt={DT} {r['n_steps'] * DT:g} ms, {n} PDE dofs, {n_ode} ODE points: "
          f"ms_per_s={r['ms_per_s']:.3f} (wall {r['wall']:.3f} s), cg_iters mean={r['cg']:.3f}, "
          f"host_syncs_per_step={r['syncs']:.3f}, voltage host crossings per step {r['crossings']:.3f}; "
          f"converged {r['converged']}, finite {r['finite']}")
    print(f"{tag} host setup s by part " + json.dumps({k: round(v, 3) for k, v in setup_s.items()})
          + f"; launches {json.dumps(launches)}")


def phase_spaces(main_at: list) -> None:
    """The OO path on spaces beyond P1, through B1, B8 and the structured
    PCG (no kernel of its own): (a) Path P2, the Niederer slab at dx=0.2
    with the PDE and TP06 on P2 (442,401 dofs), Strang, 40 ms; (b) Path Q,
    the same slab with the PDE on P1 (58,176 nodes, B2·B4 + B3) and TP06 at
    the Quadrature_2 points (2,520,000), 10 ms, its two rectangular
    transfers through B8; each with the 40-step kernel check from mid-run
    (:func:`phase_spaces_dx05` runs both at dx=0.5)."""
    import math

    import torch

    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import THRESHOLD
    from fenicsx_beat_tpu_torch.benchmarks.niederer import PUBLISHED_ACTIVATION_TIMES, build_niederer_oo
    from fenicsx_beat_tpu_torch.ops.cuda_ell import csr_spmv, csr_spmv_twin

    wrappers = kernel_wrappers()
    stencil = ("stencil_spmv_sym", "stencil_spmv_sym_dir_dot", "cg_update", "axpy", "stencil_spmv")

    # (a) Path P2
    tag = f"[spaces_p2] ({card()})"
    setup = build_niederer_oo(SPACES_DX, degree=2, device=DEVICE)
    n = setup.solver.pde.V.ndofs
    require(n == N_SPACES_P2 and not setup.solver.pde._pde.structured, "Path P2: 442,401 dofs on the CSR path")
    zero_launches(wrappers)
    r = march_oo(setup, SPACES_P2_T, snap_at=SPACES_CHECK_AT)
    launches = oo_launches(wrappers)
    spaces_line(tag, r, launches, setup.setup_s, n, setup.solver.ode.num_points)
    by_40 = min(r["probes"]) >= 0
    print(f"{tag} P1-P9 at {SPACES_P2_T:g} ms " + " ".join(f"{a:.2f}" for a in r["probes"])
          + f" (-1: not fired); all nine fired by {SPACES_P2_T:g} ms: {'met' if by_40 else 'not met'}")
    # on in 5 ms pieces until all nine fired (P2 with the ionic step at the
    # dofs conducts slower than P1 at dx=0.1: P4 and P8 fire after 40 ms)
    t_end, run = SPACES_P2_T, r
    while min(run["probes"]) < 0 and t_end < SPACES_P2_T_MAX:
        run = march_oo(setup, t_end + 5.0, t0=t_end, act=run["act"])
        t_end += 5.0
        r["converged"] &= run["converged"]
        r["finite"] = run["finite"]
    for key in ((SPACES_DX, 0.005), (0.1, 0.005)):
        ref = PUBLISHED_ACTIVATION_TIMES[key]
        err = max(abs(a - b) / b for a, b in zip(run["probes"], ref)) if min(run["probes"]) >= 0 else math.inf
        print(f"{tag} P1-P9 by {t_end:g} ms " + " ".join(f"{a:.2f}" for a in run["probes"])
              + f"; max rel. error vs the published dx={key[0]} dt->0 row {err:.4%}")
    print(f"{tag} the fused main path's dx=0.1 P1 values in this run: " + " ".join(f"{a:.2f}" for a in main_at))
    require(min(run["probes"]) >= 0, f"Path P2: all nine probes fire by {SPACES_P2_T_MAX:g} ms")
    require(r["converged"] and r["finite"], "Path P2: every step converged, every state finite")
    require(launches.get("tp06_grl_step_v", 0) == 2 * r["n_steps"] and launches.get("csr_spmv", 0) > 0,
            "Path P2 launches B1 twice a step and B8")
    require(not any(launches.get(k, 0) for k in stencil), "Path P2 launches no stencil kernel")
    dv = spaces_kernel_check(setup, r["snap"], SPACES_CHECK_AT,
                             lambda: build_niederer_oo(SPACES_DX, degree=2, device=DEVICE, use_kernels=False))
    print(f"{tag} kernel check, 40 steps from {SPACES_CHECK_AT:g} ms: max|dv| kernels vs twins {dv:.3e} "
          f"(limit {THRESHOLD:g})")
    require(dv < THRESHOLD, "Path P2 kernels vs twins max|dv| < 1e-2")
    del setup

    # (b) Path Q
    tag = f"[spaces_q] ({card()})"
    setup = build_niederer_oo(SPACES_DX, ode_space="Quadrature_2", device=DEVICE)
    pde, ode = setup.solver.pde, setup.solver.ode
    n, n_q = pde.V.ndofs, ode.num_points
    require(n == N_SPACES_Q_NODES and n_q == N_SPACES_Q_POINTS and pde._pde.structured,
            "Path Q: 58,176 P1 nodes on the stencil PCG, 2,520,000 ODE points")
    zero_launches(wrappers)
    r = march_oo(setup, SPACES_Q_T, snap_at=SPACES_Q_T / 2)
    launches = oo_launches(wrappers)
    spaces_line(tag, r, launches, setup.setup_s, n, n_q)
    print(f"{tag} P1-P9 at {SPACES_Q_T:g} ms " + " ".join(f"{a:.2f}" for a in r["probes"]) + " (-1: not fired); "
          f"v_max {float(pde.state.x.array.max()):.3f} mV, nodes fired {int((r['act'] >= 0).sum())} of {n}")
    big, small = 6, 5  # a Strang step's crossings of the ODE points' and the nodes' voltage
    print(f"{tag} crossings a step: {big} of {n_q} values and {small} of {n} values, "
          f"{4 * (big * n_q + small * n) / 1e6:.3f} MB a step as float32")
    require(r["converged"] and r["finite"], "Path Q: every step converged, every state finite")
    require(launches.get("tp06_grl_step_v", 0) == 2 * r["n_steps"], "Path Q launches B1 twice a step")
    require(launches.get("csr_spmv", 0) == 3 * r["n_steps"], "Path Q launches B8 three times a step (its transfers)")
    require_structured_pcg(launches, "Path Q")
    V_q = ode.v_ode.function_space
    for name, Vs, Vt, x in (("Q->P1", V_q, pde.V, ode.values[ode.v_index]),
                            ("P1->Q", pde.V, V_q, torch.as_tensor(pde.state.x.array, device=DEVICE).float())):
        T = fem.transfer_operator(Vs, Vt, pde.device, pde._dtype)
        err = compare((csr_spmv(T, x.contiguous()),), (csr_spmv_twin(T, x.contiguous()),))
        rows = torch.diff(T.indptr)
        print(f"{tag} transfer {name} {T.shape[0]} x {T.shape[1]}, {T.nnz} entries (rows of {int(rows.min())}-"
              f"{int(rows.max())}, {int(T.long_rows.numel())} longer than 32): B8 vs twin max|diff| {err[0]:.3e}, "
              f"relative {err[1]:.3e}")
        require(err[1] <= REL_TOL, f"Path Q's {name} transfer: B8 within {REL_TOL} of max|twin|")
    dv = spaces_kernel_check(setup, r["snap"], SPACES_Q_T / 2,
                             lambda: build_niederer_oo(SPACES_DX, ode_space="Quadrature_2", device=DEVICE,
                                                       use_kernels=False))
    print(f"{tag} kernel check, 40 steps from {SPACES_Q_T / 2:g} ms: max|dv| kernels vs twins {dv:.3e} "
          f"(limit {THRESHOLD:g})")
    require(dv < THRESHOLD, "Path Q kernels vs twins max|dv| < 1e-2")


def phase_spaces_dx05() -> None:
    """Paths P2 and Q at dx=0.5, 40 ms, on the card: P1-P9 each within one
    dt of the JAX package's float64 values (:data:`JAX_SPACES_DX05`)."""
    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_oo

    for name, kw in (("p2", {"degree": 2}), ("q", {"ode_space": "Quadrature_2"})):
        res = run_niederer_oo(dx=0.5, dt=DT, T=40.0, theta=0.5, device=DEVICE, **kw)
        at = [res.activation_times[f"P{i}"] for i in range(1, 10)]
        gap = max(abs(a - b) for a, b in zip(at, JAX_SPACES_DX05[name]))
        print(f"[spaces_dx05] ({card()}) {name}: n={res.n_nodes}, {res.n_ode_points} ODE points, P1-P9 "
              + " ".join(f"{a:.2f}" for a in at) + f"; JAX " + " ".join(f"{a:.2f}" for a in JAX_SPACES_DX05[name])
              + f"; max |P - P_jax| {gap:.3f}; ms_per_s={res.ms_per_second:.3f}, cg_iters mean={res.cg_iters_mean:.3f}")
        require(res.status.name == "OK", f"dx=0.5 {name}: every CG converged")
        require(gap <= DT + 1e-6, f"dx=0.5 {name}: P1-P9 within one dt of the JAX package's float64 values")


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
    main = ECGRecovery(v=fem.Function(fem.functionspace(geo.mesh, ("P", 1))), M=M, device=DEVICE,
                       operator_cache_key=CACHE_KEY)
    print(f"[ecg_setup] dx=0.1: n={main.V.ndofs}, kernel {main.kernel}, offsets {main.offsets}, "
          f"host setup {time.perf_counter() - tic:.1f} s (assembly {main.setup_s['assembly_s']:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    scale = build_ecg_scale(dx=0.05, device=DEVICE, operator_cache_key=CACHE_KEY)  # its pair: the prefetch's
    e = scale.ecg
    peak = torch.cuda.max_memory_allocated() / 2**30
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[ecg_setup] dx=0.05: n={scale.V.ndofs}, {scale.n_cells} cells, kernel {e.kernel}, "
          f"clusters {window_spans(e.offsets)}; mesh {scale.mesh_build_s:.1f} s, recovery "
          f"{scale.recovery_setup_s:.1f} s (assembly {e.setup_s['assembly_s']:.1f} s, from the operator cache: the "
          f"prefetch's pair, operators to the "
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
            print(f"[kernels] library SpMV (torch.mv, CSR) at n={n} (K={K}): device time "
                  f"{device_us_per_call(lambda: sparse_mv(S, x)):.2f} us per call (torch.profiler)")
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


def _lead_gaps(a: dict, b: dict) -> dict:
    import numpy as np

    return {k: float(np.abs(np.subtract(a[k], b[k])).max() / max(np.abs(b[k]).max(), 1e-30)) for k in b}


def phase_ecg_main() -> dict:
    """Configuration 1: the dx=0.1 Strang slab, 40 ms, a pseudo-ECG frame
    every 1 ms, on the kernels (launches counted) and its first
    :data:`ECG_TWIN_T` ms on the twins, the kernel run's frames there held
    to :data:`ECG_LEAD_TOL` (3x the float32 noise measured over 40 ms with
    the PDE SpMV summed in another order, PERF.md)."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.benchmarks.ecg_scale import run_niederer_ecg

    kw = dict(dx=0.1, dt=DT, T=40.0, theta=0.5, frame_ms=1.0, device=DEVICE, operator_cache_key=CACHE_KEY)
    wrappers = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(wrappers)
    res = run_niederer_ecg(**kw)
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    twin = run_niederer_ecg(**{**kw, "T": ECG_TWIN_T}, use_kernels=False)

    for tag, r in (("kernels", res), ("twins", twin)):
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
    gap = _lead_gaps({k: v[:len(twin["leads"][k])] for k, v in res["leads"].items()}, twin["leads"])
    print(f"[ecg_main] per lead max|kernels - twins| / max|twins| over the twins' {ECG_TWIN_T:g} ms: "
          + ", ".join(f"{k}={v:.2e}" for k, v in gap.items()))
    print(f"[ecg_main] max lead gap {max(gap.values()):.3e} (limit {ECG_LEAD_TOL:g}); peak device memory "
          f"{peak:.2f} GiB; launches {json.dumps(launches)}")
    for r in (res, twin):
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



def phase_adjoint(ref_proc) -> tuple[dict, dict]:
    """Phase 19, the differentiable solver on the card: (a) B8's
    combination on the LV operator group (mass, fiber, transverse) at
    psize 0.15, forward, dx and dw against the twin's within 1e-4 of
    max|twin|, the same bits over two calls, device time of forward and
    backward beside torch.mv's; (b) one 10 ms window of
    host_segmented_value_and_grad on the lv fit problem through the lane
    path and through the plain path (B8's twin), value and gradients within
    3x the largest gap of each path to its runs from states one ulp away
    and with its rows summed in reverse (:data:`ADJ_WITNESS_NOISE`), every
    gradient finite; (c) one Adam step of
    the fit from (b)'s lane gradient: the loss at the new point, from a
    forward sweep, below (b)'s; (d) the lane window of the same fit at
    psize 0.5 over 10 ms (two 5 ms segments) against the CPU's float64
    window of the same problem (``fit_scale.py reference``, ``ref_proc``
    from :func:`fit_reference`, run beside the phases), value and gradients within 3x
    the largest gap to the float64 one of the CPU's float32 window and its
    runs from states one ulp away (three seeds).  Prints nodes, seconds per segment forward
    and backward, CG iterations per step in forward and adjoint solves, host
    syncs, B8 launches per step and peak memory.  Returns the two B8 rows
    and their launches in (b)'s lane run."""
    return _adjoint_checks(ref_proc, time.perf_counter())


def _adjoint_checks(ref_proc, tic: float) -> tuple[dict, dict]:
    """Phase 19's checks (:func:`phase_adjoint`), ``ref_proc`` the CPU
    reference's process."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.adjoint import LaneCombo
    from fenicsx_beat_tpu_torch.benchmarks import fit_scale as fs
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_us_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_ell

    prob = fs.build_problem("lv", psize=ADJ_PSIZE, T=ADJ_T, device=DEVICE)
    setup_s = time.perf_counter() - tic
    sim = prob.raw_sim
    combo = sim.lane_combo
    n = prob.mesh.num_vertices
    require(combo is not None, "the LV fit takes the lane path (B8's combination) on the card")
    print(f"[adjoint] lv fit problem: psize {ADJ_PSIZE}, {n} nodes, {combo.parts[0].nnz} entries, "
          f"host setup {setup_s:.1f} s")

    # (a) B8's combination against the twin: the fit's theta-system weights
    dev = prob.states0.device
    rng = np.random.default_rng(19)
    g = np.asarray(fs.G_TRUE) * np.asarray((0.5, 1.8))
    w = torch.as_tensor(np.concatenate([[1.0], 0.05 * g]), device=dev).to(torch.float32)
    x = torch.as_tensor(rng.uniform(-90.0, 40.0, n), device=dev).to(torch.float32)
    yb = torch.as_tensor(rng.standard_normal(n), device=dev).to(torch.float32)
    A_w = combo.matrix(w)

    def kernel_pass():
        wr, xr = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
        y = combo.mv(wr, xr, A_w)
        y.backward(yb)
        return y.detach(), xr.grad, wr.grad

    def twin_vjp():
        dx = cuda_ell.csr_spmv_twin(A_w, yb)
        dw = torch.stack([torch.dot(yb, cuda_ell.csr_spmv_twin(K, x)) for K in combo.parts])
        return dw, dx

    y_k, dx_k, dw_k = kernel_pass()
    y_t = cuda_ell.csr_spmv_twin(A_w, x)
    dw_t, dx_t = twin_vjp()
    err_f = compare((y_k,), (y_t,))
    err_b = compare((dx_k, dw_k), (dx_t, dw_t))
    again = kernel_pass()
    same = all(torch.equal(a, b) for a, b in zip((y_k, dx_k, dw_k), again))
    f32, nnz, nc = 4, A_w.nnz, len(combo.parts)
    S_w = torch.sparse_csr_tensor(A_w.indptr, A_w.cols, A_w.vals, A_w.shape)
    rows = {
        "csr_spmv[combination]": row(
            err_f,
            time_ms(lambda: combo.mv(w, x, A_w)),
            time_ms(lambda: cuda_ell.csr_spmv_twin(A_w, x)),
            bound(nnz * 2 * f32 + (n + 1) * f32 + 2 * n * f32, 2 * nnz),
            library_time(lambda: sparse_mv(S_w, x)),
        ),
        # dx = K(w) ybar and dw_i = ybar . (K_i x): every component's values
        # and the pattern read once, x and ybar read, dx and dw written
        "csr_spmv[combination backward]": row(
            err_b,
            time_ms(lambda: combo.vjp(x, yb, A_w)),
            time_ms(twin_vjp),
            bound(nnz * (nc + 1) * f32 + (n + 1) * f32 + 3 * n * f32 + nc * f32, 2 * nnz * (nc + 1) + 2 * n * nc),
            None,
        ),
    }
    dev_us = {"forward": device_us_per_call(lambda: combo.mv(w, x, A_w)),
              "backward": device_us_per_call(lambda: combo.vjp(x, yb, A_w))}
    try:
        dev_us["torch.mv"] = device_us_per_call(lambda: sparse_mv(S_w, x))
    except (RuntimeError, NotImplementedError) as exc:
        print(f"[adjoint] torch.mv refused: {type(exc).__name__}: {str(exc)[:200]}")
    print(f"[adjoint] (a) B8's combination, {nc} operators of {nnz} entries: forward rel err "
          f"{err_f[1]:.3e}, backward (dx, dw) {err_b[1]:.3e}; bits equal over two calls: {same}; device time "
          f"forward {dev_us['forward']:.2f} us, backward {dev_us['backward']:.2f} us ({nc + 1} B8 launches and "
          f"{nc} dots), torch.mv " + (f"{dev_us['torch.mv']:.2f} us" if "torch.mv" in dev_us else "refused")
          + " (torch.profiler)")
    print_rows(rows)
    for name in rows:
        require(rows[name]["rel_err"] <= REL_TOL, f"{name} agrees with the twin within {REL_TOL:g} of max|twin|")
    require(same, "B8's combination gives the same bits over two calls, forward and backward")

    # (b) one 10 ms window: the lane path, then the plain path (B8's twin)
    g0 = fs.fit_start(prob)
    targets, target_s = prob.targets(fs.G_TRUE)
    prob_plain = fs.build_problem("lv", psize=ADJ_PSIZE, T=ADJ_T, device=DEVICE, use_lane_ops=False)
    require(prob_plain.raw_sim.lane_combo is None, "use_lane_ops=False takes the plain path (B8's twin)")
    n_steps = prob.n_seg * prob.seg_steps

    def window(p, states0=None):
        sec: dict = {}
        p.raw_sim.cg_counts.reset()
        torch.cuda.reset_peak_memory_stats()
        value, grads = fs.windowed_value_and_grad(p, g0, targets, states0=states0, segment_seconds=sec)
        gr = grads["g"].double().cpu().numpy()
        return value, gr, sec, p.raw_sim.cg_counts, torch.cuda.max_memory_allocated()

    cuda_ell.csr_spmv.launches = 0
    LaneCombo.backward_launches = 0
    lane = window(prob)
    b8_total, b8_back = cuda_ell.csr_spmv.launches, LaneCombo.backward_launches
    launches = {"csr_spmv[combination]": b8_total - b8_back, "csr_spmv[combination backward]": b8_back}
    c = lane[3]
    carry_mb = TP06_STATES * n * f32 / 2**20
    print(f"[adjoint] (b) lane path, one {ADJ_T:g} ms window ({prob.n_seg} segments of {prob.seg_steps} steps): "
          f"loss {lane[0]:.6e}, dL/dg {lane[1].tolist()}; seconds per segment forward "
          f"{np.mean(lane[2]['forward']):.3f}, backward {np.mean(lane[2]['backward']):.3f} (forward sweep without a "
          f"graph; backward = the segment again under autograd, its checkpointed steps recomputed, and the "
          f"adjoint solves); CG iterations per step: forward solves {c.forward_iterations / c.forward_solves:.3f} "
          f"({c.forward_solves} solves: the sweep, the backward's forward and its recomputation), adjoint "
          f"{c.adjoint_iterations / max(c.adjoint_solves, 1):.3f} ({c.adjoint_solves} solves); host syncs "
          f"{c.host_syncs} ({c.host_syncs / n_steps:.2f} a step); B8 launches {b8_total} "
          f"({b8_total / n_steps:.2f} a step, {b8_back} in the backward); peak memory {lane[4] / 2**30:.3f} GiB "
          f"against {prob.seg_steps} saved carries of {carry_mb:.2f} MiB = {prob.seg_steps * carry_mb / 1024:.3f} "
          f"GiB (the flat checkpoint: one carry a step of a segment); target sweep {target_s:.2f} s")
    plain = window(prob_plain)
    print(f"[adjoint] (b) plain path (B8's twin): loss {plain[0]:.6e}, dL/dg {plain[1].tolist()}; seconds per "
          f"segment forward {np.mean(plain[2]['forward']):.3f}, backward {np.mean(plain[2]['backward']):.3f}; CG "
          f"forward {plain[3].forward_iterations / plain[3].forward_solves:.3f}, adjoint "
          f"{plain[3].adjoint_iterations / max(plain[3].adjoint_solves, 1):.3f} a solve; peak memory "
          f"{plain[4] / 2**30:.3f} GiB")
    names = ["loss", "dL/dg_l", "dL/dg_t"]
    for i, name in enumerate(names):
        get = (lambda r: r[0]) if i == 0 else (lambda r, i=i: r[1][i - 1])
        gap = abs(get(lane) - get(plain))
        noise = ADJ_WITNESS_NOISE[name]
        print(f"[adjoint] (b) {name}: lane {get(lane):.9e}, plain {get(plain):.9e}, gap {gap:.3e}, float32 noise "
              f"(each path from states one ulp away and with its rows summed in reverse, fit_scale.py witness) "
              f"{noise:.3e} "
              f"({gap / noise:.2f}x, limit {ODE_NOISE_FACTOR:g}x)")
        require(gap <= ODE_NOISE_FACTOR * noise, f"the lane and plain windows' {name} agree within 3x float32's noise")
    for r, tag in ((lane, "lane"), (plain, "plain")):
        require(bool(np.isfinite(r[1]).all()) and np.isfinite(r[0]), f"the {tag} window's value and gradient are finite")
    require(launches["csr_spmv[combination]"] > 0 and launches["csr_spmv[combination backward]"] > 0,
            "the lane window launched B8 in the combination's forward and backward")
    del prob_plain

    # (c) one step of the fit's Adam (run_fit's first: log space, lr held)
    # from the lane window's gradient; the loss there from a forward sweep
    t_c = time.perf_counter()
    theta = torch.log(g0).clone().requires_grad_(True)
    opt, _ = fs.adam(theta, fs.LR, None)
    theta.grad = g0 * torch.as_tensor(lane[1], device=g0.device).to(g0.dtype)
    opt.step()
    g1 = torch.exp(theta.detach()).double().cpu().numpy()
    loss1 = fs.total_loss(prob, g1, targets)
    print(f"[adjoint] (c) one Adam step (lr {fs.LR:g} in log g) from g {g0.double().cpu().tolist()} to "
          f"{g1.tolist()} (truth {list(fs.G_TRUE)}): loss {lane[0]:.6e} -> {loss1:.6e} "
          f"({time.perf_counter() - t_c:.2f} s)")
    require(np.isfinite(loss1) and loss1 < lane[0], "the fit's loss falls after one Adam step")
    del prob

    # (d) the lane window at psize 0.5 against the CPU's float64 window
    t_d = time.perf_counter()
    small = fs.build_problem("lv", psize=fs.REF_PSIZE, T=fs.REF_T, segment_ms=fs.REF_SEGMENT_MS, device=DEVICE,
                             use_lane_ops=True)
    card = fs.first_window(small)
    card_s = time.perf_counter() - t_d
    t_w = time.perf_counter()
    out, err = ref_proc.communicate(timeout=900)
    require(ref_proc.returncode == 0, f"fit_scale.py reference ran on the CPU (exit {ref_proc.returncode}): "
                                      f"{err[-2000:]}")
    ref = json.loads(out.strip().splitlines()[-1])
    f64 = np.asarray(ref["runs"]["f64"])
    witnesses = np.asarray([r for k, r in ref["runs"].items() if k != "f64"])
    print(f"[adjoint] (d) the lv window at psize {fs.REF_PSIZE} ({small.mesh.num_vertices} nodes), {fs.REF_T:g} ms "
          f"in {small.n_seg} segments of {fs.REF_SEGMENT_MS:g} ms, on B8's combination: {card_s:.1f} s; the CPU's "
          f"reference {ref['seconds']:.1f} s in its own process, waited for {time.perf_counter() - t_w:.1f} s")
    for i, name in enumerate(names):
        gap = abs(card[i] - f64[i])
        noise = float(np.abs(witnesses[:, i] - f64[i]).max())
        print(f"[adjoint] (d) {name}: card float32 {card[i]:.9e}, CPU float64 {f64[i]:.9e}, gap {gap:.3e}; CPU "
              f"float32 from the same states and from states one ulp away {witnesses[:, i].tolist()}, float32 "
              f"noise (the largest gap to float64) {noise:.3e} ({gap / noise:.2f}x, limit {ODE_NOISE_FACTOR:g}x)")
        require(gap <= ODE_NOISE_FACTOR * noise, f"the card's window's {name} within 3x float32's noise of the "
                                                 f"CPU's float64 window")

    print(f"[adjoint] phase 19 took {time.perf_counter() - tic:.1f} s")
    return rows, launches



# ----------------------------------------------------------------------
# phase 20: SA-AMG and the biventricle
# ----------------------------------------------------------------------
BIV_PSIZE = 0.15  # the BiV demo at full width: about 10^5 nodes (9,506 at the demo's default 0.35)
BIV_T = 20.0  # the demo's horizon (ms)
BIV_POINTS = 20  # the demo's activation sites
BIV_CHECK_AT = 10.0  # kernels vs twins: 40 steps from mid-run
# the conduction check: the demo's sites at 1 uF/cm^2 (0.01 uF/mm^2; the
# demo's default 1 uF/mm^2 leaves the excitation within about one element
# of each site), boxes of this half-width (mm) driven at the demo's rate of
# depolarization, over BIV_WAVE_T ms; held: nodes beyond BIV_WAVE_MM of
# every site fired, and at least BIV_WAVE_SHARE of all nodes
BIV_WAVE_C_M, BIV_WAVE_TOL, BIV_WAVE_T, BIV_WAVE_MM, BIV_WAVE_SHARE = 0.01, 1.0, 10.0, 2.0, 0.5
LAPLACE_TOL = 1e-4  # the card's Laplace solution against float64 (the coordinate lies in [0, 1])
BIDOMAIN_REF_NPZ = ROOT / "build" / "chip_smoke_bidomain_reference.npz"  # (c)'s CPU reference fields
AMG_WORST_RATIO = 0.5  # AMG's worst step at most this share of Jacobi's (JAX's tests/test_bidomain.py gate)


def host_laplace(K, bcs, n: int):
    """The masked Laplace solve in float64 on the host: scipy's CG with
    Jacobi on the free rows to rtol 1e-12 (``K_ff u_f = -K_fb g``)."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.linalg import cg

    g = np.zeros(n)
    free = np.ones(n, dtype=bool)
    for bc in bcs:
        g[bc.dofs] = bc.value
        free[bc.dofs] = False
    A = K[free][:, free].tocsr()
    b = -(K[free] @ g)
    M = sp.diags(1.0 / A.diagonal())
    try:
        x, info = cg(A, b, rtol=1e-12, atol=0.0, maxiter=20_000, M=M)
    except TypeError:  # scipy before 1.12 names it tol
        x, info = cg(A, b, tol=1e-12, atol=0.0, maxiter=20_000, M=M)
    require(info == 0, "the float64 host Laplace solve converged")
    u = g.copy()
    u[free] = x
    return u


def vcycle_bound_ms(h) -> float:
    """The sum of B8's bounds over one V-cycle of the device hierarchy
    ``h``: each product's bytes (indptr, cols and values read, x read,
    y written, float32 and int32) over the HBM rate; A is applied 2 *
    degree times a level, P and R once."""
    def spmv_bytes(M):
        n_rows, n_cols = M.shape
        return 4 * (n_rows + 1) + 8 * M.nnz + 4 * n_cols + 4 * n_rows

    total = sum(2 * h.degree * spmv_bytes(lv.A) + spmv_bytes(lv.P) + spmv_bytes(lv.R) for lv in h.levels)
    return 1e3 * total / HBM_BYTES_PER_S


def phase_amg_laplace(setup) -> None:
    """Phase 20 (a): the BiV's Laplace solves on the card.  The fibers'
    transmural solve (both endocardia 0, the epicardium 1) on "amg" and on
    "jacobi": iterations, AMG setup seconds and levels, wall, the solution
    against a float64 host solve (scipy) within :data:`LAPLACE_TOL`; the
    three-layer labels the card gave (``expand_layer_biv`` on AMG) against
    the float64 host labels, every differing node within the card's error
    of a threshold (0.3 or 0.7); one V-cycle of the fibers' hierarchy: its
    wall, device time and B8 launches against the sum of B8's bounds."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks.lv import LAYER_SIZE
    from fenicsx_beat_tpu_torch.benchmarks.profile_main import device_events_per_call
    from fenicsx_beat_tpu_torch.ops import cuda_ell
    from fenicsx_beat_tpu_torch.ops.amg import amg_apply, build_amg, operator_to_csr
    from fenicsx_beat_tpu_torch.utils import _laplace_solve

    tag = f"[amg] ({card()})"
    geo, V = setup.geo, setup.V
    n = V.ndofs
    K = operator_to_csr(fem.assemble_mass_stiffness(V, 1.0)[1])

    def dofs(key):
        return fem.locate_dofs_topological(V, 2, geo.ffun.find(geo.markers[key][0]))

    endo = np.unique(np.concatenate([dofs("LV"), dofs("RV")]))
    epi = fem.dirichletbc(1.0, dofs("EPI"), V)
    fiber_bcs = [fem.dirichletbc(0.0, endo, V), epi]
    tic = time.perf_counter()
    ref = host_laplace(K, fiber_bcs, n)
    host_s = time.perf_counter() - tic
    iters, errs = {}, {}
    for precond in ("amg", "jacobi"):
        cuda_ell.csr_spmv.launches = 0
        torch.cuda.synchronize()
        tic = time.perf_counter()
        u, info = _laplace_solve(V, fiber_bcs, precond=precond, device=DEVICE)
        wall = time.perf_counter() - tic
        iters[precond], errs[precond] = info.iterations, float(np.abs(u.astype(np.float64) - ref).max())
        print(f"{tag} BiV psize {BIV_PSIZE} fibers' Laplace solve, n={n}, {precond}: {info.iterations} CG "
              f"iterations, converged {info.converged}, residual {info.residual_norm:.3e}, AMG levels "
              f"{info.amg_levels}, AMG setup {info.amg_setup_s:.2f} s, wall {wall:.2f} s, B8 launches "
              f"{cuda_ell.csr_spmv.launches}; max|u - float64| {errs[precond]:.3e} (float64 host solve {host_s:.1f} s)")
        require(info.converged, f"the BiV Laplace solve on {precond} converged")
        require(info.precond == precond and cuda_ell.csr_spmv.launches > info.iterations,
                f"the BiV Laplace solve on {precond} ran on B8")
    require(errs["amg"] <= LAPLACE_TOL, f"the card's AMG Laplace solution within {LAPLACE_TOL} of float64")
    require(iters["amg"] < iters["jacobi"], "AMG takes fewer CG iterations than Jacobi on the BiV")

    # the layers: the card's labels (expand_layer_biv, AMG) against float64 ones
    card_arr, host_arr = [], []
    for key in ("LV", "RV"):
        bcs = [fem.dirichletbc(0.0, dofs(key), V), epi]
        u, info = _laplace_solve(V, bcs, device=DEVICE)
        require(info.precond == "amg", "the BiV's layer solves take AMG")
        card_arr.append(u.astype(np.float64))
        host_arr.append(host_laplace(K, bcs, n))
    card_min, host_min = np.min(card_arr, axis=0), np.min(host_arr, axis=0)
    err = float(np.abs(card_min - host_min).max())
    host_labels = np.full(n, 0, dtype=np.int32)
    host_labels[host_min <= LAYER_SIZE] = 1
    host_labels[host_min >= 1 - LAYER_SIZE] = 2
    differ = setup.layers != host_labels
    near = np.minimum(np.abs(host_min - LAYER_SIZE), np.abs(host_min - (1 - LAYER_SIZE))) <= err
    print(f"{tag} layers (expand_layer_biv on the card, AMG): counts mid/endo/epi "
          f"{[int((setup.layers == m).sum()) for m in (0, 1, 2)]}; {int(differ.sum())} of {n} nodes differ from "
          f"the float64 labels, all within the card's error {err:.3e} of a threshold: {bool(near[differ].all())}")
    require(err <= LAPLACE_TOL, f"the card's layer coordinate within {LAPLACE_TOL} of float64")
    require(bool(near[differ].all()), "every label that differs from float64 lies within the error of a threshold")

    # one V-cycle of the fibers' hierarchy (laplace_solve's masked matrix)
    free = np.ones(n)
    free[fiber_bcs[0].dofs] = 0.0
    free[epi.dofs] = 0.0
    D = sp.diags(free)
    tic = time.perf_counter()
    h = build_amg(D @ K @ D)
    build_s = time.perf_counter() - tic
    hd = h.to_device(DEVICE)
    require(all(m.vals.device.type == torch.device(DEVICE).type and m.vals.dtype == torch.float32
                for lv in hd.levels for m in (lv.A, lv.P, lv.R)),
            "every AMG level's A, P and R lies on the card in float32")
    r = torch.as_tensor(np.random.default_rng(20).standard_normal(n) * free, device=DEVICE).float()
    cuda_ell.csr_spmv.launches = 0
    amg_apply(hd, r)
    per_cycle = cuda_ell.csr_spmv.launches
    require(per_cycle == (2 * h.degree + 2) * len(h.levels), "one V-cycle launches B8 2 * degree + 2 times a level")
    wall_ms = time_ms(lambda: amg_apply(hd, r), launches=10, reps=5)
    dev_us, events = device_events_per_call(lambda: amg_apply(hd, r), calls=20)
    bound = vcycle_bound_ms(hd)
    sizes = [lv.A.shape[0] for lv in hd.levels] + [int(hd.coarse_inv.shape[0])]
    print(f"{tag} one V-cycle (degree {h.degree}, levels {sizes}, host build {build_s:.2f} s): B8 launches "
          f"{per_cycle}, device launches {sum(events.values())}, back-to-back {wall_ms:.4f} ms, device time "
          f"{dev_us / 1e3:.4f} ms (torch.profiler), sum of B8's bounds {bound:.4f} ms "
          f"({dev_us / 1e3 / bound:.1f}x)")


def phase_biv(steady: dict) -> None:
    """Phase 20 (a) and (b): the BiV demo (``benchmarks/biv_endocardial.py``)
    at psize :data:`BIV_PSIZE` at full width: the demo's three ToR-ORd
    dynCl layers (the steady states of phase 7, 2 beats: a cut of the
    demo's own 1-beat pre-pacing, which they replace), 20 activation sites,
    20 ms, 1 ms checkpoints, the 12-lead ECG; setup seconds by part, ms/s,
    CG iterations, host syncs and crossings per step, launches, the
    activated shares at T of the LV side and the RV free wall, how far the
    excitation reached, each lead's extremes; every state finite, every
    picked node fired, both shares above 0, every lead finite with a
    range; then 40 steps from 10 ms on the kernels and on the twins, max
    |dv| < 1e-2.  The demo's excitation stays within about one element of
    each site (its membrane capacitance is 1 uF/mm^2), so conduction is
    held on a run of its own: the same BiV, sites and delays at 1 uF/cm^2
    (:data:`BIV_WAVE_C_M`) from boxes of half-width :data:`BIV_WAVE_TOL`,
    10 ms: nodes beyond 2 mm of every site fired, and half of all."""
    import numpy as np

    from fenicsx_beat_tpu_torch.benchmarks import biv_endocardial as biv
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import THRESHOLD
    from fenicsx_beat_tpu_torch.benchmarks.lv import CELLTYPES

    tag = f"[biv] ({card()})"
    tic = time.perf_counter()
    setup = biv.biv_setup(BIV_PSIZE, BIV_POINTS, device=DEVICE, cache=False)
    mesh = setup.geo.mesh
    print(f"{tag} geometry: {mesh.num_vertices} nodes, {mesh.num_cells} tets; setup {time.perf_counter() - tic:.1f} s: "
          + json.dumps(setup.setup_s))
    phase_amg_laplace(setup)
    tic = time.perf_counter()
    solver = biv.build_biv(setup, steady, device=DEVICE)
    setup.setup_s["assembly_s"] = time.perf_counter() - tic
    outdir = ROOT / "build" / "chip_smoke_biv"
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    res = biv.run_biv(solver, BIV_T, DT, checkpoint=outdir / "voltage", verbose=False, snapshot_at=BIV_CHECK_AT)
    run_launches = oo_launches(wrappers)
    times, leads, ecg = biv.biv_ecg(setup.V, setup.M, res.checkpoint, device=DEVICE)
    launches = oo_launches(wrappers)
    for t, lo, hi in res.v_range[::4]:
        print(f"{tag} t={t:6.1f}  v_range=[{lo:8.2f}, {hi:8.2f}]")
    rv = biv.rv_free_wall(mesh.coords)
    fired = res.activation >= 0
    lv_share, rv_share = float(fired[~rv].mean()), float(fired[rv].mean())
    n_steps = res.n_steps
    print(f"{tag} psize {BIV_PSIZE}, {mesh.num_vertices} nodes, Godunov dt={DT} {BIV_T:g} ms: setup by part "
          + ", ".join(f"{k} {v:.2f} s" for k, v in setup.setup_s.items() if k.endswith("_s"))
          + f"; ms_per_s={res.ms_per_second:.3f} (wall {res.wall_s:.2f} s), CG per step {res.cg_iters_sum / n_steps:.3f}, "
          f"host syncs per step {res.host_syncs / n_steps:.3f}, voltage host crossings per step "
          f"{res.host_transfers / n_steps:.3f}; activated share at {BIV_T:g} ms: LV side {lv_share:.4f}, RV free wall "
          f"(y > {biv.RV_FREE_Y} mm, {int(rv.sum())} nodes) {rv_share:.4f}; picked nodes fired "
          f"{int(fired[setup.picks].sum())} of {len(setup.picks)}; the excitation reached "
          f"{biv.spread_mm(mesh.coords, setup.picks, res.activation):.3f} mm from its site")
    print(f"{tag} ECG: {ecg['frames']} frames, recovery setup {ecg['setup_s']:.2f} s, {ecg['s_per_frame'] * 1e3:.1f} ms "
          f"a frame, CG per frame {ecg['cg_iters']}")
    for name in biv.LEAD_NAMES:
        sig = getattr(leads, name)
        print(f"{tag} lead {name:4s} min {sig.min():.4e} max {sig.max():.4e}")
    print(f"{tag} launches: the run {json.dumps(run_launches)}, with the ECG {json.dumps(launches)}")
    require(res.all_finite, "every BiV state finite")
    require(bool(fired[setup.picks].all()), "every picked endocardial node fired")
    require(lv_share > 0 and rv_share > 0, "the LV side and the RV free wall both activated")
    for name in biv.LEAD_NAMES:
        sig = getattr(leads, name)
        require(bool(np.isfinite(sig).all()) and float(np.ptp(sig)) > 0, f"lead {name} finite with a range")
    require(run_launches.get("torord_grl_step_v", 0) == 3 * n_steps, "the BiV launches ToR-ORd's B1 3 times a step")
    require(run_launches.get("csr_spmv", 0) > 0 and launches["csr_spmv"] > run_launches["csr_spmv"],
            "the BiV run and its ECG run B8")

    # kernels vs twins: 40 steps from the run's state at 10 ms (the kernels
    # on the run's own solver, the twins on one built for them)
    snap = res.snapshot
    v = {}
    for k in (True, False):
        check = solver if k else biv.build_biv(setup, steady, device=DEVICE, use_kernels=False)
        for m in CELLTYPES:
            check.ode.values(m).copy_(snap["states"][m])
        check.pde.state.x.array[:] = snap["v"]
        check.pde.assign_previous()
        zero_launches(wrappers)
        for i in range(40):
            check.step((snap["t"] + i * DT, snap["t"] + (i + 1) * DT))
        v[k] = np.array(check.pde.state.x.array)
        got = oo_launches(wrappers)
        require(bool(got) == k, f"the BiV {'kernel' if k else 'twin'} run launches {'its kernels' if k else 'none'}")
        del check
    dv = float(np.abs(v[True] - v[False]).max())
    print(f"{tag} 40 steps from {snap['t']:g} ms: max|dv| kernels vs twins {dv:.3e} (limit {THRESHOLD:g})")
    require(dv < THRESHOLD, "BiV kernels vs twins max|dv| < 1e-2")
    del solver

    # conduction: the same BiV, sites and delays at 1 uF/cm^2
    wave = dataclasses.replace(setup, I_s=biv.site_stimulus(mesh, mesh.coords[setup.picks], setup.delays,
                                                            tol=BIV_WAVE_TOL, C_m=BIV_WAVE_C_M))
    tic = time.perf_counter()
    solver = biv.build_biv(wave, steady, device=DEVICE, C_m=BIV_WAVE_C_M)
    build_s = time.perf_counter() - tic
    zero_launches(wrappers)
    res = biv.run_biv(solver, BIV_WAVE_T, DT, verbose=False)
    wave_launches = oo_launches(wrappers)
    fired = res.activation >= 0
    dist = np.linalg.norm(mesh.coords[:, None, :] - mesh.coords[setup.picks][None], axis=-1).min(axis=1)
    far = dist > BIV_WAVE_MM
    print(f"{tag} conduction at C_m {BIV_WAVE_C_M:g} uF/mm^2, boxes of half-width {BIV_WAVE_TOL:g} mm, "
          f"{BIV_WAVE_T:g} ms: activated share {fired.mean():.4f} (LV side {fired[~rv].mean():.4f}, RV free wall "
          f"{fired[rv].mean():.4f}); beyond {BIV_WAVE_MM:g} mm of every site {int((fired & far).sum())} of "
          f"{int(far.sum())} nodes fired; the excitation reached {biv.spread_mm(mesh.coords, setup.picks, res.activation):.2f} "
          f"mm from its site; build {build_s:.2f} s, ms_per_s={res.ms_per_second:.3f}, CG per step "
          f"{res.cg_iters_sum / res.n_steps:.3f}; launches {json.dumps(wave_launches)}")
    require(res.all_finite, "every state of the conduction run finite")
    require(bool((fired & far).any()) and fired.mean() >= BIV_WAVE_SHARE,
            f"the wave spreads: nodes beyond {BIV_WAVE_MM:g} mm of every site fired, and {BIV_WAVE_SHARE:g} of all")
    require(wave_launches.get("torord_grl_step_v", 0) == 3 * res.n_steps and wave_launches.get("csr_spmv", 0) > 0,
            "the conduction run launches ToR-ORd's B1 and B8")


def bidomain_reference():
    """Phase 20 (c)'s CPU reference (``bidomain_scale.py --lv-reference``:
    the psize 0.3 LV over 5 ms in float64 and four float32 witnesses per
    scheme), a process of its own on two of the host's cores
    (:func:`start_background`), started at the run's start so that it is
    done by (c)."""
    return start_background(["-m", "fenicsx_beat_tpu_torch.benchmarks.bidomain_scale", "--lv-psize",
                             str(LV_CHECK_PSIZE), "--dt", str(DT), "--lv-reference", str(BIDOMAIN_REF_NPZ)], 2)


def fit_reference():
    """Phase 19 (d)'s CPU reference (``fit_scale.py reference``), a process
    of its own on one of the host's cores (:func:`start_background`),
    started at the run's start so that it is done by (d)."""
    return start_background(["-m", "fenicsx_beat_tpu_torch.benchmarks.fit_scale", "reference", "--device", "cpu"], 1)


def phase_bidomain_amg(ref_proc) -> None:
    """Phase 20 (c): the bidomain LV at psize 0.3 (9,780 nodes, TP06, phase
    13's LV) over 5 ms (``bidomain_scale.REFERENCE_T``), monolithic and Gauss-Seidel,
    on ``u_precond="auto"`` (SA-AMG on this mesh) and on Jacobi (chunks of
    100 steps): AMG engages under
    "auto"; setup and AMG setup seconds, CG iterations a step (mean and
    worst) and ms/s; AMG's worst step at most half of Jacobi's.  At the
    end, v and u_e against the float64 run of ``ref_proc``
    (:func:`bidomain_reference`): the AMG run within 3x the largest
    gap to it of the CPU's float32 AMG runs (from the same states and one
    ulp away), the Jacobi run within 3x that of the CPU's float32 Jacobi
    runs, and the AMG run against the Jacobi run within 3x the larger of
    the two.  The gap between the CPU's float32 Jacobi runs from the same
    states and from one ulp away is printed beside: it is float32's
    rounding alone, while at rtol 1e-6 the monolithic Jacobi run's u_e
    lies further from float64 than that."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.base_model import Status
    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs

    tag = f"[bidomain_amg] ({card()})"
    wrappers = kernel_wrappers()
    T = bs.REFERENCE_T
    fields = {}
    for scheme in ("monolithic", "gs"):
        runs = {}
        for name, precond in (("jacobi", "jacobi"), ("amg", "auto")):
            zero_launches(wrappers)
            tic = time.perf_counter()
            bi = bs.lv_solver(LV_CHECK_PSIZE, device=DEVICE, u_precond=precond, scheme=scheme)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - tic
            mon = bs._IterMonitor()
            bi.monitor = mon
            tic = time.perf_counter()
            ok = bi.solve((0.0, T), dt=DT, save_freq=bs.CHUNK_STEPS) == Status.OK
            torch.cuda.synchronize()
            wall = time.perf_counter() - tic
            runs[name] = r = dict(ok=ok, wall=wall, setup_s=setup_s, worst=max(mon.iters), chunks=mon.iters,
                                  launches=oo_launches(wrappers), amg=bi._u_amg, **bs.field_stats(bi))
            fields[scheme, name] = {"v": bi.v.double().cpu().numpy(), "u_e": bi.u_e.double().cpu().numpy()}
            print(f"{tag} LV psize {LV_CHECK_PSIZE} {scheme}, n={bi.V.ndofs}, u_precond "
                  f"{'amg' if bi._u_amg else 'jacobi'}: setup {setup_s:.2f} s (AMG {bi.amg_setup_s:.2f} s, "
                  f"{bi._amg.n_levels if bi._u_amg else 0} levels), {T:g} ms: ms_per_s={T / wall:.3f}, CG per step "
                  f"mean {bi.cg_iterations / bi.steps:.3f}, worst {r['worst']} (per chunk {r['chunks']}), host syncs "
                  f"per step {bi.host_syncs / bi.steps:.3f}; v_max {r['v_max']:.6g}, max|u_e| "
                  f"{r['u_e_max_abs']:.6g}, v>0 share {r['v_pos_share']:.6g}; launches {json.dumps(r['launches'])}")
            del bi
        jac, amg = runs["jacobi"], runs["amg"]
        require(amg["amg"] and not jac["amg"], f"'auto' engages AMG on the LV ({scheme})")
        require(all(r["ok"] and r["finite"] for r in runs.values()), f"the bidomain LV runs converge, finite ({scheme})")
        require(amg["worst"] <= AMG_WORST_RATIO * jac["worst"], f"AMG's worst step at most half of Jacobi's ({scheme})")
        require(amg["launches"].get("csr_spmv", 0) > 0 and amg["launches"].get("tp06_grl_step_v", 0) > 0,
                "the AMG run launches B8 and B1")

    tic = time.perf_counter()
    out, err = ref_proc.communicate(timeout=900)
    require(ref_proc.returncode == 0, f"bidomain_scale.py --lv-reference ran on the CPU (exit {ref_proc.returncode}): "
                                      f"{err[-2000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    print(f"{tag} the CPU reference (float64 and four float32 witnesses a scheme, its own process): waited for "
          f"{time.perf_counter() - tic:.1f} s; " + json.dumps(summary["runs"]))
    with np.load(BIDOMAIN_REF_NPZ) as f:
        ref = {k: f[k] for k in f.files}

    def gap(a, b, f):
        return float(np.abs(a[f] - b[f]).max())

    for scheme in ("monolithic", "gs"):
        f64 = {f: ref[f"{scheme}/f64/{f}"] for f in ("v", "u_e")}
        cpu = {name: {f: ref[f"{scheme}/{name}/{f}"] for f in ("v", "u_e")} for name, *_ in bs.REFERENCE_RUNS}
        card_runs = {k: fields[scheme, k] for k in ("jacobi", "amg")}
        for f in ("v", "u_e"):
            noise = {p: max(gap(cpu[f"f32_{p}"], f64, f), gap(cpu[f"f32_{p}_ulp"], f64, f)) for p in ("amg", "jacobi")}
            d_amg, d_jac = gap(card_runs["amg"], f64, f), gap(card_runs["jacobi"], f64, f)
            d_pair, d_ulp = gap(card_runs["amg"], card_runs["jacobi"], f), gap(cpu["f32_jacobi"], cpu["f32_jacobi_ulp"], f)
            pair_lim = max(noise.values())
            print(f"{tag} {scheme} {f} at {T:g} ms, against float64: AMG {d_amg:.3e} ({d_amg / noise['amg']:.2f}x the "
                  f"CPU's float32 AMG runs' {noise['amg']:.3e}), Jacobi {d_jac:.3e} ({d_jac / noise['jacobi']:.2f}x "
                  f"their {noise['jacobi']:.3e}); AMG vs Jacobi {d_pair:.3e} ({d_pair / pair_lim:.2f}x the larger); "
                  f"the CPU's float32 Jacobi runs from the same states and one ulp away differ by {d_ulp:.3e} "
                  f"(rounding alone; AMG vs Jacobi {d_pair / max(d_ulp, 1e-30):.2f}x that)")
            require(d_amg <= 3 * noise["amg"], f"the AMG run's {f} within 3x float32's AMG gap to float64 ({scheme})")
            require(d_jac <= 3 * noise["jacobi"],
                    f"the Jacobi run's {f} within 3x float32's Jacobi gap to float64 ({scheme})")
            require(d_pair <= 3 * pair_lim, f"AMG and Jacobi {f} within 3x float32's gap to float64 ({scheme})")


def phase_amg_biv(steady: dict, ref_proc) -> None:
    tic = time.perf_counter()
    phase_biv(steady)
    mid = time.perf_counter()
    phase_bidomain_amg(ref_proc)
    end = time.perf_counter()
    print(f"[biv] phase 20 took {end - tic:.1f} s: (a) and (b) {mid - tic:.1f} s, (c) {end - mid:.1f} s")

# Phase 23, the sharded solvers (fenicsx_beat_tpu_torch/parallel/): each
# world a spawn of ranks on the one card, world 1 on NCCL and world 2 on gloo
# (NCCL refuses two ranks on one device: gloo stages the transfers through
# pinned host memory and the compute stays on the card)
SHARD_WORLDS = ((1, "nccl"), (2, "gloo"))
SHARD_LV_T = 10.0  # (b)'s horizon (ms)
SHARD_TIMEOUT = 300.0  # one spawn's limit (s)
SHARD_WITNESS_SEEDS = (1, 2)  # (d)'s float32 witnesses from states one ulp away


def _lv_probes(V, act):
    import numpy as np

    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks.lv import lv_probe_points

    pts = lv_probe_points(LV_PSIZE)
    dofs, w = fem.point_evaluation_tables(V, np.array(list(pts.values())))
    return dict(zip(pts, (act[dofs] * w).sum(axis=1)))


def _spawn_world(world: int, backend: str, target, out: dict) -> None:
    """Phase 23's spawn of one world into ``out[world]`` (its exception there)."""
    from fenicsx_beat_tpu_torch.benchmarks import multichip as mc
    from fenicsx_beat_tpu_torch.parallel import spawn_ranks

    tic = time.perf_counter()
    try:
        out[world] = spawn_ranks(mc.phase_rank, world, backend=backend, args=("cuda", target, CACHE_KEY),
                                 timeout=SHARD_TIMEOUT)[0]
        out[world]["spawn_s"] = time.perf_counter() - tic
    except Exception as exc:  # raised by the caller after the join
        out[world] = exc


def phase_sharded(main: dict | None, ref_proc=None) -> None:
    """Phase 23 (module docstring): the world-2 spawn (gloo, a check, not a
    speed figure) beside the references on the card, then the world-1 spawn
    (NCCL) alone, then the checks.  (c) is held to phase 20 (c)'s float64
    reference (``ref_proc`` when it is still to come, as with ``--phase 23``)."""
    import threading

    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch.adjoint import build_diff_simulator
    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs
    from fenicsx_beat_tpu_torch.benchmarks import multichip as mc
    from fenicsx_beat_tpu_torch.bidomain import BidomainSolver
    from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver

    tag = f"[sharded] ({card()})"
    laps = Laps("[time] 23")
    if main is None:  # --phase 23 alone: the fused main path to compare with
        from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark

        res = run_niederer_benchmark(dx=0.1, dt=DT, T=40.0, theta=0.5, device=DEVICE, operator_cache_key=CACHE_KEY)
        main = {"at": [res.activation_times[f"P{i}"] for i in range(1, 10)], "ms_per_s": res.ms_per_second,
                "cg_mean": res.cg_iters_mean}
        laps("fused main path")
    # (d)'s target: the single-device simulator's traces on the card, times 0.9
    m3, kw = mc.adjoint_problem()
    sim = build_diff_simulator(m3, device=DEVICE, **kw)
    with torch.no_grad():
        target = sim({k: v.detach() for k, v in mc.adjoint_params(DEVICE, torch.float32).items()}) * 0.9
    # world 2 (gloo) beside the references; its ranks read the LV's geometry from the cache
    lv = mc.lv_setup(LV_PSIZE)
    runs = {}
    world2 = threading.Thread(target=_spawn_world, args=(2, "gloo", target.cpu().numpy(), runs))
    world2.start()
    # (b)'s reference: the fused LV from the same start
    fused = FusedMonodomainSolver(device=DEVICE, operator_cache_key=CACHE_KEY, **lv)
    fused.solve((0.0, SHARD_LV_T), dt=DT)
    lv_act, lv_V = fused.activation_times(), fused.V
    del fused
    laps("(b) fused LV")
    # (c): the single-device bidomain LV on AMG on the card (printed beside)
    b = BidomainSolver(device=DEVICE, u_precond="auto", **bs.lv_kwargs(LV_CHECK_PSIZE))
    b.solve((0.0, bs.REFERENCE_T), dt=DT, save_freq=bs.CHUNK_STEPS)
    bi = {"v": b.v.double().cpu().numpy(), "u_e": b.u_e.double().cpu().numpy()}
    del b
    laps("(c) single-device bidomain")
    # (d)'s references: the single-device simulator in float64 on the CPU
    # (the same tolerances), and its float32 witnesses on the card: from the
    # initial states, from states one ulp away, and with every node sum
    # taken in reverse (the nodes numbered backwards)
    adj = {}

    def value_grad(sim_, device, dtype, s0=None):
        params = mc.adjoint_params(device, dtype)
        loss = torch.mean((sim_(params, states0_in=s0) - target.to(device=device, dtype=dtype)) ** 2)
        (g,) = torch.autograd.grad(loss, [params["g"]])
        return float(loss.detach()), g.double().cpu().numpy()

    adj["f64"] = value_grad(build_diff_simulator(m3, device="cpu", dtype=torch.float64, **kw), "cpu", torch.float64)
    adj["f32"] = value_grad(sim, DEVICE, torch.float32)
    for seed in SHARD_WITNESS_SEEDS:
        init = np.tile(np.asarray(kw["init_states"], dtype=np.float32)[:, None], (1, m3.num_vertices))
        holder = types.SimpleNamespace(states=torch.as_tensor(init, device=DEVICE))
        bs.perturb_states(holder, seed)
        adj[f"f32_ulp{seed}"] = value_grad(sim, DEVICE, torch.float32, holder.states)
    m3r, kwr = mc.adjoint_problem(reverse=True)
    adj["f32_reversed"] = value_grad(build_diff_simulator(m3r, device=DEVICE, **kwr), DEVICE, torch.float32)
    laps("(d) adjoint references")

    world2.join()
    laps("world 2 (gloo) joined")
    _spawn_world(1, "nccl", target.cpu().numpy(), runs)  # alone on the card: its ms/s is a reading
    laps("world 1 (nccl)")
    for world, backend in SHARD_WORLDS:
        if isinstance(runs[world], Exception):
            raise runs[world]
        r = runs[world]
        print(f"{tag} world {world} ({backend}): spawn {r.pop('spawn_s'):.1f} s; parts (s) "
              + ", ".join(f"{k} {v['seconds']:.1f}" for k, v in r.items()), flush=True)
    # (c)'s reference: phase 20 (c)'s float64 run and float32 witnesses on the CPU
    if ref_proc is not None:
        _, err = ref_proc.communicate(timeout=900)
        require(ref_proc.returncode == 0, f"the bidomain reference ran on the CPU: {err[-2000:]}")
    with np.load(BIDOMAIN_REF_NPZ) as f:
        ref = {k: f[k] for k in f.files}

    for world, backend in SHARD_WORLDS:
        r = runs[world]
        w = f"{tag} world {world} ({backend})"
        # (a) the main path
        a = r["main"]
        la = a["launches"]
        dev_jax = max(abs(x - y) for x, y in zip(a["at"], JAX_STRANG_DX01))
        dev_fused = max(abs(x - y) for x, y in zip(a["at"], main["at"]))
        if world > 1:
            w += " [beside the references: a check, not a speed figure]"
        print(f"{w} (a) dx=0.1 main path, n={a['n']} (n_local {a['n_local']}, halo {a['halo']}): P1-P9 "
              + " ".join(f"{x:.2f}" for x in a["at"]) + f"; max|P - P_jax| {dev_jax:.3f}, max|P - P_fused| "
              f"{dev_fused:.3f}; ms_per_s={a['ms_per_s']:.3f} (fused {main['ms_per_s']:.3f}), CG a step "
              f"{a['cg_per_step']:.3f} (fused {main['cg_mean']:.3f}), a CG iteration {a['exchanges_per_cg']:.3f} "
              f"exchanges and {a['all_reduces_per_cg']:.3f} all-reduces, halo {a['halo_bytes_per_step']:.0f} B a "
              f"step, host syncs a step {a['host_syncs_per_step']:.3f}, setup {a['setup_s']:.1f} s; launches "
              + json.dumps(la))
        require(a["finite"], f"every state finite (world {world})")
        require(dev_jax <= DT + 1e-6 and dev_fused <= DT + 1e-6,
                f"sharded P1-P9 within one dt of JAX's Strang row and phase 6's (world {world})")
        cg_total = round(a["cg_per_step"] * a["steps"])
        require(la["tp06_grl_step_v"] == 2 * a["steps"], "B1 twice a Strang step")
        require(la["cg_update"] == cg_total, "B3 once a CG iteration")
        require(la["axpy"] > 0 and la["stencil_spmv"] > 0, "B4 and B5 launched")
        require(la["stencil_spmv_sym"] == la["stencil_spmv_sym_dir_dot"] == la["csr_spmv"] == 0,
                "the sharded slab runs B5, not B2, B2·B4 or B8")
        # (b) the LV
        b = r["lv"]
        lb = b["launches"]
        p_s, p_f = _lv_probes(lv_V, b["act"]), _lv_probes(lv_V, lv_act)
        both = (b["act"] >= 0) & (lv_act >= 0)
        share_s, share_f = float((b["act"] >= 0).mean()), float((lv_act >= 0).mean())
        gap = float(np.abs(b["act"][both] - lv_act[both]).max()) if both.any() else 0.0
        print(f"{w} (b) psize {LV_PSIZE} LV, n={b['n']} (n_local {b['n_local']}, halo {b['halo']}, apex tail "
              f"{b['tail']}), {SHARD_LV_T:g} ms: probes " + ", ".join(
                  f"{k}={p_s[k]:.2f} (fused {p_f[k]:.2f})" for k in p_s) + f"; activated share {share_s:.4f} "
              f"(fused {share_f:.4f}); largest gap at nodes both fired {gap:.3f} ms; ms_per_s={b['ms_per_s']:.3f}, "
              f"CG a step {b['cg_per_step']:.3f}, a CG iteration {b['exchanges_per_cg']:.3f} exchanges and "
              f"{b['all_reduces_per_cg']:.3f} all-reduces, setup {b['setup_s']:.1f} s; launches " + json.dumps(lb))
        require(b["finite"] and b["tail"], f"the sharded LV finite, its apex tail partitioned (world {world})")
        for k in p_s:
            fired = p_s[k] >= 0, p_f[k] >= 0
            require(fired[0] == fired[1] and (not fired[0] or abs(p_s[k] - p_f[k]) <= DT + 1e-6),
                    f"LV probe {k} within one dt of the fused run (world {world})")
        require(abs(share_s - share_f) <= 0.005, "the LV's activated share within 0.5 points")
        require(lb["tp06_grl_step_v"] > 0 and lb["csr_spmv"] > 0 and lb["cg_update"] > 0 and lb["axpy"] > 0,
                "the sharded LV launches B1, B8, B3 and B4")
        # (c) the bidomain, held as phase 20 (c) holds the single-device AMG run
        c = r["bidomain"]
        for f in ("v", "u_e"):
            f64 = ref[f"monolithic/f64/{f}"]
            noise = max(float(np.abs(ref[f"monolithic/{k}/{f}"] - f64).max()) for k in ("f32_amg", "f32_amg_ulp"))
            d = float(np.abs(c[f] - f64).max())
            d_card, d_pair = float(np.abs(bi[f] - f64).max()), float(np.abs(c[f] - bi[f]).max())
            print(f"{w} (c) bidomain LV psize {LV_CHECK_PSIZE} on {c['amg']} AMG, {bs.REFERENCE_T:g} ms: {f} "
                  f"{d:.3e} from the CPU's float64 run ({d / noise:.2f}x the gap of the CPU's float32 AMG runs, "
                  f"from the same states and one ulp away, {noise:.3e}); the single-device card run {d_card:.3e} "
                  f"({d_card / noise:.2f}x), the two runs {d_pair:.3e} apart")
            require(d <= 3 * noise, f"the sharded bidomain's {f} within 3x float32's AMG gap to float64 "
                                    f"(world {world})")
        print(f"{w} (c) ms_per_s={c['ms_per_s']:.3f}, CG a step {c['cg_per_step']:.3f}, {c['exchanges']} exchanges "
              f"and {c['all_reduces']} all-reduces; launches " + json.dumps(c["launches"]))
        require(c["launches"]["csr_spmv"] > 0 and c["launches"]["tp06_grl_step_v"] > 0,
                "the sharded bidomain launches B8 and B1")
        # (d) the adjoint, against the float64 run: the value and each component of dL/dg
        # within 3x the float32 witnesses' largest gap in it
        d = r["adjoint"]
        v0, g0 = adj["f64"]
        wit = [k for k in adj if k != "f64"]
        nv = max(abs(adj[k][0] - v0) for k in wit)
        ng = np.max([np.abs(adj[k][1] - g0) for k in wit], axis=0)
        dv, dg = abs(d["value"] - v0), np.abs(d["dg"] - g0)
        print(f"{w} (d) adjoint slab n={d['n']}, FHN FE, 16 steps: value {d['value']:.6e} (float64 {v0:.6e}: "
              f"{dv:.3e}, {dv / nv:.2f}x the float32 witnesses' {nv:.3e}); dL/dg " + "; ".join(
                  f"[{i}] {d['dg'][i]:.6e} (float64 {g0[i]:.6e}: {dg[i]:.3e}, {dg[i] / ng[i]:.2f}x their "
                  f"{ng[i]:.3e})" for i in range(len(g0))) + "; witnesses " + ", ".join(
                  f"{k} {adj[k][0]:.6e} / " + " ".join(f"{x:.6e}" for x in adj[k][1]) for k in wit)
              + f"; forward {d['forward_s']:.2f} s, backward {d['backward_s']:.2f} s, {d['exchanges']} exchanges, "
              f"{d['all_reduces']} all-reduces")
        require(bool(np.all(3 * ng < np.abs(g0))), "float32 resolves each component of dL/dg (its witnesses' "
                                                   "gap under a third of it)")
        require(dv <= 3 * nv and bool(np.all(dg <= 3 * ng)),
                f"the sharded adjoint's value and each component of dL/dg within 3x the float32 witnesses' gap "
                f"to float64 (world {world})")
        print(f"{w} census row (dx=0.5 slab, 10 mm a rank, 100 steps): " + json.dumps(r["census"]))


# Phase 22, the command line: ``python -m fenicsx_beat_tpu_torch`` in
# processes of its own on the psize 0.1 LV written as a binary Gmsh 4.1 file
# with its endocardial cells tagged, and on the Niederer slab at the command
# line's default dx=0.5
CLI_T, CLI_SAVE_FREQ = 10.0, 20  # run --mesh: 10 ms at dt 0.05, a snapshot every ms (10 ECG frames)
CLI_ENDO_TAG, CLI_WALL_TAG = 1, 2  # cells with a vertex on the ENDO facets, and the rest
# run --mesh's stimulus on the endocardial cells: 100 times the command
# line's default, since its solver keeps the JAX package's C_m of 1 uF/mm^2
# (the demos' value, 100 times the Niederer slab's), so the stimulated
# shell of one element depolarizes past threshold within the 2 ms window
CLI_AMPLITUDE = 5_000_000.0


def write_msh41_binary(path, coords, cells, cell_tags) -> Path:
    """A tetrahedral mesh as a binary Gmsh 4.1 file (little-endian, size_t
    of 8 bytes, the published layout ``io.read_msh`` parses): one volume
    entity per tag value, whose physical tag is that value; the nodes in
    one block in their order (tags 1..n); the cells in a block for each run
    of equal tags, in their order, so the file reads back to the arrays
    written.  A helper of this script and of the tests: the package reads
    Gmsh files and writes none, as the JAX package."""
    import numpy as np

    coords = np.ascontiguousarray(coords, dtype="<f8")
    cells, tags = np.asarray(cells, dtype=np.int64), np.asarray(cell_tags, dtype=np.int64)
    n, nc = coords.shape[0], cells.shape[0]
    vals = sorted(int(v) for v in np.unique(tags))
    ent = {v: k + 1 for k, v in enumerate(vals)}

    def sz(*v):
        return np.asarray(v, dtype="<u8").tobytes()

    def i4(*v):
        return np.asarray(v, dtype="<i4").tobytes()

    bbox = np.r_[coords.min(axis=0), coords.max(axis=0)].astype("<f8").tobytes()
    out = [b"$MeshFormat\n4.1 1 8\n", i4(1), b"\n$EndMeshFormat\n$Entities\n", sz(0, 0, 0, len(vals))]
    for v in vals:  # tag, bounding box, one physical tag, no bounding surfaces
        out += [i4(ent[v]), bbox, sz(1), i4(v), sz(0)]
    out += [b"\n$EndEntities\n$Nodes\n", sz(1, n, 1, n), i4(3, 1, 0), sz(n),
            np.arange(1, n + 1, dtype="<u8").tobytes(), coords.tobytes(), b"\n$EndNodes\n$Elements\n"]
    starts = np.flatnonzero(np.r_[True, tags[1:] != tags[:-1]])
    ends = np.r_[starts[1:], nc]
    out.append(sz(len(starts), nc, 1, nc))
    for a, b in zip(starts, ends):
        rec = np.empty((b - a, 5), dtype="<u8")
        rec[:, 0] = np.arange(a + 1, b + 1)
        rec[:, 1:] = cells[a:b] + 1
        out += [i4(3, ent[int(tags[a])], 4), sz(b - a), rec.tobytes()]
    out.append(b"\n$EndElements\n")
    path = Path(path)
    path.write_bytes(b"".join(out))
    return path


def cli_start(*args) -> subprocess.Popen:
    """``python -m fenicsx_beat_tpu_torch *args`` from the checkout's root."""
    return subprocess.Popen([sys.executable, "-m", "fenicsx_beat_tpu_torch", *map(str, args)], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_wait(proc: subprocess.Popen, timeout: float = 600) -> tuple[str, dict, float]:
    """(stdout, kernel launches, wall seconds) of a command-line process;
    raises with its output when it fails."""
    tic = time.perf_counter()
    out, err = proc.communicate(timeout=timeout)
    wall = time.perf_counter() - tic
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(proc.args[1:])} exited {proc.returncode}:\n{out}\n{err[-4000:]}")
    launches = {}
    for line in out.splitlines():
        if line.startswith("kernel launches: "):
            launches = json.loads(line[len("kernel launches: "):])
    return out, launches, wall


def cli_line(out: str, head: str) -> str:
    """The first line of ``out`` that starts with ``head``."""
    return next(line for line in out.splitlines() if line.startswith(head))


def vtu_array(path: Path, name: str, dtype) -> "np.ndarray":
    """A binary DataArray of a VTU file, decoded (its 4-byte size, then the data)."""
    import base64
    import xml.etree.ElementTree as ET

    import numpy as np

    for el in ET.parse(path).getroot().iter("DataArray"):
        if el.get("Name") == name:
            raw = base64.b64decode(el.text)
            require(int(np.frombuffer(raw[:4], "<u4")[0]) == len(raw) - 4, f"{name}'s size header")
            return np.frombuffer(raw[4:], dtype)
    raise KeyError(name)


def phase_cli() -> None:
    """Phase 22: the command line through its real entry point.  The psize
    0.1 LV as a binary Gmsh 4.1 file (its cells with a vertex on the ENDO
    facets tagged 1, the rest 2), read back exactly; ``run --mesh`` (TP06,
    B1 and B8) against the same solver built here from the arrays read,
    bit for bit; ``ecg`` (B8) and ``post`` on its checkpoint; ``run`` on the
    slab at dx=0.5 against ``run_niederer_benchmark``; one VTU frame of the
    LV read back."""
    import numpy as np
    import torch

    from fenicsx_beat_tpu_torch import io as tio
    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark
    from fenicsx_beat_tpu_torch.cli import build_mesh_solver
    from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.empty_cache()
    lap = Laps("[cli time]")
    slab_proc = cli_start("run", "--outdir", work / "slab", "--device", DEVICE)  # the defaults: dx 0.5, dt 0.05, 20 ms, TP06
    geo = get_lv_ellipsoid_geometry(psize_ref=LV_PSIZE, cache=False)
    mesh = geo.mesh
    endo_verts = np.unique(mesh.entities(2)[geo.ffun.find(geo.markers["ENDO"][0])])
    tags = np.where(np.isin(mesh.cells, endo_verts).any(axis=1), CLI_ENDO_TAG, CLI_WALL_TAG)
    lap("LV geometry")
    tic = time.perf_counter()
    msh = write_msh41_binary(work / "lv.msh", mesh.coords, mesh.cells, tags)
    write_s = time.perf_counter() - tic
    tic = time.perf_counter()
    m2, ct, ft = tio.read_msh(msh)
    read_s = time.perf_counter() - tic
    require(np.array_equal(m2.coords, mesh.coords) and np.array_equal(m2.cells, mesh.cells), "read_msh's arrays")
    require(ct is not None and np.array_equal(ct.indices, np.arange(mesh.num_cells))
            and np.array_equal(ct.values, tags) and ft is None, "read_msh's cell tags")
    print(f"[cli] psize {LV_PSIZE} LV: {mesh.num_vertices} nodes, {mesh.num_cells} tets, {int((tags == 1).sum())} "
          f"tagged {CLI_ENDO_TAG} (endocardial): binary Gmsh 4.1 {msh.stat().st_size / 2**20:.1f} MiB written in "
          f"{write_s:.2f} s, read back equal in {read_s:.2f} s ({card()})")
    lap("msh write and read")

    run_dir = work / "run"
    out, run_launches, run_wall = cli_wait(cli_start("run", "--mesh", msh, "-T", CLI_T, "--dt", DT, "--save-freq",
                                                     CLI_SAVE_FREQ, "--stim-marker", CLI_ENDO_TAG,
                                                     "--stim-amplitude", CLI_AMPLITUDE, "--outdir", run_dir,
                                                     "--device", DEVICE))
    n_act = int(cli_line(out, "nodes activated: ").split()[2].split("/")[0])
    print(f"[cli] run --mesh: {cli_line(out, 'nodes activated')}; {cli_line(out, 'seconds')}; the process "
          f"{run_wall:.1f} s; launches {json.dumps(run_launches)}")
    for name in ("tp06_grl_step_v", "csr_spmv"):
        require(run_launches.get(name, 0) > 0, f"{name} launched by run --mesh")
    lap("run --mesh")
    # the same solver here, from the arrays read_msh gave
    tic = time.perf_counter()
    solver = build_mesh_solver(m2, ct, tp06, stim_marker=CLI_ENDO_TAG, stim_amplitude=CLI_AMPLITUDE, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - tic
    n = solver.V.ndofs
    snaps = []
    tic = time.perf_counter()
    solver.solve((0.0, CLI_T), dt=DT, save_freq=CLI_SAVE_FREQ,
                 save_callback=lambda t, v: snaps.append(np.asarray(v[:n], dtype=np.float32)))
    run_s = time.perf_counter() - tic
    act = solver.activation_times()[:n]
    data = tio.load_checkpoint(run_dir / "voltage")
    require(np.array_equal(np.load(run_dir / "activation_times.npy"), act),
            "run --mesh's activation times equal the in-process solver's bit for bit")
    require(np.array_equal(data.values, np.stack(snaps)), "run --mesh's snapshots equal the in-process solver's")
    require(bool(torch.isfinite(solver.states).all()), "every state of the LV run finite")
    require(bool((act[endo_verts] >= 0).all()), "every endocardial node fired")
    require(int((act >= 0).sum()) == n_act, "run --mesh's count of activated nodes")
    print(f"[cli] in-process: setup {setup_s:.2f} s, {CLI_T:g} ms in {run_s:.2f} s ({CLI_T / run_s:.2f} ms/s); "
          f"activation times and {len(snaps)} snapshots equal bit for bit; {n_act} of {n} nodes fired "
          f"(all {endo_verts.size} endocardial), range [{act[act >= 0].min():.2f}, {act.max():.2f}] ms")
    del solver
    torch.cuda.empty_cache()
    lap("in-process LV")

    ckpt = run_dir / "voltage.npz"
    post_proc = cli_start("post", ckpt)
    out, ecg_launches, ecg_wall = cli_wait(cli_start("ecg", ckpt, "--device", DEVICE))
    ecg = cli_line(out, "ecg: ")
    traces = np.load(run_dir / "voltage_ecg.npz")["traces"]
    require(traces.shape == (len(data.times), 1) and bool(np.isfinite(traces).all()), "finite ECG traces")
    require(" kernel B8 " in ecg and ecg_launches.get("csr_spmv", 0) > 0, "the ECG on B8")
    print(f"[cli] ecg: {ecg}; {len(data.times)} frames, traces [{traces.min():.4e}, {traces.max():.4e}]; the "
          f"process {ecg_wall:.1f} s; launches {json.dumps(ecg_launches)}")
    out, _, _ = cli_wait(post_proc)
    post_n = int(cli_line(out, "activated nodes: ").split()[2].split("/")[0])
    require(post_n == n_act, f"post counts {post_n} activated nodes, run --mesh {n_act}")
    print(f"[cli] post: {cli_line(out, 'activated nodes')}")
    lap("ecg and post")

    tic = time.perf_counter()
    vtu = tio.VTUWriter(work / "vtu", m2)
    vtu.write(float(data.times[-1]), data.values[-1])
    vtu.close()
    vtu_s = time.perf_counter() - tic
    frame = work / "vtu" / "frame_000000.vtu"
    require(np.array_equal(vtu_array(frame, "v", "<f4"), data.values[-1]), "the VTU frame's v read back")
    require(np.array_equal(vtu_array(frame, "connectivity", "<i4"), m2.cells.ravel()), "the VTU frame's cells")
    print(f"[cli] VTU frame of the LV: {frame.stat().st_size / 2**20:.1f} MiB in {vtu_s:.2f} s, read back equal")
    lap("VTU")

    out, slab_launches, _ = cli_wait(slab_proc)
    got = json.loads((work / "slab" / "activation_times.json").read_text())[-1]
    res = run_niederer_benchmark(dx=0.5, dt=DT, T=20.0, model=tp06, device=DEVICE)
    require(all(got[k] == v for k, v in res.activation_times.items()),
            "run on the slab equals run_niederer_benchmark")
    require_structured_pcg(slab_launches, "run on the slab")
    print(f"[cli] run (slab dx=0.5): {' '.join(out.split())[:200]}; P1-P9 equal to run_niederer_benchmark's; "
          f"launches {json.dumps(slab_launches)}")
    lap("run on the slab")
    print(f"[cli] phase 22 by part (s): msh write {write_s:.2f}, read {read_s:.2f}; "
          + "; ".join(f"{k} {v:.1f}" for k, v in lap.laps) + f" ({card()})")


def prefetch() -> int:
    """``--prefetch``: the cold assemblies of the two largest pairs no
    earlier phase holds, the dx=0.05 ECG slab's (phase 8, 3,449,001 nodes,
    as ``ECGRecovery`` assembles it) and the dx=0.1 bidomain slab's ``|i``
    and ``|e`` (phase 12, as ``BidomainSolver`` does), into the run's
    operator cache, on the host (the card hidden); the smoke run starts it
    after the build and takes its report (each slot's assembly and store
    seconds, the last line) before phase 8.  Host work beside a host-bound
    run: the phases then load the pairs (an input that differed would
    only miss, and the phase assemble its pair itself)."""
    sys.path.insert(0, str(ROOT))
    tic = time.perf_counter()
    ledger = CacheLedger()
    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.benchmarks import bidomain_scale as bs
    from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors
    from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry

    mesh = get_3D_slab_geometry(None, dx=0.05, Lx=20.0, Ly=7.0, Lz=3.0).mesh  # build_ecg_scale's slab
    fem.assemble_mass_stiffness_auto(fem.functionspace(mesh, ("P", 1)), as_cell_tensors(1.0, mesh),
                                     cache_key=CACHE_KEY)
    del mesh
    geo = get_3D_slab_geometry(None, dx=BIDOMAIN_DX, Lx=bs.LX, Ly=bs.LY, Lz=bs.LZ)  # bs.slab_solver's
    V = fem.functionspace(geo.mesh, ("P", 1))
    for tag, M in zip(("|i", "|e"), bs.bidomain_tensors(geo.f0)):
        fem.assemble_mass_stiffness_auto(V, as_cell_tensors(M, geo.mesh), cache_key=CACHE_KEY + tag)
    print(json.dumps({"cold": {str(k): v for k, v in ledger.cold.items()},
                      "stores": {str(k): v for k, v in ledger.stores.items()},
                      "seconds": time.perf_counter() - tic}))
    return 0


def start_background(args: list, threads: int):
    """A host process of this run beside it (``args`` after the
    interpreter), on ``threads`` of the host's cores at a lower priority,
    the card hidden; killed at exit if it still runs."""
    proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, *args], cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": str(threads)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    atexit.register(stop)
    return proc


class Laps:
    """Seconds of each stretch of the run (or of a phase: ``tag``), printed
    as each ends and, at the end, all of them, the longest first."""

    def __init__(self, tag: str = "[time]"):
        self.tag = tag
        self.start = self.last = time.perf_counter()
        self.laps = []

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.laps.append((label, now - self.last))
        print(f"{self.tag} {label}: {now - self.last:.1f} s (at {now - self.start:.1f} s)", flush=True)
        self.last = now

    def summary(self) -> None:
        print("[time] by stretch, longest first: "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(self.laps, key=lambda kv: -kv[1])))


def main() -> int:
    import torch

    if sys.argv[1:] == ["--prefetch"]:  # the host's half of phases 8 and 12 (a process of the run's own)
        return prefetch()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (ROOT / "fenicsx_beat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    tic = time.perf_counter()
    # the operator disk cache in a directory of this run's own, empty at
    # its start, so the first assembly of each pair is a real one
    cache_home = ROOT / "build" / "chip_smoke_cache"
    shutil.rmtree(cache_home, ignore_errors=True)
    os.environ["XDG_CACHE_HOME"] = str(cache_home)
    ledger = CacheLedger()
    lap = Laps()
    device = phase_device()
    phase_build()
    lap("1-2 device and build")
    if sys.argv[1:] == ["--phase", "20"]:  # phase 20 alone (it needs phase 7's steady states), no result line
        ref_proc = bidomain_reference()
        phase_amg_biv(phase_steady_states()[0], ref_proc)
        print(f"[done] {time.perf_counter() - tic:.1f} s (phase 20 alone)")
        return 0
    if sys.argv[1:] == ["--phase", "22"]:  # phase 22 alone (the command line), no result line
        phase_cli()
        print(f"[done] {time.perf_counter() - tic:.1f} s (phase 22 alone)")
        return 0
    if sys.argv[1:] == ["--phase", "23"]:  # phase 23 alone (with its own fused main path), no result line
        phase_sharded(None, bidomain_reference())
        print(f"[done] {time.perf_counter() - tic:.1f} s (phase 23 alone)")
        return 0
    if sys.argv[1:] == ["--phase", "21"]:  # phase 21 alone (with the main path and Path M's setup), no result line
        _, main = phase_main_path()
        mixed, _ = phase_mixed_setup()
        cache_summary(ledger, phase_fused_scope(main, mixed, ledger)[2])
        print(f"[done] {time.perf_counter() - tic:.1f} s (phase 21 alone)")
        return 0
    # host work beside the run, each a process of its own: phases 8 and
    # 12's cold assemblies, phase 19 (d)'s and phase 20 (c)'s CPU references
    prefetch_proc = start_background([str(Path(__file__).resolve()), "--prefetch"], 1)
    fit_ref_proc, bidomain_ref_proc = fit_reference(), bidomain_reference()
    rows, main_solver = phase_kernels()
    lap("3 kernels (B1-B4)")
    phase_pcg_sequences(main_solver)
    lap("3 PCG sequences")
    del main_solver
    lv_solver, lv_setup = phase_lv_setup()
    lv_markers = lv_solver.ode_markers  # the layers of every full-width LV below
    rows.update(phase_lv_kernels(lv_solver))
    lap("3 LV setup and B7/B8")
    steady, prepace_s, _ = phase_steady_states()
    lap("3 ToR-ORd steady states")
    torord_lv, torord_lv_setup = phase_torord_lv_setup(steady, lv_markers)
    rows.update(phase_torord_kernels(torord_lv))
    lap("3 ToR-ORd LV setup and kernels")
    rows.update(phase_fhn_kernels())
    lap("3 FHN kernels")
    phase_kernel_checks()
    lap("4 kernel checks")
    phase_lv_parity()
    phase_torord_lv_parity()
    lap("5 LV parity")
    launches, main = phase_main_path()
    main_at = main["at"]
    lap("6 main path")
    lv_launches, _ = phase_lv_path(lv_solver, lv_setup)
    for name in ("tp06_grl_multi_step_v", "csr_spmv"):
        launches[name] = lv_launches[name]
        lap("7 LV path (TP06)")
    del lv_solver
    torord_launches, t_end = phase_lv_path(torord_lv, torord_lv_setup + prepace_s, prepace_s)
    launches["torord_grl_multi_step_v"] = torord_launches["torord_grl_multi_step_v"]
    lap("7 LV path (ToR-ORd)")
    launches["torord_grl_step_v"] = phase_slab()["torord_grl_step_v"]
    lap("7 slab demo")
    launches.update(phase_node_paths(torord_lv, t_end))
    lap("7 per-node paths")
    # the OO path (MonodomainModel + the ODE adapters + the splitting solver)
    phase_oo_niederer(main_at)
    lap("18a OO Niederer")
    phase_oo_lv(torord_lv, steady)
    lap("18b OO LV")
    del torord_lv
    phase_oo_kernel_check(steady)
    phase_oo_row_aliasing()
    lap("18c-d OO checks")
    phase_spaces(main_at)  # the OO path on P2 and with the ODE at quadrature points
    lap("18e spaces")
    phase_spaces_dx05()
    lap("18e spaces dx=0.5")
    # ToR-ORd dynCl + Land: pre-pacing (its B1's path), its kernels, the
    # psize 0.3 parity, Path L (B7, B8) and its layers as a per-node field
    land_steady, land_prepace_s, launches["torord_land_grl_step_v"] = phase_steady_states("torord_dyncl_land")
    lap("16 Land steady states")
    land_lv, land_lv_setup = phase_torord_lv_setup(land_steady, lv_markers, "torord_dyncl_land")
    rows.update(phase_torord_kernels(land_lv, seed=4, model="torord_dyncl_land", n_b1=N_MAIN))
    lap("16 Land LV setup and kernels")
    phase_torord_lv_parity("torord_dyncl_land")
    lap("16 Land LV parity")
    land_launches, t_end = phase_lv_path(land_lv, land_lv_setup + land_prepace_s, land_prepace_s)
    launches["torord_land_grl_multi_step_v"] = land_launches["torord_land_grl_multi_step_v"]
    launches.update(lv_node_path(land_lv, t_end))
    lap("16 Path L")
    del land_lv
    # Path M: B7's mixed form against its twin, the dx=0.1 run, the dx=0.5 parity
    mixed, mixed_setup = phase_mixed_setup()
    rows.update(phase_mixed_kernels(mixed))
    lap("17 Path M setup and kernels")
    launches.update(phase_mixed_path(mixed, mixed_setup))
    lap("17 Path M")
    # phase 21: merged Strang, a general stimulus, Path M's marker on a
    # field, forward Euler's nine kernels, the operator cache
    fe_rows, fe_launches, phase21_s = phase_fused_scope(main, mixed, ledger)
    rows.update(fe_rows)
    launches.update(fe_launches)
    lap("21 fused scope")
    del mixed
    phase_mixed_dx05()
    lap("17 Path M dx=0.5")
    pre = ledger.adopt(prefetch_proc)
    print(f"[prefetch] the dx=0.05 ECG pair and the dx=0.1 bidomain pairs, assembled and stored on the host beside "
          f"the run in {pre['seconds']:.1f} s: " + ", ".join(
              f"{Path(k).name} {v:.1f} s (store {pre['stores'].get(k, 0.0):.1f} s)" for k, v in pre["cold"].items()))
    lap("prefetch taken")
    ecg_main, ecg_scale = phase_ecg_setup()
    rows.update(phase_stencil_kernels(ecg_main, ecg_scale))
    lap("8-9 ECG setup, B5/B6")
    del ecg_main
    launches["stencil_spmv"] = phase_ecg_main()["stencil_spmv"]
    lap("10 ECG 1")
    launches["stencil_spmv_window"] = phase_ecg_scale(ecg_scale)["stencil_spmv_window"]
    lap("11 ECG 2")
    del ecg_scale
    phase_bidomain_slab()
    lap("12 bidomain slab")
    phase_bidomain_references()
    lap("13 bidomain references")
    demo_launches, demo_rows = phase_bidomain_demo()
    launches.update(demo_launches)
    lap("14 bidomain demo")
    ode = phase_ode_build()
    rows.update(phase_ode_kernels(ode))
    lap("15 ODE build and kernels")
    phase_ode_vs_fhn(ode)
    launches.update(phase_ode_paths(ode))
    lap("15 ODE vs FHN, paths")
    launches.update(phase_ode_main(ode))  # the generated inline FHN's GRL B1: the custom-ODE path's count
    lap("15 ODE main")
    phase_ode_demo(ode)
    launches.update(phase_ode_bidomain(ode, demo_rows))  # its FE B1: the bidomain demo's count
    lap("15 ODE demo, bidomain")
    # phase 19: the differentiable solver (B8's combination, forward and backward)
    adj_rows, adj_launches = phase_adjoint(fit_ref_proc)
    rows.update(adj_rows)
    launches.update(adj_launches)
    lap("19 adjoint")
    # phase 20: SA-AMG on the card (the BiV's Laplace solves, the bidomain's u
    # block) and the BiV demo at full width, through B8 and ToR-ORd's B1
    phase_amg_biv(steady, bidomain_ref_proc)
    lap("20 AMG, BiV")
    # phase 23: the sharded solvers at world 1 (NCCL) and 2 (gloo on the one card)
    phase_sharded(main)
    lap("23 sharded")
    # phase 22: the command line (run --mesh on the LV from a Gmsh file, ecg, post, run on the slab, a VTU frame)
    phase_cli()
    lap("22 command line")

    cache_summary(ledger, phase21_s)
    lap.summary()
    kernels = []
    for name, r in rows.items():
        source, replaces = SOURCES[name] if name in SOURCES else ode_source(name)
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
