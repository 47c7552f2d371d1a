"""PyTorch/CUDA port of ``fenicsx_beat_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package grows beside it, slice
by slice, and imports neither ``jax`` nor ``fenicsx_beat_tpu``.  Two paths
run through :class:`~.fused.FusedMonodomainSolver`: the Niederer slab
(TP06, Strang or Godunov splitting,
:func:`~.benchmarks.niederer.run_niederer_benchmark`) and the idealized
left ventricle with transmural TP06 layers (:mod:`.benchmarks.lv`), on six
hand-written CUDA kernels (``csrc/``) with plain PyTorch twins for the
CPU.  Entry points run on the card unless the caller names the CPU.
"""
