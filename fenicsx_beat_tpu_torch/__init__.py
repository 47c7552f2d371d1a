"""PyTorch/CUDA port of ``fenicsx_beat_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package grows beside it, slice
by slice, and imports neither ``jax`` nor ``fenicsx_beat_tpu``.  Its first
slice is the fused monodomain main path (Niederer slab, TP06, Strang or
Godunov splitting): :class:`~.fused.FusedMonodomainSolver`, driven through
:func:`~.benchmarks.niederer.run_niederer_benchmark`, on four hand-written
CUDA kernels (``csrc/``) with plain PyTorch twins for the CPU.
"""
