"""PyTorch/CUDA port of ``fenicsx_beat_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package grows beside it, slice
by slice, and imports neither ``jax`` nor ``fenicsx_beat_tpu``.  Two paths
run through :class:`~.fused.FusedMonodomainSolver`: the Niederer slab
(TP06, Strang or Godunov splitting,
:func:`~.benchmarks.niederer.run_niederer_benchmark`) and the idealized
left ventricle with transmural TP06 layers (:mod:`.benchmarks.lv`).
Pseudo-ECG recovery (:class:`~.ecg.ECGRecovery`, :class:`~.ecg.Leads12`,
:mod:`.benchmarks.ecg_scale`) runs on the general stencil SpMV (B5, B6)
or the CSR SpMV (B8).  Eight hand-written CUDA kernels (``csrc/``) carry
these paths, each with a plain PyTorch twin for the CPU.  Entry points run
on the card unless the caller names the CPU.
"""

from . import ecg
from .ecg import ECGRecovery, Leads12

__all__ = ["ecg", "ECGRecovery", "Leads12"]
