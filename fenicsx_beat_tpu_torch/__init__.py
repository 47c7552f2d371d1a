"""PyTorch/CUDA port of ``fenicsx_beat_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package grows beside it, slice
by slice, and imports neither ``jax`` nor ``fenicsx_beat_tpu``.  Its paths:

- the monodomain splitting solver :class:`~.fused.FusedMonodomainSolver`
  on the Niederer slab (:func:`~.benchmarks.niederer.run_niederer_benchmark`),
  the slab demo (:mod:`.benchmarks.slab`) and the idealized left ventricle
  with transmural layers (:mod:`.benchmarks.lv`);
- the bidomain solver :class:`~.bidomain.BidomainSolver`
  (:mod:`.benchmarks.bidomain_scale`);
- pseudo-ECG recovery (:class:`~.ecg.ECGRecovery`, :class:`~.ecg.Leads12`,
  :mod:`.benchmarks.ecg_scale`);
- ionic models: TP06, ToR-ORd dynCl and FitzHugh-Nagumo written by hand,
  and any gotran ``.ode`` model loaded at run time
  (:func:`~.odefile.load_ode`, :mod:`.benchmarks.custom_ode`).

Hand-written CUDA kernels (``csrc/``) carry these paths, each with a plain
PyTorch twin for the CPU: one for each of the JAX package's eight Pallas
builders (B1-B8) and model (B1, its per-node form and B7 per ionic model),
and three templates (``csrc/ode_*.cu.in``) that a loaded model's generated
node body completes, built by ``nvcc`` at its first step.  Entry points run
on the card unless the caller names the CPU.
"""

from . import ecg, odefile
from .ecg import ECGRecovery, Leads12

__all__ = ["ecg", "odefile", "ECGRecovery", "Leads12"]
