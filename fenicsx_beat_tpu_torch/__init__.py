"""PyTorch/CUDA port of ``fenicsx_beat_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package grows beside it, slice
by slice, and imports neither ``jax`` nor ``fenicsx_beat_tpu``.  Its paths:

- the reference's object-oriented surface: :class:`~.monodomain_model.MonodomainModel`,
  the ODE adapters of :mod:`.odesolver` and
  :class:`~.monodomain_solver.MonodomainSplittingSolver`, with the
  monitors of :mod:`.telemetry` (:mod:`.benchmarks.lv_endocardial`,
  :mod:`.benchmarks.verification`);
- the monodomain splitting solver :class:`~.fused.FusedMonodomainSolver`
  on the Niederer slab (:func:`~.benchmarks.niederer.run_niederer_benchmark`),
  the slab demo (:mod:`.benchmarks.slab`), the idealized left ventricle
  with transmural layers (:mod:`.benchmarks.lv`) and the slab with two
  ionic models side by side (:mod:`.benchmarks.mixed`);
- the bidomain solver :class:`~.bidomain.BidomainSolver`
  (:mod:`.benchmarks.bidomain_scale`), its u block preconditioned by the
  DCT on tensor grids and by SA-AMG elsewhere (:mod:`.ops.amg`);
- the idealized biventricle with transmural layers, random endocardial
  activation and a 12-lead ECG (:mod:`.benchmarks.biv_endocardial`), its
  Laplace solves on SA-AMG, and voltage checkpoints (:mod:`.io`);
- pseudo-ECG recovery (:class:`~.ecg.ECGRecovery`, :class:`~.ecg.Leads12`,
  :mod:`.benchmarks.ecg_scale`);
- ionic models: TP06, ToR-ORd dynCl, ToR-ORd dynCl + Land and
  FitzHugh-Nagumo written by hand, and any gotran ``.ode`` model loaded at
  run time (:func:`~.odefile.load_ode`, :mod:`.benchmarks.custom_ode`);
  markers may mix them.

Hand-written CUDA kernels (``csrc/``) carry these paths, each with a plain
PyTorch twin for the CPU: one for each of the JAX package's eight Pallas
builders (B1-B8) and model (B1, its per-node form and B7 per ionic model),
and three templates (``csrc/ode_*.cu.in``) that a loaded model's generated
node body completes, built by ``nvcc`` at its first step.  Entry points run
on the card unless the caller names the CPU.  Importing the package builds
nothing: the kernels build at their first launch.
"""

from . import (
    base_model,
    conductivities,
    ecg,
    geometry,
    io,
    monodomain_model,
    monodomain_solver,
    odefile,
    odesolver,
    single_cell,
    stimulation,
    telemetry,
    utils,
)
from .ecg import ECGRecovery, Leads12
from .monodomain_model import MonodomainModel
from .monodomain_solver import MonodomainSplittingSolver
from .stimulation import Stimulus
from .telemetry import BaseMonitor, NullMonitor, PerformanceMonitor

__all__ = [
    "monodomain_model",
    "odesolver",
    "base_model",
    "MonodomainModel",
    "monodomain_solver",
    "MonodomainSplittingSolver",
    "utils",
    "conductivities",
    "stimulation",
    "geometry",
    "single_cell",
    "ecg",
    "odefile",
    "Stimulus",
    "ECGRecovery",
    "Leads12",
    "telemetry",
    "BaseMonitor",
    "NullMonitor",
    "PerformanceMonitor",
    "io",
]
