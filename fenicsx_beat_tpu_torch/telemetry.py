"""Observability: section timers, linear-solver stats, device traces.

Port of ``fenicsx_beat_tpu/telemetry.py``: the monitor strategy the PDE,
ODE and splitting solvers are given (``BaseMonitor`` / ``NullMonitor`` /
``PerformanceMonitor``), with the same log line (``PDE step timing
step=``), summary text and JSON schema.  What changes with PyTorch:

* CUDA launches return before the card finishes, so a
  :class:`PerformanceMonitor` synchronizes CUDA when a section closes (JAX
  closes its sections after ``block_until_ready``); :class:`NullMonitor`
  never synchronizes;
* ``record_ksp`` takes the port's CG statistics
  (:class:`~.ops.cg.CGInfo`: ``iterations`` / ``residual_norm`` /
  ``converged``), or any object with those attributes;
* kernel timelines come from ``torch.profiler`` through
  :func:`start_trace` / :func:`stop_trace` / :func:`trace`, written as a
  Chrome trace into the given directory;
* "rank 0" is the ``torch.distributed`` rank when a process group is
  initialized, else 0.
"""

from __future__ import annotations

import abc
import json
import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Tuple, Union

import torch

logger = logging.getLogger(__name__)

__all__ = [
    "BaseMonitor",
    "NullMonitor",
    "PerformanceMonitor",
    "start_trace",
    "stop_trace",
    "trace",
]

# the profiler that start_trace opened: (profiler, trace directory)
_TRACE: list = []


def start_trace(logdir: Union[str, Path]) -> None:
    """Start a ``torch.profiler`` trace (host and, with a card, device
    activity), the kernel-level timeline under the section timings of
    :class:`PerformanceMonitor`; :func:`stop_trace` writes it to
    ``logdir``."""
    if _TRACE:
        raise RuntimeError("a trace is already running; stop_trace() first")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    _TRACE.append((prof, Path(logdir)))


def stop_trace() -> Path:
    """Stop the running trace and write it as ``trace.json`` (Chrome trace
    format, viewable in Perfetto) into its directory; returns the file."""
    if not _TRACE:
        raise RuntimeError("no trace is running; start_trace() first")
    prof, logdir = _TRACE.pop()
    prof.__exit__(None, None, None)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


@contextmanager
def trace(logdir: Union[str, Path]):
    """Context manager around ``start_trace``/``stop_trace``."""
    start_trace(logdir)
    try:
        yield
    finally:
        stop_trace()


def _process_index() -> int:
    """This process's rank when a ``torch.distributed`` group is
    initialized, else 0."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _sync_device() -> None:
    """Wait for the card, if this process has used it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class BaseMonitor(abc.ABC):
    """Interface the solvers program against (the JAX package's, and the
    reference's ``telemetry.py:15-27``)."""

    @abc.abstractmethod
    @contextmanager
    def track_time(self, name: str):
        yield

    @abc.abstractmethod
    def record_ksp(self, info) -> None:
        pass

    @abc.abstractmethod
    def advance_step(self, t0: float, t1: float) -> None:
        pass


class NullMonitor(BaseMonitor):
    """Zero-overhead default: every hook is a no-op, and nothing waits for
    the card."""

    @contextmanager
    def track_time(self, name: str):
        yield

    def record_ksp(self, info) -> None:
        pass

    def advance_step(self, t0: float, t1: float) -> None:
        pass


class PerformanceMonitor(BaseMonitor):
    """Accumulating wall-clock + solver-stats monitor.

    Every ``track_time(name)`` section adds into ``self.timings[name]``
    across the whole run, after waiting for the card's queued work;
    ``record_ksp`` folds per-solve CG stats into running totals;
    ``advance_step`` emits one log line every ``log_frequency`` steps.
    ``display_summary`` / ``save_summary`` render the aggregate (rank 0
    only).
    """

    def __init__(self, log_frequency: int = 1, comm=None):
        self.log_frequency = log_frequency
        self.comm = comm  # accepted for reference signature parity; unused
        self.step_counter = 0
        self.timings: Dict[str, float] = defaultdict(float)

        self.ksp_total_iterations = 0
        self.ksp_max_iterations = 0
        self.ksp_last_iterations = 0
        self.ksp_last_residual_norm = 0.0
        self.ksp_last_converged_reason = 0

    @contextmanager
    def track_time(self, name: str):
        started = time.perf_counter()
        try:
            yield
        finally:
            _sync_device()
            self.timings[name] += time.perf_counter() - started

    def record_ksp(self, info) -> None:
        """Fold one linear solve's stats into the running aggregate.

        ``info`` is duck-typed: any object exposing ``iterations``,
        ``residual_norm`` and ``converged`` works (the port's ``CGInfo``
        does; ``None`` or unrelated objects are ignored).
        """
        iterations = getattr(info, "iterations", None)
        if iterations is None:
            return
        try:
            count = int(iterations)
        except TypeError:
            return
        self.ksp_last_iterations = count
        self.ksp_total_iterations += count
        if count > self.ksp_max_iterations:
            self.ksp_max_iterations = count
        self.ksp_last_residual_norm = float(getattr(info, "residual_norm", 0.0))
        self.ksp_last_converged_reason = int(bool(getattr(info, "converged", False)))

    def advance_step(self, t0: float, t1: float) -> None:
        self.step_counter += 1
        due = self.log_frequency > 0 and self.step_counter % self.log_frequency == 0
        if not due:
            return
        parts = [
            f"PDE step timing step={self.step_counter}",
            f"t=({t0:.5f}, {t1:.5f})",
            f"ksp_iterations={self.ksp_last_iterations}",
            f"ksp_residual_norm={self.ksp_last_residual_norm:.6e}",
            f"ksp_converged_reason={self.ksp_last_converged_reason}",
        ]
        parts.extend(f"{name}={value:.6f}s" for name, value in self.timings.items())
        logger.info(", ".join(parts))

    # -- aggregate rendering -------------------------------------------------

    def _summary_lines(self) -> List[str]:
        rule, half_rule = "=" * 50, "-" * 50
        counters: List[Tuple[str, int]] = [
            ("Total Steps:", self.step_counter),
            ("KSP Total Iterations:", self.ksp_total_iterations),
            ("KSP Max Iterations:", self.ksp_max_iterations),
        ]
        lines = ["\n" + rule, f"{'PERFORMANCE SUMMARY':^50}", rule]
        lines += [f"{label:<23}{value}" for label, value in counters]
        lines += [half_rule, f"{'Metric':<35} | {'Time (s)':>10}", half_rule]
        by_cost = sorted(self.timings.items(), key=lambda kv: kv[1], reverse=True)
        lines += [f"{name:<35} | {seconds:>10.4f}" for name, seconds in by_cost]
        lines.append(rule + "\n")
        return lines

    def display_summary(self) -> None:
        if _process_index() == 0:
            logger.info("\n".join(self._summary_lines()))

    def save_summary(self, filepath: Union[str, Path]) -> None:
        if _process_index() != 0:
            return
        payload = {
            "total_steps": self.step_counter,
            "ksp": {
                "total_iterations": self.ksp_total_iterations,
                "max_iterations": self.ksp_max_iterations,
            },
            "timings": dict(self.timings),
        }
        path = Path(filepath)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(payload, indent=4))
        logger.info(f"Performance summary saved to {path}")
