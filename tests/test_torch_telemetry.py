"""The port's monitors against the JAX package's, driven by the same calls:
the same log lines (``PDE step timing step=``), summary text and JSON
summary; ``NullMonitor`` a no-op that never waits for the card;
``PerformanceMonitor`` waits for the card when a section closes; ``trace``
writes a ``torch.profiler`` trace."""

import json
import logging
import time
from types import SimpleNamespace

import pytest
import torch

from fenicsx_beat_tpu import telemetry as jtel
from fenicsx_beat_tpu_torch import telemetry as ttel


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drive(monitor):
    """The same calls on either package's monitor; returns its summary
    lines with the wall-clock sections replaced by fixed values."""
    with monitor.track_time("dummy_work"):
        time.sleep(0.002)
    monitor.record_ksp(SimpleNamespace(iterations=5, residual_norm=1e-6, converged=True))
    monitor.record_ksp(None)
    monitor.record_ksp(SimpleNamespace(iterations=7, residual_norm=2.5e-7, converged=False))
    monitor.timings.clear()
    monitor.timings["fast_op"] = 0.125
    monitor.timings["slow_op"] = 5.0
    for k in range(4):
        monitor.advance_step(0.1 * k, 0.1 * (k + 1))


def test_log_summary_and_json_match_jax(caplog, tmp_path):
    caplog.set_level(logging.INFO)
    out = {}
    for name, pkg in (("jax", jtel), ("port", ttel)):
        caplog.clear()
        mon = pkg.PerformanceMonitor(log_frequency=2)
        drive(mon)
        mon.display_summary()
        mon.save_summary(tmp_path / name / "summary.json")
        out[name] = ([r.getMessage() for r in caplog.records], mon._summary_lines(),
                     json.loads((tmp_path / name / "summary.json").read_text()))
    logs_j, lines_j, json_j = out["jax"]
    logs_p, lines_p, json_p = out["port"]
    steps = [m for m in logs_p if m.startswith("PDE step timing")]
    assert len(steps) == 2 and "step=2" in steps[0] and "ksp_iterations=7" in steps[0]
    assert "ksp_converged_reason=0" in steps[0] and "slow_op=5.000000s" in steps[0]
    assert [m for m in logs_p if not m.startswith("Performance summary saved")] == \
        [m for m in logs_j if not m.startswith("Performance summary saved")]
    assert lines_p == lines_j
    assert json_p == json_j and json_p["ksp"] == {"total_iterations": 12, "max_iterations": 7}


def test_section_timing_accumulates():
    mon = ttel.PerformanceMonitor()
    for _ in range(2):
        with mon.track_time("dummy_work"):
            time.sleep(0.01)
    assert mon.timings["dummy_work"] >= 0.02


def test_null_monitor_is_a_no_op_and_never_synchronizes(monkeypatch):
    """With a card in use, a PerformanceMonitor section ends in a
    synchronize; a NullMonitor's never does."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(1))
    null = ttel.NullMonitor()
    with null.track_time("x"):
        pass
    null.record_ksp(SimpleNamespace(iterations=3, residual_norm=0.1, converged=True))
    null.advance_step(0.0, 0.1)
    assert calls == [] and not hasattr(null, "timings")
    perf = ttel.PerformanceMonitor()
    with perf.track_time("x"):
        with perf.track_time("y"):
            pass
    assert len(calls) == 2


def test_process_index_without_a_process_group():
    assert ttel._process_index() == 0


def test_trace_writes_a_profiler_trace(tmp_path):
    with ttel.trace(tmp_path / "trace"):
        x = torch.ones(64, dtype=torch.float64)
        (x * 2.0 + 1.0).sum()
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    with pytest.raises(RuntimeError, match="no trace"):
        ttel.stop_trace()


def test_fused_chunks_report_to_the_monitor():
    """The fused solver's ``run_chunk`` runs in the monitor's
    ``fused_chunk`` section and then records the chunk's CG statistics and
    advances one step over the chunk, as the JAX solver's ``solve`` does
    (``run_niederer_benchmark(monitor=...)`` passes it on)."""
    from fenicsx_beat_tpu_torch.benchmarks.niederer import run_niederer_benchmark

    mon = ttel.PerformanceMonitor(log_frequency=0)
    res = run_niederer_benchmark(dx=1.0, dt=0.05, T=1.0, theta=0.5, device="cpu", check_interval_ms=0.5,
                                 monitor=mon)
    assert set(mon.timings) == {"fused_chunk"}
    assert mon.step_counter == 1 + res.n_steps // 10  # the warm-up chunk and the timed ones
    assert mon.ksp_total_iterations > 0 and mon.ksp_last_converged_reason == 1
