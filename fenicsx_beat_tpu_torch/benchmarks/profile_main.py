"""Where a path's time goes, on a CUDA card.

    python -m fenicsx_beat_tpu_torch.benchmarks.profile_main [--repeats 5] [--config lv]

Builds the Niederer dx=0.1 Strang solver (dt=0.05), or with ``--config
lv`` the psize 0.1 LV of ``benchmarks/lv.py`` (Strang, dt=0.05), and
prints:

1. the card's name and power limit (nvidia-smi);
2. one window of 100 steps from t=20 ms (the wave well under way), run
   twice from the same saved state: first unprofiled, timed on the host
   clock with a device synchronize at each end, then under
   ``torch.profiler``.  Both runs do the same work (their CG iteration
   counts must be equal).  The device's busy time is the union of the
   kernel, copy and memset intervals of the profiled run; the busy share
   is that time over the unprofiled wall of the same window, and also over
   the profiled run's own device span (first device event to last), which
   the profiler's host overhead stretches;
3. the device time of each kernel in that window, largest first;
4. the timed 40 ms horizon (800 steps in chunks of 400, from the initial
   state, one synchronize at the end, as ``run_niederer_benchmark`` times it),
   ``--repeats`` times on the same solver, each with the host's 1-minute
   load average, the share of the machine's CPU time that was busy during
   the run (``/proc/stat``), and this process's CPU time over its wall.

The profiler's trace is written under ``build/profile/`` in the checkout
and deleted after it is read unless ``--keep-trace`` is given.
:func:`device_us_per_call` gives the device time of one call of any
function that launches kernels (:func:`device_events_per_call` also its
device events by name), and :func:`profile_window` where the time
of any window of steps goes, from the same kind of trace.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .lv import build_lv_solver, lv_probe_points
from .niederer import _build_solver, benchmark_points

ROOT = Path(__file__).resolve().parents[2]
DT = 0.05
WINDOW_START_STEPS = 400  # t = 20 ms
WINDOW_STEPS = 100
CHUNK_STEPS = 400
HORIZON_STEPS = 800  # 40 ms
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _cpu_busy_jiffies() -> tuple[int, int]:
    """(busy, total) jiffies of the whole machine from /proc/stat."""
    fields = [int(x) for x in Path("/proc/stat").read_text().splitlines()[0].split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)  # idle + iowait
    return sum(fields) - idle, sum(fields)


def _device_intervals(trace_path: Path) -> list[tuple[float, float, str]]:
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
    ]


def _union_length(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _trace_path(tag: str) -> Path:
    trace_dir = ROOT / "build" / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    return trace_dir / f"{tag}-{os.getpid()}.json"


def device_us_per_call(fn, calls: int = 50, attempts: int = 5) -> float:
    """Device time (us) of one call of ``fn`` (:func:`device_events_per_call`)."""
    return device_events_per_call(fn, calls, attempts)[0]


def device_events_per_call(fn, calls: int = 50, attempts: int = 5) -> tuple[float, dict]:
    """Device time (us) of one call of ``fn`` and its device events (kernel
    launches, copies and memsets) per call by name: the events of ``calls``
    calls under ``torch.profiler`` (after a warm-up), summed, over
    ``calls``.  Unlike a back-to-back wall time it leaves out the host's
    time between launches.  ``fn`` must launch the same device work at
    every call, so every event name must occur a whole number of times per
    call.  A trace that breaks this has lost events (traces have been seen
    to hold only some of the calls, the first ones missing): the profiler
    records the calls in its second step, after a warm-up step of the same
    calls that starts its device tracing; a trace still short is discarded
    and the calls are profiled again, up to ``attempts`` times, then this
    raises."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    counts: Counter = Counter()
    trace = _trace_path("calls")
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(str(trace))) as prof:
            for _ in range(2):  # the warm-up step, then the recorded one
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        iv = _device_intervals(trace)
        trace.unlink()
        counts = Counter(name for _, _, name in iv)
        if counts and all(c % calls == 0 for c in counts.values()):
            if attempt:
                print(f"[profile] {attempt} trace(s) discarded before a whole one")
            return sum(e - s for s, e, _ in iv) / calls, {k: c // calls for k, c in counts.items()}
    raise RuntimeError(
        f"no trace of {attempts} held a whole number of device events per call "
        f"({calls} calls): last counts {dict(counts)}"
    )


def _reset(solver, init) -> None:
    solver.states.copy_(init[0])
    solver.activation_time = init[1].clone()
    torch.cuda.synchronize()


def profile_window(run, reset, tag: str = "window", keep_trace: bool = False) -> dict:
    """Where one window's time goes: ``run()``, which launches the window's
    work and returns its CG iterations, from the state ``reset()``
    restores, once unprofiled (timed on the host clock, a device
    synchronize at each end) and once under ``torch.profiler``.  Both runs
    must do the same work (equal CG iterations).  Returns the CG
    iterations, both walls, the device's busy time (the union of the
    profiled run's kernel, copy and memset intervals), its share of the
    unprofiled wall and of the profiled run's own device span, and each
    kernel's device time, largest first.  The state is left at the
    window's end."""
    from torch.profiler import ProfilerActivity, profile

    reset()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    plain = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - tic) * 1e3

    reset()
    torch.cuda.synchronize()
    trace = _trace_path(tag)
    tic = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = run()
        torch.cuda.synchronize()
    wall_prof_ms = (time.perf_counter() - tic) * 1e3
    if profiled != plain:
        raise RuntimeError(f"the two runs of the window differ: {plain} vs {profiled} CG iterations")
    prof.export_chrome_trace(str(trace))
    iv = _device_intervals(trace)
    if not keep_trace:
        trace.unlink()
    if not iv:
        raise RuntimeError("the profiler recorded no device activity")
    busy_ms = _union_length(iv) / 1e3
    span_ms = (max(e for _, e, _ in iv) - min(s for s, _, _ in iv)) / 1e3
    by_name: dict[str, list[float]] = {}
    for s, e, name in iv:
        by_name.setdefault(name, []).append(e - s)
    kernels = sorted(
        ((sum(d) / 1e3, len(d), name) for name, d in by_name.items()), reverse=True
    )
    return {
        "cg_iters": plain,
        "wall_ms": wall_ms,
        "wall_profiled_ms": wall_prof_ms,
        "device_busy_ms": busy_ms,
        "device_span_profiled_ms": span_ms,
        "busy_share_of_wall": busy_ms / wall_ms,
        "busy_share_of_profiled_span": busy_ms / span_ms,
        "kernels": [
            {"name": name, "ms": ms, "calls": calls, "us_per_call": ms * 1e3 / calls}
            for ms, calls, name in kernels
        ],
        "trace": str(trace.relative_to(ROOT)) if keep_trace else None,
    }


def main_path_window(solver, amps, init, keep_trace: bool) -> dict:
    """:func:`profile_window` of the main path's window: ``WINDOW_STEPS``
    steps from t = 20 ms, and the host syncs of one run of it."""
    t_start = WINDOW_START_STEPS * DT
    _reset(solver, init)
    solver.run_chunk(0.0, DT, WINDOW_START_STEPS, amps, probed=True)
    torch.cuda.synchronize()
    saved = (solver.states.clone(), solver.activation_time.clone())
    solver.host_syncs = 0
    w = profile_window(lambda: solver.run_chunk(t_start, DT, WINDOW_STEPS, amps, probed=True).iters_sum,
                       lambda: _reset(solver, saved), keep_trace=keep_trace)
    # both runs do the same work, so each made half the syncs
    return {"t_start_ms": t_start, "steps": WINDOW_STEPS, "host_syncs": solver.host_syncs // 2, **w}


def time_horizons(solver, amps, init, repeats: int) -> list[dict]:
    """The timed horizon, after one discarded warm-up chunk."""
    _reset(solver, init)
    solver.run_chunk(0.0, DT, CHUNK_STEPS, amps, probed=True)
    runs = []
    for _ in range(repeats):
        _reset(solver, init)
        iters = 0
        busy0, total0 = _cpu_busy_jiffies()
        cpu0, tic = time.process_time(), time.perf_counter()
        t = 0.0
        for _ in range(HORIZON_STEPS // CHUNK_STEPS):
            res = solver.run_chunk(t, DT, CHUNK_STEPS, amps, probed=True)
            iters += res.iters_sum
            t += CHUNK_STEPS * DT
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        cpu = time.process_time() - cpu0
        busy1, total1 = _cpu_busy_jiffies()
        runs.append({
            "wall_s": wall,
            "ms_per_s": HORIZON_STEPS * DT / wall,
            "cg_iters_per_step": iters / HORIZON_STEPS,
            "loadavg_1min": os.getloadavg()[0],
            "machine_cpu_busy_share": (busy1 - busy0) / max(total1 - total0, 1),
            "process_cpu_over_wall": cpu / wall,
        })
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--keep-trace", action="store_true")
    ap.add_argument("--config", choices=("niederer", "lv"), default="niederer")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {os.cpu_count()} host CPUs")
    if args.config == "lv":
        solver = build_lv_solver(
            psize=0.1, theta=0.5, device="cuda", precond="jacobi",
            probe_points=np.array(list(lv_probe_points(0.1).values())),
        )
    else:
        solver = _build_solver(
            dx=0.1, theta=0.5, device="cuda", probe_points=np.array(list(benchmark_points().values()))
        )
    print(f"[config] {args.config}: {solver.V.ndofs} nodes")
    amps = solver.stimulus_amplitudes()
    init = (solver.states.clone(), solver.activation_time.clone())
    horizons = time_horizons(solver, amps, init, args.repeats)
    for i, h in enumerate(horizons):
        print(f"[horizon {i}] " + json.dumps(h))
    w = main_path_window(solver, amps, init, args.keep_trace)
    print(f"[window] t={w['t_start_ms']} ms, {w['steps']} steps, {w['cg_iters']} CG iterations, "
          f"{w['host_syncs']} host syncs: wall {w['wall_ms']:.3f} ms unprofiled, "
          f"{w['wall_profiled_ms']:.3f} ms profiled; device busy {w['device_busy_ms']:.3f} ms = "
          f"{w['busy_share_of_wall']:.4f} of the unprofiled wall, "
          f"{w['busy_share_of_profiled_span']:.4f} of the profiled device span "
          f"({w['device_span_profiled_ms']:.3f} ms)")
    for k in w["kernels"][:20]:
        print(f"[window] {k['ms']:9.4f} ms {k['calls']:6d} calls {k['us_per_call']:8.3f} us/call  {k['name'][:100]}")
    print(json.dumps({"horizons": horizons, "window": w}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
