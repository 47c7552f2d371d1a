"""0-D single-cell pacing to steady state (limit cycle), with a hash cache.

Port of ``fenicsx_beat_tpu/single_cell.py`` (itself the counterpart of
the reference's ``src/beat/single_cell.py``): run ``nbeats`` beats of
``BCL`` ms with timestep ``dt`` and cache the final state to ``.npy``
under ``outdir``, keyed by an md5 of the model step's bytecode and the
arguments.  The key is computed as the JAX package computes it, but over
this package's bytecode, so the two packages never share a cache entry.

Where the JAX package compiles the pacing loop into nested ``lax.scan``s,
the loop here launches the model's B1 kernel once per step with one node
(:func:`~.ops.cuda_ode.ionic_model`), on the card unless the caller names
the CPU, where the step is the kernel's plain twin.  The loop never reads
a value back to the host: tracked states are gathered on the device and
copied back once, at the end.  Each beat steps through the times
``np.arange(0.0, BCL, dt)``, as the JAX package does, so the model's
periodic stimulus sees the same ``t`` values; a running float32 sum of
the steps would drift from them.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .config import default_dtype, resolve_device
from .ops.cuda_ode import ionic_model

logger = logging.getLogger(__name__)

__all__ = [
    "compute_hash",
    "solve_with_save",
    "solve_without_save",
    "get_steady_state",
]


def compute_hash(
    fun: Callable,
    init_states: np.ndarray,
    parameters: np.ndarray,
    nbeats: int = 200,
    BCL: float = 1000.0,
    dt: float = 0.05,
) -> str:
    """Cache key: md5 over the step's bytecode and the run arguments (the
    JAX package's ``compute_hash``; its keys differ from these, since the
    bytecode differs)."""
    hash_input = hashlib.md5()
    code = getattr(fun, "__code__", None)
    if code is not None:
        hash_input.update(code.co_code)
    else:
        hash_input.update(repr(fun).encode())
    hash_input.update(str(init_states).encode())
    hash_input.update(str(parameters).encode())
    hash_input.update(str(nbeats).encode())
    hash_input.update(str(BCL).encode())
    hash_input.update(str(dt).encode())
    return hash_input.hexdigest()


def _stepper(fun: Callable, y: torch.Tensor, p) -> Callable:
    """``step(t, dt)``: one B1 step of the ``(S, 1)`` states ``y`` in place,
    V taken from its own row (on the CPU, the kernel's twin)."""
    step = ionic_model(fun).step
    params = np.ascontiguousarray(p, dtype=np.float32 if y.device.type == "cuda" else np.float64)
    v = y[0]
    return lambda t, dt: step(y, v, float(t), dt, params)


def solve_without_save(fun, nbeats, times, y: torch.Tensor, p, dt) -> torch.Tensor:
    """``nbeats`` beats over ``times`` of the ``(S, 1)`` states ``y``, in place
    (the JAX package's host loop)."""
    step = _stepper(fun, y, p)
    for _ in range(nbeats):
        for t in times:
            step(t, dt)
    return y


def solve_with_save(fun, nbeats, times, y: torch.Tensor, p, dt, save_freq, track_values: torch.Tensor,
                    track_indices) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`solve_without_save`, writing the states ``track_indices``
    into row k of ``track_values`` (on ``y``'s device) before every
    ``save_freq``-th step of each beat."""
    step = _stepper(fun, y, p)
    idx = torch.as_tensor(np.asarray(track_indices, dtype=np.int64), device=y.device)
    k = 0
    for _ in range(nbeats):
        for j, t in enumerate(times):
            if j % save_freq == 0:
                track_values[k] = y[idx, 0]
                k += 1
            step(t, dt)
    return y, track_values


def get_steady_state(
    fun: Callable,
    init_states: np.ndarray,
    parameters: np.ndarray,
    outdir: Path,
    nbeats: int = 200,
    BCL: int = 1000,
    save_every_ms: float = 1.0,
    dt: float = 0.05,
    track_indices: list[int] | None = None,
    device=None,
) -> np.ndarray:
    """Pace a single cell to steady state (the JAX package's
    ``get_steady_state``, cache hit included): returns the final states as
    a float64 numpy array.  ``device`` is where the pacing runs, the card
    unless the CPU is named; float32 on the card, float64 on the CPU."""
    outdir = Path(outdir)
    hash_input = compute_hash(
        fun=fun,
        init_states=init_states,
        parameters=parameters,
        nbeats=nbeats,
        BCL=BCL,
        dt=dt,
    )
    fname = outdir / f"steady_states_{hash_input}.npy"
    if fname.is_file():
        return np.load(fname)
    ionic_model(fun)  # raises for a model the port has no kernel for
    dev = resolve_device(device)
    outdir.mkdir(exist_ok=True, parents=True)

    logger.info(f"Computing steady state with {nbeats} beats.")
    times = np.arange(0.0, BCL, dt)
    # a copy: the pacing steps y in place, never the caller's array
    y = torch.tensor(np.asarray(init_states, dtype=np.float64).reshape(-1, 1), dtype=default_dtype(dev), device=dev)

    if track_indices is not None:
        save_freq = int(np.ceil(save_every_ms / dt))
        M = int(np.ceil(len(times) / save_freq) * nbeats)
        track = torch.zeros((M, len(track_indices)), dtype=y.dtype, device=dev)
        y, track = solve_with_save(fun, nbeats, times, y, parameters, dt, save_freq, track, track_indices)
        track_values = track.cpu().double().numpy()
        np.save(outdir / f"tracked_values_{hash_input}.npy", track_values)
        _plot_tracked(outdir, hash_input, track_values, times, save_freq, BCL, nbeats, save_every_ms)
    else:
        y = solve_without_save(fun, nbeats, times, y, parameters, dt)

    out = y[:, 0].cpu().double().numpy()
    np.save(fname, out)
    return out


def _plot_tracked(outdir, hash_input, track_values, times, save_freq, BCL, nbeats, save_every_ms):
    """Diagnostic plots of the tracked states (the JAX package's, reference
    ``single_cell.py:142-151``)."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning("Matplotlib not installed, plotting not available.")
        return
    M, N = track_values.shape
    fig, ax = plt.subplots(N, 2, sharex="col", sharey="row", squeeze=False)
    last = int(np.ceil(BCL / save_every_ms))
    for i in range(N):
        ax[i, 0].plot(np.linspace(0, BCL * nbeats, M), track_values[:, i])
        ax[i, 1].plot(times[::save_freq][-last:], track_values[-last:, i])
    fig.tight_layout()
    fig.savefig(outdir / f"tracked_values_{hash_input}.png")
    plt.close(fig)
