"""B2: symmetric fixed-offset stencil SpMV, with the fused ⟨x, Ax⟩.

Counterpart of ``fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv_sym``.
The operator is given by its ``d >= 0`` offsets ``pos`` and their value
columns ``vals`` ``[Kp, n]`` (:func:`~.sparse.pack_sym_values`); the
sub-diagonal terms come from the shifted products ``(v_d x)[r - d]``.

On a CUDA tensor :func:`stencil_spmv_sym` / :func:`stencil_spmv_sym_dot`
launch the hand-written kernel ``csrc/stencil_spmv_sym.cu`` (one kernel,
the dot optional, counted once per launch on ``stencil_spmv_sym``); on a
CPU tensor they run the plain PyTorch twins.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import check, load_library, num_blocks, require_cuda_f32, stream_ptr

__all__ = [
    "stencil_spmv_sym",
    "stencil_spmv_sym_dot",
    "stencil_spmv_sym_twin",
    "stencil_spmv_sym_dot_twin",
]

MAX_OFFSETS = 8  # kMaxOffsets in csrc/stencil_spmv_sym.cu


def stencil_spmv_sym_twin(vals: torch.Tensor, x: torch.Tensor, pos) -> torch.Tensor:
    """Plain PyTorch twin: ``y[r] = sum_k v_k[r] x[r+d_k] + sum_{d_k>0}
    v_k[r-d_k] x[r-d_k]``, indices outside [0, n) contributing 0."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k, d in enumerate(pos):
        v = vals[k]
        if d == 0:
            y = y + v * x
            continue
        y[: n - d] = y[: n - d] + v[: n - d] * x[d:]
        y[d:] = y[d:] + (v[: n - d] * x[: n - d])
    return y


def stencil_spmv_sym_dot_twin(vals: torch.Tensor, x: torch.Tensor, pos):
    y = stencil_spmv_sym_twin(vals, x, pos)
    return y, torch.dot(x, y)


def _launch(vals: torch.Tensor, x: torch.Tensor, pos, with_dot: bool):
    require_cuda_f32(vals=vals, x=x)
    n = x.shape[0]
    kp = len(pos)
    if vals.shape != (kp, n):
        raise ValueError(f"vals {tuple(vals.shape)} does not match ({kp}, {n})")
    if not 1 <= kp <= MAX_OFFSETS or any(d < 0 for d in pos):
        raise ValueError(f"need 1..{MAX_OFFSETS} non-negative offsets, got {pos}")
    offs = np.ascontiguousarray(pos, dtype=np.int32)
    y = torch.empty_like(x)
    dot = partials = None
    if with_dot:
        partials = torch.empty(num_blocks(n), dtype=torch.float64, device=x.device)
        dot = torch.empty((), dtype=torch.float32, device=x.device)
    err = load_library().lib.stencil_spmv_sym(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, offs.ctypes.data, kp,
        None if partials is None else partials.data_ptr(),
        None if dot is None else dot.data_ptr(),
        stream_ptr(x),
    )
    check(err, "stencil_spmv_sym")
    stencil_spmv_sym.launches += 1
    return y, dot


def stencil_spmv_sym(vals: torch.Tensor, x: torch.Tensor, pos) -> torch.Tensor:
    """y = A x for the symmetric stencil ``(pos, vals)``."""
    if x.device.type == "cpu":
        return stencil_spmv_sym_twin(vals, x, pos)
    return _launch(vals, x, pos, with_dot=False)[0]


def stencil_spmv_sym_dot(vals: torch.Tensor, x: torch.Tensor, pos):
    """(A x, ⟨x, A x⟩) for the symmetric stencil ``(pos, vals)``; the dot
    is a 0-d tensor on x's device."""
    if x.device.type == "cpu":
        return stencil_spmv_sym_dot_twin(vals, x, pos)
    return _launch(vals, x, pos, with_dot=True)


stencil_spmv_sym.launches = 0
