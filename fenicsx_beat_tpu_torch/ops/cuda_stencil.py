"""B5 and B6: the general fixed-offset stencil SpMV, with the fused ⟨x, Ax⟩.

Counterparts of ``fenicsx_beat_tpu/ops/pallas_spmv.py``:
``build_pallas_stencil_spmv`` (B5) and ``build_pallas_stencil_spmv_streamed``
(B6, the same function for operands over the TPU's 8 MiB VMEM budget).
The operator is given by its K offsets and their value columns ``vals``
``[K, n]`` (:func:`~.sparse.pack_values`, row k holds ``offsets[k]``):
``y[r] = sum_k vals[k, r] x[r + offsets[k]]``, columns outside [0, n)
contributing 0.

On a CUDA tensor the wrappers launch the hand-written kernels
``csrc/stencil_spmv.cu`` (:func:`stencil_spmv`, :func:`stencil_spmv_dot`)
and ``csrc/stencil_spmv_window.cu`` (:func:`stencil_spmv_window`,
:func:`stencil_spmv_window_dot`); each kernel counts its launches, the
plain form and the dot alike, on ``stencil_spmv.launches`` or
``stencil_spmv_window.launches``.  On a CPU tensor they run the plain
PyTorch twin of the function, which B5 and B6 share; any other device
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._build import check, load_library, num_blocks, require_cuda_f32, stream_ptr
from .sparse import offset_clusters

__all__ = [
    "MAX_OFFSETS",
    "WINDOW_TILE",
    "stencil_spmv",
    "stencil_spmv_dot",
    "stencil_spmv_twin",
    "stencil_spmv_dot_twin",
    "stencil_spmv_window",
    "stencil_spmv_window_dot",
]

MAX_OFFSETS = 64  # kMaxOffsets in csrc/stencil_spmv.cu and csrc/stencil_spmv_window.cu
WINDOW_TILE = 1024  # kTile in csrc/stencil_spmv_window.cu: rows per block
_MAX_WINDOW_BYTES = 232448 - 1024  # kMaxWindowBytes in csrc/stencil_spmv_window.cu


def _check_offsets(vals: torch.Tensor, x: torch.Tensor, offsets) -> None:
    k, n = len(offsets), x.shape[0]
    if x.dim() != 1 or vals.shape != (k, n):
        raise ValueError(f"vals {tuple(vals.shape)} and x {tuple(x.shape)} do not match ({k}, n)")
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {k}")


# ---------------------------------------------------------------------------
# plain PyTorch twins


def stencil_spmv_twin(vals: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """Plain PyTorch twin of B5: zero-padded shifts, K multiply-adds in
    offset order."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k, d in enumerate(offsets):
        v = vals[k]
        if d == 0:
            y = y + v * x
        elif abs(d) >= n:
            continue
        elif d > 0:
            y[: n - d] = y[: n - d] + v[: n - d] * x[d:]
        else:
            y[-d:] = y[-d:] + v[-d:] * x[: n + d]
    return y


def stencil_spmv_dot_twin(vals: torch.Tensor, x: torch.Tensor, offsets):
    y = stencil_spmv_twin(vals, x, offsets)
    return y, torch.dot(x, y)


# ---------------------------------------------------------------------------
# kernels


def _dot_buffers(x: torch.Tensor, parts: int, with_dot: bool):
    if not with_dot:
        return None, None
    partials = torch.empty(parts, dtype=torch.float64, device=x.device)
    return partials, torch.empty((), dtype=torch.float32, device=x.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=64)
def _offset_array(offsets: tuple[int, ...]) -> np.ndarray:
    return np.ascontiguousarray(offsets, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _window_table(offsets: tuple[int, ...]) -> tuple[np.ndarray, ...]:
    """B6's int32 argument arrays for ``offsets``: the offsets, each one's
    cluster, and the clusters' smallest offsets and spans (checked against
    the shared memory a block may take)."""
    cl = offset_clusters(offsets, WINDOW_TILE)
    window_bytes = 4 * sum(WINDOW_TILE + s for s in cl.span)
    if window_bytes > _MAX_WINDOW_BYTES:
        raise ValueError(
            f"the offset clusters' windows take {window_bytes} B of shared memory "
            f"(at most {_MAX_WINDOW_BYTES}): use stencil_spmv"
        )
    return tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (offsets, cl.cluster_of, cl.lo, cl.span))


def _launch(vals: torch.Tensor, x: torch.Tensor, offsets, with_dot: bool):
    require_cuda_f32(vals=vals, x=x)
    _check_offsets(vals, x, offsets)
    n = x.shape[0]
    offs = _offset_array(tuple(offsets))
    y = torch.empty_like(x)
    partials, dot = _dot_buffers(x, num_blocks(n), with_dot)
    err = load_library().lib.stencil_spmv(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, offs.ctypes.data, len(offs),
        _ptr(partials), _ptr(dot), stream_ptr(x),
    )
    check(err, "stencil_spmv")
    stencil_spmv.launches += 1
    return y, dot


def _launch_window(vals: torch.Tensor, x: torch.Tensor, offsets, with_dot: bool):
    require_cuda_f32(vals=vals, x=x)
    _check_offsets(vals, x, offsets)
    n = x.shape[0]
    offs, of, lo, span = _window_table(tuple(offsets))
    y = torch.empty_like(x)
    partials, dot = _dot_buffers(x, -(-n // WINDOW_TILE), with_dot)
    err = load_library().lib.stencil_spmv_window(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, offs.ctypes.data, len(offs),
        of.ctypes.data, lo.ctypes.data, span.ctypes.data, len(lo),
        _ptr(partials), _ptr(dot), stream_ptr(x),
    )
    check(err, "stencil_spmv_window")
    stencil_spmv_window.launches += 1
    return y, dot


def stencil_spmv(vals: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """y = A x for the stencil ``(offsets, vals)`` (B5)."""
    if x.device.type == "cpu":
        return stencil_spmv_twin(vals, x, offsets)
    return _launch(vals, x, offsets, with_dot=False)[0]


def stencil_spmv_dot(vals: torch.Tensor, x: torch.Tensor, offsets):
    """(A x, ⟨x, A x⟩) for the stencil ``(offsets, vals)`` (B5); the dot is
    a 0-d tensor on x's device."""
    if x.device.type == "cpu":
        return stencil_spmv_dot_twin(vals, x, offsets)
    return _launch(vals, x, offsets, with_dot=True)


def stencil_spmv_window(vals: torch.Tensor, x: torch.Tensor, offsets) -> torch.Tensor:
    """y = A x for the stencil ``(offsets, vals)``, operand windows staged
    per block (B6)."""
    if x.device.type == "cpu":
        return stencil_spmv_twin(vals, x, offsets)
    return _launch_window(vals, x, offsets, with_dot=False)[0]


def stencil_spmv_window_dot(vals: torch.Tensor, x: torch.Tensor, offsets):
    """(A x, ⟨x, A x⟩) through B6; the dot is a 0-d tensor on x's device."""
    if x.device.type == "cpu":
        return stencil_spmv_dot_twin(vals, x, offsets)
    return _launch_window(vals, x, offsets, with_dot=True)


stencil_spmv.launches = 0
stencil_spmv_window.launches = 0
