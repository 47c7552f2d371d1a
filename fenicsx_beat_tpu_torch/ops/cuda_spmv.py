"""B2: symmetric fixed-offset stencil SpMV, with the fused ⟨x, Ax⟩; and
B2·B4, the same pass with the PCG's search-direction update folded in.

Counterpart of ``fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv_sym``
and, for B2·B4, of the JAX PCG body's ``_axpy`` followed by
``_spmv.spmv_dot`` and ``rz / pAp`` (``fenicsx_beat_tpu/fused.py:545-551``).
The operator is given by its ``d >= 0`` offsets ``pos`` and their value
columns ``vals`` ``[Kp, n]`` (:func:`~.sparse.pack_sym_values`); the
sub-diagonal terms come from the shifted products ``(v_d x)[r - d]``.

On a CUDA tensor :func:`stencil_spmv_sym`, :func:`stencil_spmv_sym_dot`
and :class:`SymDirDot` launch the hand-written kernel
``csrc/stencil_spmv_sym.cu`` (one launch each, the dot summed by the
launch's last block; B2's forms counted on ``stencil_spmv_sym``, B2·B4 on
``stencil_spmv_sym_dir_dot``); on a CPU tensor they run the plain PyTorch
twins.  :class:`SymDirDot` is B2·B4 bound to one operator with its
buffers, for a PCG loop that allocates nothing;
:func:`stencil_spmv_sym_dir_dot` binds one for a single call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._build import check, load_library, require_cuda_f32, require_f32_like, stream_ptr
from .cuda_cg import axpy_twin

__all__ = [
    "stencil_spmv_sym",
    "stencil_spmv_sym_dot",
    "stencil_spmv_sym_dir_dot",
    "stencil_spmv_sym_twin",
    "stencil_spmv_sym_dot_twin",
    "stencil_spmv_sym_dir_dot_twin",
    "SymDirDot",
]

MAX_OFFSETS = 8  # kMaxOffsets in csrc/stencil_spmv_sym.cu
BLOCK = 512  # kBlock, rows a block, in csrc/stencil_spmv_sym.cu


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


def stencil_spmv_sym_dir_dot_twin(vals, z, p_old, pos, rz_cur, rz_prev):
    """Plain PyTorch twin of B2·B4: ``p' = axpy_twin(z, p_old, rz_cur /
    rz_prev)`` (``p' = z`` itself when ``rz_prev`` is None), then
    ``Ap', pAp = stencil_spmv_sym_dot_twin(vals, p')`` and ``alpha = rz_cur
    / pAp``; returns ``(p', Ap', pAp, alpha)``."""
    p = z if rz_prev is None else axpy_twin(z, p_old, rz_cur / rz_prev)
    ap, pap = stencil_spmv_sym_dot_twin(vals, p, pos)
    return p, ap, pap, rz_cur / pap


@functools.lru_cache(maxsize=None)
def _offsets(pos: tuple) -> tuple:
    """``pos`` as an int32 host array the C entry points read, with its
    address; cached, so a call builds nothing."""
    arr = (ctypes.c_int * len(pos))(*pos)
    return arr, ctypes.addressof(arr)


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, n: int) -> tuple:
    """The addresses of the dot's per-block partials and the last-block
    counter of one device and size, shared by every call (launches on one
    stream run in order; the kernel leaves the counter 0)."""
    partials = torch.empty(-(-n // BLOCK), dtype=torch.float64, device=device)
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    return partials, counter, partials.data_ptr(), counter.data_ptr()


def _check_operator(vals: torch.Tensor, pos, n: int) -> int:
    """Checks of the table and offsets; returns ``Kp``."""
    kp = len(pos)
    if not 1 <= kp <= MAX_OFFSETS or any(not 0 <= d < n for d in pos):
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets in [0, {n}), got {pos}")
    require_cuda_f32(vals=vals)
    if tuple(vals.shape) != (kp, n):
        raise ValueError(f"vals {tuple(vals.shape)} does not match ({kp}, {n})")
    if kp * n > 2**31 - 1 - BLOCK:
        raise ValueError("the kernel addresses the table with 32-bit offsets")
    return kp


def _launch(vals: torch.Tensor, x: torch.Tensor, pos, with_dot: bool):
    require_cuda_f32(x=x)
    n = x.shape[0]
    kp = _check_operator(vals, pos, n)
    if x.device != vals.device:
        raise ValueError(f"x is on {x.device}, vals on {vals.device}")
    y = torch.empty_like(x)
    dot = partials = counter = None
    if with_dot:
        dot = torch.empty((), dtype=torch.float32, device=x.device)
        _, _, partials, counter = _scratch(x.device, n)
    err = load_library().lib.stencil_spmv_sym(
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, _offsets(tuple(pos))[1], kp,
        partials, counter, None if dot is None else dot.data_ptr(), stream_ptr(x),
    )
    check(err, "stencil_spmv_sym")
    stencil_spmv_sym.launches += 1
    return y, dot


def stencil_spmv_sym(vals: torch.Tensor, x: torch.Tensor, pos) -> torch.Tensor:
    """y = A x for the symmetric stencil ``(pos, vals)``."""
    if x.device.type == "cpu":
        return stencil_spmv_sym_twin(vals, x, pos)
    return _launch(vals, x, pos, False)[0]


def stencil_spmv_sym_dot(vals: torch.Tensor, x: torch.Tensor, pos):
    """(A x, ⟨x, A x⟩) for the symmetric stencil ``(pos, vals)``; the dot
    is a 0-d tensor on x's device."""
    if x.device.type == "cpu":
        return stencil_spmv_sym_dot_twin(vals, x, pos)
    return _launch(vals, x, pos, True)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + 4 * b.numel() and b0 < a0 + 4 * a.numel()


def stencil_spmv_sym_dir_dot(vals, z, p_old, pos, rz_cur, rz_prev):
    """B2·B4: ``(p', A p', ⟨p', A p'⟩, rz_cur / ⟨p', A p'⟩)`` with ``p' = z
    + (rz_cur / rz_prev) p_old``, or ``p' = z`` when ``rz_prev`` is None
    (the first PCG iteration; ``p_old`` is then not read); ``rz_cur`` and
    ``rz_prev`` are 0-d tensors, and so are the two scalars returned.  One
    call of a :class:`SymDirDot` bound for it."""
    return SymDirDot(vals, pos)(z, p_old, rz_cur, rz_prev)


class SymDirDot:
    """B2·B4 bound to one operator ``(pos, vals)``, for the structured PCG
    loop: on the card the table, the offsets, the library's entry point
    and every buffer are set up once, so a call only checks and launches.
    ``p'`` alternates between two buffers (the one that is not ``p_old``);
    ``Ap'`` and the scalars ``pAp`` and ``alpha`` are overwritten by the
    next call.  On a CPU tensor a call runs the twin.  Counted on
    ``stencil_spmv_sym_dir_dot``."""

    def __init__(self, vals: torch.Tensor, pos):
        self._vals, self._pos = vals, tuple(pos)
        self.n = n = vals.shape[1]
        if vals.device.type == "cpu":
            return
        self._kp = _check_operator(vals, pos, n)
        self._offs = _offsets(self._pos)[1]
        dev = self._device = vals.device
        self._p = tuple(torch.empty(2, n, dtype=torch.float32, device=dev))
        self.ap = torch.empty(n, dtype=torch.float32, device=dev)
        scalars = torch.empty(2, dtype=torch.float32, device=dev)
        self.pap, self.alpha = scalars[0], scalars[1]
        _, _, partials, counter = _scratch(dev, n)
        self._ptrs = (partials, counter, scalars.data_ptr(), scalars.data_ptr() + 4)
        self._fn = load_library().lib.stencil_spmv_sym_dir_dot

    def __call__(self, z, p_old, rz_cur, rz_prev):
        """``(p', Ap', pAp, alpha)`` as :func:`stencil_spmv_sym_dir_dot`;
        on the card ``z`` and ``p_old`` must not overlap the ``p'`` buffer
        the call writes (each block forms the halo rows it reads from them
        while other blocks write theirs), and raise if they do."""
        if z.device.type == "cpu":
            return stencil_spmv_sym_dir_dot_twin(self._vals, z, p_old, self._pos, rz_cur, rz_prev)
        n, dev = self.n, self._device
        first = rz_prev is None
        mine = p_old is self._p[0] or p_old is self._p[1]  # the last p', checked when it came in
        p = self._p[1] if p_old is self._p[0] else self._p[0]
        if first or mine:
            require_f32_like((n,), dev, z=z)
        else:
            require_f32_like((n,), dev, z=z, p_old=p_old)
        require_f32_like((), dev, rz_cur=rz_cur, **({} if first else {"rz_prev": rz_prev}))
        if _overlap(p, z) or (not first and _overlap(p, p_old)):
            raise ValueError("z and p_old must lie apart from the p' buffer the call writes")
        partials, counter, pap, alpha = self._ptrs
        err = self._fn(
            self._vals.data_ptr(), z.data_ptr(), None if first else p_old.data_ptr(), rz_cur.data_ptr(),
            None if first else rz_prev.data_ptr(), p.data_ptr(), self.ap.data_ptr(), n, self._offs,
            self._kp, partials, counter, pap, alpha, stream_ptr(z),
        )
        check(err, "stencil_spmv_sym_dir_dot")
        stencil_spmv_sym_dir_dot.launches += 1
        return p, self.ap, self.pap, self.alpha


stencil_spmv_sym.launches = 0
stencil_spmv_sym_dir_dot.launches = 0
