"""B3 and B4: the fused vector updates of the Jacobi-PCG iteration.

Counterparts of ``fenicsx_beat_tpu/ops/pallas_cg.py:build_pallas_cg_update``
(B3) and ``build_pallas_axpy`` (B4).  On the structured main path one PCG
iteration is three device launches (``fused.py:FusedMonodomainSolver._pde_solve``):

- B2·B4: ``p, Ap, pAp, alpha = SymDirDot(A, pos)(z, p, rz, rz_prev)``
  (:mod:`.cuda_spmv`: B4's ``z + (rz / rz_prev) p`` formed inside B2's pass)
- B3 and its second pass: ``x, r, z, rz, rr = CGUpdate(n, device)(x, r, p,
  Ap, minv, alpha)``

B4's own kernel, :func:`axpy`, stays for any caller that needs the update
alone; the main path no longer launches it.  The scalars stay 0-d tensors
on the device; the kernels read ``alpha`` and ``beta`` by pointer.  On a
CUDA tensor the wrappers launch ``csrc/cg_update.cu``; on a CPU tensor
they run the plain PyTorch twins.  :class:`CGUpdate` is B3 with its
outputs and scratch set up once, for a PCG loop that allocates nothing;
:func:`cg_update` builds one for a single call.
"""

from __future__ import annotations

import torch

from .._build import check, load_library, num_blocks, require_cuda_f32, require_f32_like, stream_ptr

__all__ = ["cg_update", "cg_update_twin", "axpy", "axpy_twin", "CGUpdate"]


def cg_update_twin(x, r, p, ap, minv, alpha):
    """Plain PyTorch twin: ``(x + a p, r', r' minv, <r', z'>, <r', r'>)``
    with ``r' = r - a Ap``."""
    x = x + alpha * p
    r = r - alpha * ap
    z = r * minv
    return x, r, z, torch.dot(r, z), torch.dot(r, r)


def axpy_twin(z, p, beta):
    """Plain PyTorch twin: ``z + beta p``."""
    return z + beta * p


def cg_update(x, r, p, ap, minv, alpha):
    """x' = x + a p, r' = r - a Ap, z' = r' * minv, and the 0-d tensors
    <r', z'> and <r', r'>; ``alpha`` is a 0-d tensor.  One call of a
    :class:`CGUpdate` bound for it."""
    return CGUpdate(x.shape[0], x.device)(x, r, p, ap, minv, alpha)


def axpy(z, p, beta):
    """z + beta p, with ``beta`` a 0-d tensor."""
    if z.device.type == "cpu":
        return axpy_twin(z, p, beta)
    require_cuda_f32(z=z, p=p, beta=beta)
    n = z.shape[0]
    if p.shape != (n,) or beta.numel() != 1:
        raise ValueError("axpy needs two (n,) vectors and a scalar beta")
    out = torch.empty_like(z)
    err = load_library().lib.axpy(
        z.data_ptr(), p.data_ptr(), beta.data_ptr(), out.data_ptr(), n, stream_ptr(z)
    )
    check(err, "axpy")
    axpy.launches += 1
    return out


class CGUpdate:
    """B3 for ``(n,)`` vectors on one device with its outputs set up once:
    ``x'``, ``r'``, ``z'`` and the two sums alternate between two buffers
    each, so a call never overwrites the ``x``, ``r``, ``z`` or ``rz`` it
    reads, nor the ``rz`` of the call before (which B2·B4 reads as
    ``rz_prev``); what a call returns is overwritten two calls later.  On
    a CPU tensor a call runs the twin.  Counted on ``cg_update``."""

    def __init__(self, n: int, device):
        self.n = n
        dev = torch.device(device)
        if dev.type == "cpu":
            return
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        out = torch.empty(2, 3, n, dtype=torch.float32, device=dev)  # [buffer, (x', r', z')]
        sums = torch.empty(2, 2, dtype=torch.float32, device=dev)
        self._out = tuple((tuple(out[i]), sums[i], sums[i, 0], sums[i, 1]) for i in range(2))
        self._partials = torch.empty(2 * num_blocks(n), dtype=torch.float64, device=dev)
        self._i = 0
        self._fn = load_library().lib.cg_update

    def __call__(self, x, r, p, ap, minv, alpha):
        """``(x', r', z', <r', z'>, <r', r'>)`` as :func:`cg_update`; on
        the card every operand a contiguous ``(n,)`` float32 vector on the
        bound device, ``alpha`` a 0-d one."""
        if x.device.type == "cpu":
            return cg_update_twin(x, r, p, ap, minv, alpha)
        require_f32_like((self.n,), self._device, x=x, r=r, p=p, ap=ap, minv=minv)
        require_f32_like((), self._device, alpha=alpha)
        self._i ^= 1
        (xo, ro, zo), sums, rz, rr = self._out[self._i]
        err = self._fn(
            alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(), minv.data_ptr(),
            xo.data_ptr(), ro.data_ptr(), zo.data_ptr(), self.n, self._partials.data_ptr(),
            sums.data_ptr(), stream_ptr(x),
        )
        check(err, "cg_update")
        cg_update.launches += 1
        return xo, ro, zo, rz, rr


cg_update.launches = 0
axpy.launches = 0
