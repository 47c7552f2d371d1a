"""B3 and B4: the fused vector updates of the Jacobi-PCG iteration.

Counterparts of ``fenicsx_beat_tpu/ops/pallas_cg.py:build_pallas_cg_update``
(B3) and ``build_pallas_axpy`` (B4).  With the dot-fused SpMV (B2) one PCG
iteration is three kernels:

- B2: ``Ap, pAp = spmv_dot(A, p)``
- B3: ``x, r, z, rz, rr = cg_update(x, r, p, Ap, minv, rz / pAp)``
- B4: ``p = axpy(z, p, rz_new / rz)``

The scalars stay 0-d tensors on the device; the kernels read ``alpha``
and ``beta`` by pointer.  On a CUDA tensor the wrappers launch
``csrc/cg_update.cu``; on a CPU tensor they run the plain PyTorch twins.
"""

from __future__ import annotations

import torch

from .._build import check, load_library, num_blocks, require_cuda_f32, stream_ptr

__all__ = ["cg_update", "cg_update_twin", "axpy", "axpy_twin"]


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
    <r', z'> and <r', r'>; ``alpha`` is a 0-d tensor."""
    if x.device.type == "cpu":
        return cg_update_twin(x, r, p, ap, minv, alpha)
    require_cuda_f32(x=x, r=r, p=p, ap=ap, minv=minv, alpha=alpha)
    n = x.shape[0]
    if not (r.shape == p.shape == ap.shape == minv.shape == (n,)) or alpha.numel() != 1:
        raise ValueError("cg_update needs five (n,) vectors and a scalar alpha")
    xo, ro, zo = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    partials = torch.empty(2 * num_blocks(n), dtype=torch.float64, device=x.device)
    sums = torch.empty(2, dtype=torch.float32, device=x.device)
    err = load_library().lib.cg_update(
        alpha.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
        minv.data_ptr(), xo.data_ptr(), ro.data_ptr(), zo.data_ptr(), n,
        partials.data_ptr(), sums.data_ptr(), stream_ptr(x),
    )
    check(err, "cg_update")
    cg_update.launches += 1
    return xo, ro, zo, sums[0], sums[1]


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


cg_update.launches = 0
axpy.launches = 0
