"""The theta-rule diffusion system and its PCG, shared by the port's
monodomain solvers.

One step of ``C_m dv/dt = div(M grad v) + I`` by the theta rule is the
linear system ``A v = b`` with

    A = C_m M + theta dt K,    b = (C_m M - (1 - theta) dt K) v_prev + dt sum(loads)

over the P1 mass ``M`` and stiffness ``K``.  :class:`ThetaSystem` holds
the operator pair on the device and gives the three pieces every step
needs: the operators of a dt (:meth:`ThetaSystem.operators`, built once
per dt), the right-hand side (:meth:`ThetaSystem.rhs`, with the stimulus
loads of :func:`add_stimulus_loads`) and the Jacobi-PCG solve
(:meth:`ThetaSystem.solve`).  The fused splitting solver
(:class:`~.fused.FusedMonodomainSolver`) and the object-oriented model
(:class:`~.base_model.BaseModel`) both step through it.

Two operator paths, chosen by the assembly (``fem.assemble_mass_stiffness_auto``):

- structured meshes: a symmetric stencil operator and the fused-kernel
  PCG (``fenicsx_beat_tpu/fused.py:520-556``), three device launches per
  iteration: B2·B4 (the search-direction update folded into the SpMV, with
  pAp and alpha), B3 and B3's second pass, into buffers bound once per
  operator;
- unstructured meshes: the pair packed into one shared CSR layout
  (:class:`~.ops.cuda_ell.CSRMatrix`), the operators built by value-level
  ``combine``, and the generic Jacobi-PCG of :mod:`.ops.cg` around the CSR
  SpMV kernel B8 (``fenicsx_beat_tpu/fused.py:558-572``).

Both exit on ``sqrt(<r, r>) <= max(rtol ||b||, atol)``, as JAX's ``cg``,
and read that test back to the host once per iteration
(:attr:`ThetaSystem.host_syncs`).  ``use_kernels=False`` runs the
kernels' plain PyTorch twins on any device; on the CPU the kernels'
wrappers run their twins anyway.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .mesh import Mesh
from .ops import cuda_cg, cuda_ell, cuda_spmv
from .ops.cg import cg_solve
from .ops.sparse import StencilMatrix, pack_sym_values, stencil_is_symmetric
from .stimulation import _transform_I_s, separable_stimulus_terms, stimulus_quadratures
from .stimulation import dx as dx_measure

__all__ = ["ThetaSystem", "stimulus_loads", "add_stimulus_loads"]


class ThetaSystem:
    """The theta-rule system of a host operator pair (two
    :class:`~.ops.sparse.StencilMatrix` or two ELL matrices of one
    pattern) on ``device`` in ``dtype``.

    Attributes the solvers and their checks read: ``structured``; on the
    stencil path ``pos`` (the packed offsets), ``mT``/``kT`` ([Kp, n]
    packed values) and ``k0`` (the diagonal's row); on the CSR path
    ``mass``/``stiff`` (:class:`~.ops.cuda_ell.CSRMatrix`); ``spmv``,
    ``spmv_dir_dot``, ``cg_update`` and ``csr_spmv``, the products the
    solve calls (a check may route them elsewhere)."""

    def __init__(self, mass, stiff, C_m: float, theta: float, rtol: float, atol: float, maxiter: int,
                 device: torch.device, dtype: torch.dtype, use_kernels: bool = True):
        self.C_m, self.theta = float(C_m), float(theta)
        self.rtol, self.atol, self.maxiter = float(rtol), float(atol), int(maxiter)
        self.device, self.dtype, self.use_kernels = device, dtype, use_kernels
        self.structured = isinstance(mass, StencilMatrix)
        k = use_kernels
        if self.structured:
            for A in (mass, stiff):
                if not stencil_is_symmetric(A.offsets, A.vals.numpy()):
                    raise NotImplementedError(
                        "non-symmetric stencil operators (general stencil SpMV) are not ported yet"
                    )
            self.pos, mT = pack_sym_values(mass)
            _, kT = pack_sym_values(stiff)
            self.mT = mT.to(device=device, dtype=dtype)
            self.kT = kT.to(device=device, dtype=dtype)
            self.k0 = self.pos.index(0)
            self.n = int(self.mT.shape[1])
            self.spmv = cuda_spmv.stencil_spmv_sym if k else cuda_spmv.stencil_spmv_sym_twin
            # the PCG's two steps with use_kernels=False (else operators() binds the kernels)
            self.spmv_dir_dot = cuda_spmv.stencil_spmv_sym_dir_dot_twin
            self.cg_update = cuda_cg.cg_update_twin
        else:
            # one shared CSR layout for the pair (fused.py:446-464), so the
            # theta-system operators combine by value
            self.pos = None
            self.mass, self.stiff = (
                A.to(device, dtype) for A in cuda_ell.CSRMatrix.from_operator_pair(mass, stiff)
            )
            self.n = int(self.mass.shape[0])
            self.csr_spmv = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
        # the product of a general stimulus's load (B8 or its twin, either path)
        self.load_spmv = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
        self._cache: tuple | None = None
        self.host_syncs = 0  # PCG exit tests read back to the host

    def operators(self, dt: float):
        """``(A, B, prec, pcg)``: the operators ``C_m M + theta dt K`` and
        ``C_m M - (1 - theta) dt K``, the Jacobi preconditioner and the
        structured PCG's two steps bound to A, built once per dt.
        Structured: packed ``[Kp, n]`` stencil values, the inverse diagonal,
        and B2·B4 and B3 with their buffers (:class:`~.ops.cuda_spmv.SymDirDot`,
        :class:`~.ops.cuda_cg.CGUpdate`; the twins with ``use_kernels=False``);
        unstructured: :class:`~.ops.cuda_ell.CSRMatrix` combinations, the
        diagonal and None (``fused.py:466-469``)."""
        if self._cache is not None and self._cache[0] == dt:
            return self._cache[1]
        C_m, th = self.C_m, self.theta
        if self.structured:
            A = C_m * self.mT + (th * dt) * self.kT
            B = C_m * self.mT - ((1.0 - th) * dt) * self.kT
            if self.use_kernels:
                pcg = (cuda_spmv.SymDirDot(A, self.pos), cuda_cg.CGUpdate(self.n, A.device))
            else:
                pcg = (functools.partial(self.spmv_dir_dot, A, pos=self.pos), self.cg_update)
            ops = (A, B, 1.0 / A[self.k0], pcg)
        else:
            A = self.mass.combine(C_m, self.stiff, th * dt)
            B = self.mass.combine(C_m, self.stiff, -(1.0 - th) * dt)
            ops = (A, B, A.diagonal(), None)
        self._cache = (dt, ops)
        return ops

    def apply(self, A, x: torch.Tensor) -> torch.Tensor:
        """``A x`` for an operator of :meth:`operators`: B2 or B8."""
        return self.spmv(A, x, self.pos) if self.structured else self.csr_spmv(A, x)

    def rhs(self, B, v_prev: torch.Tensor, terms, b_units, t, dt: float, amps) -> torch.Tensor:
        """``b = B v_prev`` plus the stimulus loads of ``terms`` at time
        ``t`` (:func:`add_stimulus_loads`)."""
        return add_stimulus_loads(self.apply(B, v_prev), terms, b_units, t, dt, amps, self.load_spmv)

    def solve(self, ops, b: torch.Tensor, x0: torch.Tensor):
        """PCG for ``A x = b`` from ``x0``; returns ``(x, iterations, rr,
        converged)`` with ``rr = <r, r>`` a 0-d tensor.  Structured: the
        fused-kernel PCG (``fused.py:530-556``), each iteration B2·B4 then
        B3, the scalars kept on the device; on the card ``x`` and ``rr`` lie
        in the operator's buffers until the next solve.  Unstructured: the
        generic Jacobi-PCG around B8 (``fused.py:560-572``)."""
        A, _, prec, pcg = ops
        rtol, atol, maxiter = self.rtol, self.atol, self.maxiter
        if not self.structured:
            spmv = self.csr_spmv
            x, k, rr, tol = cg_solve(
                lambda u: spmv(A, u), b, x0, precond_diag=prec, rtol=rtol, atol=atol, maxiter=maxiter
            )
            converged = k < maxiter or bool(torch.sqrt(rr) <= tol)
            self.host_syncs += k + 1  # k + 1 exit tests, or maxiter and the test above
            return x, k, rr, converged
        dir_dot, update = pcg
        minv = prec
        r = b - self.spmv(A, x0, self.pos)
        z = r * minv
        rz = torch.dot(r, z)
        rr = torch.dot(r, r)
        tol2 = torch.clamp(rtol * torch.sqrt(torch.dot(b, b)), min=atol) ** 2
        # p' = z on the first iteration (rz_prev None), z + (rz / rz_prev) p after
        x, p, rz_prev = x0, None, None
        k = 0
        while k < maxiter:
            self.host_syncs += 1
            if not bool(rr > tol2):
                break
            p, Ap, _, alpha = dir_dot(z=z, p_old=p, rz_cur=rz, rz_prev=rz_prev)
            x, r, z, rz_new, rr = update(x, r, p, Ap, minv, alpha)
            rz_prev, rz = rz, rz_new
            k += 1
        converged = k < maxiter or bool(rr <= tol2)
        return x, k, rr, converged


def stimulus_loads(V, I_s, mesh: Mesh, degree: int, device: torch.device, dtype: torch.dtype):
    """The stimuli of ``I_s`` on ``V``: ``(stim_quads, terms, b_units)``
    (:func:`~.stimulation.stimulus_quadratures` with quadrature of
    ``degree`` on cell or exterior-facet measures, then
    :func:`~.stimulation.separable_stimulus_terms`), each TimeWindow load
    assembled once on the host and stacked on the device as ``b_units``
    [n_loads, n] (None without one).  General expressions are assembled
    each step at the time the solver gives (:func:`add_stimulus_loads`)."""
    stim_quads = stimulus_quadratures(V, _transform_I_s(I_s, dZ=dx_measure(mesh)), degree=degree)
    terms, b_units = separable_stimulus_terms(stim_quads)
    b = torch.as_tensor(np.stack(b_units), device=device).to(dtype) if b_units else None
    return stim_quads, terms, b


def add_stimulus_loads(b: torch.Tensor, terms, b_units, t, dt: float, amps, spmv=None) -> torch.Tensor:
    """``b`` plus ``dt * amplitude`` times each stimulus load of ``terms``
    (:func:`~.stimulation.separable_stimulus_terms`) at time ``t``, a
    scalar of the working dtype (``np.float32`` or ``np.float64``): a
    TimeWindow's load from ``b_units`` where its window holds ``t``
    (inclusive at both ends, compared in that dtype), a general
    expression's load assembled at ``t`` on ``b``'s device
    (``fem.CellQuadData.assemble_load``, its product by ``spmv``)."""
    w = type(t)
    for i, quad, expr, b_idx, window in terms:
        scale = float(w(dt) * amps[i])
        if b_idx is not None:
            start, dur = window
            if w(start) <= t <= w(start + dur):
                b = b + scale * b_units[b_idx]
        else:
            b = b + scale * quad.assemble_load(expr, float(t), device=b.device, dtype=b.dtype, spmv=spmv)
    return b
