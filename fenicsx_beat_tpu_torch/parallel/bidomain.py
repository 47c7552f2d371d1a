"""Sharded bidomain solver: SPMD ranks, halo exchanges and all-reduced dots
over the stacked ``[2, n]`` (v, u_e) system, with a sharded SA-AMG V-cycle
preconditioning the elliptic extracellular block.

Port of ``fenicsx_beat_tpu/parallel/bidomain.py``, the multi-rank
counterpart of :class:`~..bidomain.BidomainSolver` (its block
discretization and monolithic scheme) on
:class:`~.solver.ShardedMonodomainSolver`'s partition machinery: every
product is a rank's local product over the halo-extended vector (B5 on
structured meshes, B8 on unstructured ones, :class:`~.solver.LocalOperators`)
and every dot is all-reduced over the real dofs.

The sharded AMG split, as in JAX:

- **Level 0** (the only level whose work grows with n) smooths with the
  same halo-exchange product the solve uses; Chebyshev smoothing is
  pointwise, so it shards for free.
- **Restriction** is a per-rank partial product ``R[:, rows_d] r_d``
  (B8) followed by ONE sum all-reduce of coarse size per V-cycle.
- **Levels >= 1** run replicated on every rank (:func:`~..ops.amg.amg_apply`
  on the hierarchy's coarse levels, B8 on the card).
- **Prolongation** is local: each rank holds the P rows of its own fine
  nodes and reads the replicated coarse correction.

Below ``coarse_n`` the hierarchy is one dense pseudo-inverse: the residual
is all-gathered and multiplied on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np
import scipy.sparse as sp
import torch

from .. import fem
from ..base_model import Status
from ..conductivities import as_cell_tensors
from ..config import default_dtype
from ..mesh import Mesh
from ..ops import cuda_ell
from ..ops.amg import amg_apply, build_amg, chebyshev_smooth
from ..ops.cg import CGInfo, cg_solve
from ..ops.cuda_ell import CSRMatrix
from ..splitting import check_ionic_scope
from ..telemetry import NullMonitor
from .comm import Communicator
from .distributed import DeviceMesh
from .solver import LocalOperators, RankStimuli, assemble_partitioned, local_ionic, partition_stimuli

__all__ = ["ShardedBidomainSolver"]

# the JAX solver's u-block hierarchy (parallel/bidomain.py:279-282 there)
U_AMG_OPTS = dict(strength_theta=(0.15, 0.05), omega=0.0, coarse_n=2500)


def _slice_transfers(hier, part, rank: int, device, dtype):
    """``rank``'s level-0 transfers: the restriction's columns of its owned
    fine nodes (``[n1, n_local]``, a partial coarse product summed by one
    all-reduce) and the prolongation's rows of them (``[n_local, n1]``),
    as :class:`CSRMatrix` (padded rows and columns empty)."""
    lv0 = hier.levels[0]
    R, P = sp.csc_matrix(lv0.R), sp.csr_matrix(lv0.P)  # scipy on the host hierarchy's levels
    lo, k = rank * part.n_local, part.real_rows(rank)
    pad = part.n_local - k
    R_d = sp.hstack([R[:, lo : lo + k], sp.csc_matrix((R.shape[0], pad))]).tocsr()
    P_d = sp.vstack([P[lo : lo + k], sp.csr_matrix((pad, P.shape[1]))]).tocsr()
    return (CSRMatrix.from_operator(R_d).to(device, dtype), CSRMatrix.from_operator(P_d).to(device, dtype))


@dataclass
class ShardedBidomainSolver:
    """Operator-splitting bidomain solver sharded over the ranks of a 1-D
    :class:`~.distributed.DeviceMesh`.

    The JAX solver's constructor vocabulary (``parallel/bidomain.py:132-152``
    there).  ``u_precond``: ``"auto"`` and
    ``"amg"`` build the SA-AMG hierarchy of the u_e block (sharded level 0,
    replicated coarse levels); ``"jacobi"`` keeps the diagonal.  At 4-byte
    dtypes the CG tolerances are raised to at least ``rtol`` 1e-6 and
    ``atol`` 1e-7, as JAX raises them.  Every rank constructs the solver
    and calls :meth:`solve`, :attr:`v` and :attr:`u_e` together."""

    mesh: Mesh
    M_i: Any
    M_e: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    device_mesh: DeviceMesh
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0
    pde_theta: float = 0.5
    C_m: float = 1.0
    cg_rtol: float = 1e-8
    cg_atol: float = 1e-10
    cg_maxiter: int = 1000
    monitor: Any = field(default_factory=NullMonitor)
    dtype: Any = None
    u_precond: str = "auto"
    ode_markers: Any = None

    def __post_init__(self):
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"splitting theta must lie in (0, 1], got {self.theta}")
        if not 0.0 < self.pde_theta <= 1.0:
            raise ValueError(f"pde_theta must lie in (0, 1], got {self.pde_theta}")
        if self.u_precond not in ("auto", "amg", "jacobi"):
            raise ValueError(f"u_precond must be auto/amg/jacobi, got {self.u_precond!r}")
        ionic = check_ionic_scope(self.ode_fun, self.ode_markers, self.init_states, self.parameters, self.v_index)
        dm = self.device_mesh
        dev = self.device = dm.device
        self.dtype = self.dtype or default_dtype(dev)
        if dev.type == "cuda" and self.dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self.dtype}")
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        if self.dtype == torch.float32:
            self.cg_rtol = max(self.cg_rtol, 1e-6)
            self.cg_atol = max(self.cg_atol, 1e-7)
        self.monitor = self.monitor or NullMonitor()
        self.rank, nd = dm.rank, dm.world_size
        self.comm = Communicator(dm)

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs
        Mi, Me = as_cell_tensors(self.M_i, self.mesh), as_cell_tensors(self.M_e, self.mesh)
        perm, mass, (k_i, k_e) = assemble_partitioned(self.V, self.mesh, [Mi, Me])
        k_ie = k_i.combine(1.0, k_e, 1.0)
        self._perm, self._iperm = perm, None
        if perm is not None:
            self._iperm = np.empty_like(perm)
            self._iperm[perm] = np.arange(n)
        self.ops = LocalOperators(nd, self.rank, [mass, k_i, k_ie], dev, self.dtype)
        self.part = part = self.ops.part
        self._offsets = self.ops.offsets if self.ops.structured else None
        real = torch.arange(part.n_local, device=dev) < self.ops.n_real
        self._mask = real.to(self.dtype)

        # SA-AMG of the u_e block on the partition numbering, so level 0
        # smooths on the same halo product as the solve
        self._hier = None
        if self.u_precond in ("auto", "amg"):
            self._hier = build_amg(k_ie, dtype=self._np_dtype, semidefinite=True, **U_AMG_OPTS)
        self._u_amg = self._hier is not None
        self._amg_setup(dev)

        self._st = partition_stimuli(self.V, self.mesh, self.I_s, part, perm, self._iperm)
        self._rank_stim = RankStimuli(self._st, part, self.rank, dev, self.dtype)
        layer, states = local_ionic(ionic, self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                                    self.v_index, perm, part, self.rank, n, dev, self.dtype)
        self._ode_step, self.v_index = layer.step, layer.v_index
        self.states = torch.as_tensor(states, device=dev).to(self.dtype).contiguous()
        self.u_e_local = torch.zeros(part.n_local, dtype=self.dtype, device=dev)
        self._ops_cache = None
        self.host_syncs = 0
        self.cg_iterations = 0
        self.steps = 0
        self.comm.barrier()

    def _amg_setup(self, dev):
        h, part = self._hier, self.part
        self._amg_mode = "jacobi" if h is None else ("multilevel" if h.levels else "dense")
        if self._amg_mode == "multilevel":
            lv0 = h.levels[0]
            self._R_d, self._P_d = _slice_transfers(h, part, self.rank, dev, self.dtype)
            lo, k = self.rank * part.n_local, self.ops.n_real
            dinv0 = np.ones(part.n_local)
            dinv0[:k] = np.asarray(lv0.dinv, dtype=np.float64)[lo : lo + k]
            self._dinv0 = torch.as_tensor(dinv0, device=dev).to(self.dtype)
            self._lmax0 = float(lv0.lmax)
            self._sub = replace(h, levels=h.levels[1:]).to_device(dev, self.dtype)
        elif self._amg_mode == "dense":
            self._sub = h.to_device(dev, self.dtype)

    # ------------------------------------------------------------------
    def _extend(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.halo_extend(x.contiguous(), self.part.halo)

    def _mv(self, A, x: torch.Tensor) -> torch.Tensor:
        return self.ops.apply(A, self._extend(x))

    def _pdot(self, a, b):
        """The stacked inner product over real dofs, all-reduced."""
        return self.comm.all_reduce_sum((torch.dot((a * self._mask).reshape(-1), b.reshape(-1))).reshape(1))[0]

    def _pmean(self, x_u):
        return self.comm.all_reduce_sum(torch.sum(x_u * self._mask).reshape(1))[0] / self.part.n_global

    def _u_vcycle(self, r_loc, kie):
        """z ~= K_ie^{-1} r: sharded level-0 Chebyshev, one all-reduce
        restriction, the replicated coarse hierarchy."""
        h = self._hier
        if self._amg_mode == "dense":
            r_full = self.comm.all_gather(r_loc)[: self.part.n_global]
            z = torch.zeros(self.part.n_pad, dtype=r_loc.dtype, device=r_loc.device)
            z[: self.part.n_global] = self._sub.coarse_inv @ r_full
            lo = self.rank * self.part.n_local
            return z[lo : lo + self.part.n_local]

        def kie_mv(x):
            return self._mv(kie, x)

        x = chebyshev_smooth(kie_mv, self._dinv0, self._lmax0, r_loc, None, h.degree, h.lmin_frac)
        resid = r_loc - kie_mv(x)
        rc = self.comm.all_reduce_sum(cuda_ell.csr_spmv(self._R_d, resid.contiguous()))
        xc = amg_apply(self._sub, rc)
        x = x + cuda_ell.csr_spmv(self._P_d, xc.contiguous())
        return chebyshev_smooth(kie_mv, self._dinv0, self._lmax0, r_loc, x, h.degree, h.lmin_frac)

    def _operators(self, dt: float):
        if self._ops_cache is not None and self._ops_cache[0] == dt:
            return self._ops_cache[1]
        C_m, th = float(self.C_m), float(self.pde_theta)
        A = self.ops.combine([C_m, th * dt, 0.0])
        B = self.ops.combine([C_m, -(1.0 - th) * dt, 0.0])
        Ki, Kie = self.ops.mats[1], self.ops.mats[2]
        one = torch.ones(self.part.n_local, dtype=self.dtype, device=self.device)
        real = self._mask > 0
        diag_v = torch.where(real, self.ops.diagonal(A), one)
        dk = self.ops.diagonal(Kie)
        diag_kie = torch.where(real & (dk != 0.0), dk, one)
        ops = (A, B, Ki, Kie, diag_v, diag_kie)
        self._ops_cache = (dt, ops)
        return ops

    def _step(self, ops, v, u_e, dvu, ts, dt: float, amps):
        A, B, Ki, Kie, diag_v, diag_kie = ops
        th = float(self.pde_theta)
        mask = self._mask
        mv = self._mv
        rhs_v = self._rank_stim.add_loads(mv(B, v), ts, dt, amps)
        rhs_u = -(dt / th) * (1.0 - th) * mv(Ki, v)

        def deflate(x):
            return torch.stack([x[0], x[1] - self._pmean(x[1]) * mask])

        def matvec(x):
            x = deflate(x)
            ev, eu = self._extend(x[0]), self._extend(x[1])  # one exchange per block
            apply = self.ops.apply
            yv = apply(A, ev) + dt * apply(Ki, eu)
            yu = dt * apply(Ki, ev) + (dt / th) * apply(Kie, eu)
            return deflate(torch.stack([yv, yu]))

        def precond(r):
            zv = r[0] / diag_v
            if self._amg_mode == "jacobi":
                zu = r[1] / ((dt / th) * diag_kie)
            else:
                zu = (th / dt) * self._u_vcycle(r[1], Kie)
            return torch.stack([zv, zu - self._pmean(zu) * mask])

        b = deflate(torch.stack([rhs_v, rhs_u]))
        x0 = deflate(torch.stack([v, u_e]) + dvu)
        maxiter = int(self.cg_maxiter)
        x, k, rr, tol = cg_solve(matvec, b, x0, precond=precond, rtol=float(self.cg_rtol),
                                 atol=float(self.cg_atol), maxiter=maxiter, dot=self._pdot)
        self.host_syncs += k + 1
        rnorm = torch.sqrt(rr)
        return x, k, float(rnorm), k < maxiter or bool(rnorm <= tol)

    def run_chunk(self, t0, dt: float, n_steps: int, amps=None):
        """Advance ``n_steps`` steps of ``dt`` from ``t0`` (JAX's
        ``local_chunk``): tentative ionic step, the deflated block PCG
        warm-started from the last increment (reset each chunk),
        corrective ionic step (none at theta=1); u_e grounded to zero mean
        over the real dofs at the end.  Returns ``(t, iters_max, rnorm,
        converged)``."""
        w = self._np_dtype
        amps = self.stimulus_amplitudes() if amps is None else amps
        dtw = w(dt)
        dt_f = float(dtw)
        th = float(self.theta)
        godunov = bool(np.isclose(th, 1.0))
        tent_dt, corr_dt = float(w(th) * dtw), float(w(1.0 - th) * dtw)
        ops = self._operators(dt_f)
        vi, states, u_e = self.v_index, self.states, self.u_e_local
        t = w(t0)
        v_cur = states[vi].clone()
        dvu = torch.zeros((2, self.part.n_local), dtype=self.dtype, device=self.device)
        it_max, conv, rn = 0, True, 0.0
        for _ in range(n_steps):
            self._ode_step(states, v_cur, float(t), tent_dt)
            v = states[vi]
            x, k, rn, ok = self._step(ops, v, u_e, dvu, t + w(self.pde_theta) * dtw, dt_f, amps)
            dvu = x - torch.stack([v, u_e])
            v_new, u_e = x[0].contiguous(), x[1].contiguous()
            if not godunov:
                self._ode_step(states, v_new, float(t + w(th) * dtw), corr_dt)
                v_new = states[vi]
            v_cur = v_new
            t = t + dtw
            it_max, conv = max(it_max, k), conv and ok
            self.cg_iterations += k
        states[vi].copy_(v_cur)
        self.u_e_local = u_e - self._pmean(u_e) * self._mask
        self.steps += n_steps
        return float(t), it_max, rn, conv

    # ------------------------------------------------------------------
    def _global(self, x_loc):
        g = self.comm.gather_global(x_loc)[..., : self.part.n_global]
        if self._iperm is not None:
            g = g[..., torch.as_tensor(self._iperm, device=g.device)]
        return g

    @property
    def v(self) -> torch.Tensor:
        """Transmembrane voltage in the mesh's original dof order, on every rank."""
        return self._global(self.states[self.v_index])

    @property
    def u_e(self) -> torch.Tensor:
        """Extracellular potential in the mesh's original dof order, on every rank."""
        return self._global(self.u_e_local)

    def stimulus_amplitudes(self) -> np.ndarray:
        return self._st.amplitudes(self._np_dtype)

    def solve(self, interval, dt: float, save_freq: int | None = None, save_callback=None) -> Status:
        """March (T0, T] in chunks of ``save_freq`` steps; ``save_callback(t,
        v, u_e)`` receives gathered host copies (original dof order) on
        every rank; one :class:`~..ops.cg.CGInfo` per chunk to the monitor."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        t = self._np_dtype(T0)
        done, ok = 0, True
        while done < n_total:
            n = min(chunk, n_total - done)
            t_end, it_max, rn, conv = self.run_chunk(t, dt, n)
            t = self._np_dtype(t_end)
            done += n
            ok = ok and conv
            self.last_cg = CGInfo(it_max, rn, conv)
            self.monitor.record_ksp(self.last_cg)
            if save_callback is not None:
                save_callback(float(t), self.v.cpu().numpy(), self.u_e.cpu().numpy())
        return Status.OK if ok else Status.NOT_CONVERGING
