"""Bidomain cardiac electrophysiology: transmembrane and extracellular potentials.

Port of ``fenicsx_beat_tpu/bidomain.py``.  The bidomain model is the
monodomain's physical parent, needed where the extracellular field
matters or the two anisotropy ratios differ (no monodomain reduction
exists then):

    C_m dv/dt + I_ion = div(M_i grad(v + u_e)) + I_s
                    0 = div(M_i grad v) + div((M_i + M_e) grad u_e)

With ``K(M)`` the SPD stiffness of ``-div(M grad)`` and the theta rule on
v, each step solves the symmetric positive semidefinite block system

    [ C_m M + theta dt K_i     dt K_i                 ] [v']   [(C_m M - (1-theta) dt K_i) v + dt b_s]
    [ dt K_i                   (dt/theta)(K_i + K_e)  ] [u_e] = [-(dt/theta)(1-theta) K_i v           ]

whose nullspace is the constant u_e.  Two schemes, as in JAX:

- ``"monolithic"``: one deflated PCG on the stacked ``[2, n]`` system, four
  operator streams per iteration (``A``, ``K_i`` twice, ``K_ie``); Jacobi
  on the v block and, on the u block, the DCT spectral inverse of ``K_ie``
  (:mod:`.ops.spectral`) on constant-coefficient tensor grids, else one
  SA-AMG V-cycle on ``K_ie`` (:mod:`.ops.amg`);
- ``"gs"`` (Gauss-Seidel): the parabolic v-solve with the lagged,
  linearly extrapolated u_e, then the elliptic u-solve, one stream per
  iteration each, both DCT-preconditioned on tensor grids; elsewhere the
  v-solve takes Jacobi and the u-solve the AMG V-cycle.

The constant-u_e nullspace is deflated inside the matvec, the
preconditioner, the right-hand side and the start, u_e is grounded to zero
mean at each chunk's end and the warm-start increment restarts every
chunk (``bidomain.py:677-772`` there): in float32 any one of them left out
lets rounding feed the nullspace.  At 4-byte dtypes the CG tolerances are
raised to at least ``rtol`` 1e-6 and ``atol`` 1e-7, as JAX raises them.

Every SpMV runs through a kernel of the port: on structured meshes the
general stencil SpMV B5 (``ops/cuda_stencil.stencil_spmv``) on the packed
``[K, n]`` value tables of ``A``, ``B``, ``K_i`` and ``K_ie``, combined
once per dt; on unstructured meshes the CSR SpMV B8 on one shared layout
for mass, ``K_i`` and ``K_ie``.  The ionic step is
:func:`~.splitting.ionic_layer`'s, as in the fused solver: B1 of the
model's entry, B1's per-node form for a node-aligned field, or B7 for a
dict ``ode_fun`` with ``ode_markers`` (B7's mixed form, one launch per
model, where the markers mix models).  On the CPU, or with ``use_kernels=False``, every kernel
runs as its plain PyTorch twin.  As in the fused solver the time loop is a
Python loop of eager launches, and each PCG exit test reads one value back
to the host (counted in :attr:`BidomainSolver.host_syncs`).

The AMG hierarchy (``u_precond="amg"``, and ``"auto"`` where the DCT
declines: an unstructured or heterogeneous mesh, as the JAX package takes
it off the TPU) is built on the host on ``K_ie`` with ``semidefinite=True``
and the JAX solver's defaults ``strength_theta=(0.15, 0.05), omega=0.0,
coarse_n=2500``, updated by ``u_amg_opts``; every product of its V-cycle is
B8 on the card.  Not ported: the gs scheme's elliptic cadence
``u_solve_every > 1``, which raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import fem
from .base_model import Status
from .conductivities import as_cell_tensors
from .config import default_dtype, resolve_device
from .convert import states_from_numpy
from .mesh import Mesh
from .ops import cuda_ell, cuda_stencil
from .ops.amg import amg_apply, build_amg
from .ops.cg import CGInfo, cg_solve
from .ops.sparse import StencilMatrix, pack_values
from .ops.spectral import dct_solve, stencil_dct_eigenvalues
from .splitting import check_ionic_scope, ionic_layer
from .theta_system import stimulus_loads

__all__ = ["BidomainSolver", "BidomainChunk"]

logger = logging.getLogger(__name__)

U_PRECONDS = ("auto", "dct", "amg", "jacobi")
# the JAX solver's u-block hierarchy options (bidomain.py:306-318 there)
U_AMG_DEFAULTS = dict(strength_theta=(0.15, 0.05), omega=0.0, coarse_n=2500)


class BidomainChunk(NamedTuple):
    t: float  # time at the chunk's end
    iters_max: int  # CG iterations of the chunk's worst step (gs: both solves)
    iters_sum: int
    residual_norm: float  # the largest final ||r|| of the chunk's solves
    converged: bool


class _StepOps(NamedTuple):
    """The per-dt operators of a chunk: ``A = C_m M + theta dt K_i`` (its
    packed stencil table or CSR matrix), the SpMVs of ``A``, ``B = C_m M -
    (1 - theta) dt K_i``, ``K_i`` and ``K_ie``, the diagonals of ``A`` and
    ``K_ie``, and the DCT eigenvalues of the u block and (gs) of ``A``."""

    A: Any
    mvA: Callable
    mvB: Callable
    mvKi: Callable
    mvKie: Callable
    diag_v: torch.Tensor
    diag_kie: torch.Tensor
    u_lam: torch.Tensor | None
    v_lam: torch.Tensor | None


@dataclass
class BidomainSolver:
    """Operator-splitting bidomain solver on device-resident state.

    The JAX solver's constructor vocabulary (``fenicsx_beat_tpu/bidomain.py``)
    and the port's ``device`` and ``use_kernels``; the knobs of JAX's TPU
    lane path (``use_pallas_ode``, ``pallas_spmv_min_nodes``,
    ``amg_min_nodes``) are not taken.

    Parameters
    ----------
    mesh : Mesh
    M_i, M_e : intracellular and extracellular conductivities (any spec
        :func:`~.conductivities.as_cell_tensors` takes)
    ode_fun, init_states, parameters, v_index, ode_markers : the ionic model,
        as :class:`~.fused.FusedMonodomainSolver` takes them
    I_s : Stimulus | list[Stimulus] (TimeWindow or any expression
        ``f(x, t)``, the latter assembled each step at the PDE theta point)
    theta : splitting, in (0, 1] (1 Godunov, 0.5 Strang)
    pde_theta : the PDE's time rule, in (0, 1]
    cg_rtol, cg_atol, cg_maxiter : the block CG's tolerances (raised to at
        least 1e-6 and 1e-7 in float32)
    monitor : any object with ``record_ksp(CGInfo)``, called once per chunk
    u_precond : "auto" | "dct" | "amg" | "jacobi" ("auto": the DCT where
        it applies, else AMG)
    u_amg_opts : keyword arguments of :func:`~.ops.amg.build_amg` over
        :data:`U_AMG_DEFAULTS`
    cache_key : opts the operator pairs (``|i`` and ``|e``, keyed by mesh,
        conductivity and dtype) and the AMG hierarchy (keyed by the
        operator's bytes and the options) into the disk cache (:mod:`.cache`)
    scheme : "monolithic" | "gs"
    gs_v_rtol, gs_u_rtol : the gs solves' relative tolerances (None: cg_rtol)
    u_solve_every : 1 (the gs cadence above 1 is not ported)
    device, dtype : the card unless the CPU is named; float32 on CUDA,
        float64 on the CPU by default
    use_kernels : False runs the plain PyTorch twins of the kernels
    """

    mesh: Mesh
    M_i: Any
    M_e: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0
    pde_theta: float = 0.5
    C_m: float = 1.0
    cg_rtol: float = 1e-8
    cg_atol: float = 1e-10
    cg_maxiter: int = 1000
    monitor: Any = None
    dtype: Any = None
    u_precond: str = "auto"
    scheme: str = "monolithic"
    gs_v_rtol: float | None = None
    gs_u_rtol: float | None = None
    u_solve_every: int = 1
    ode_markers: Any = None
    u_amg_opts: dict | None = None
    cache_key: str | None = None
    device: Any = None
    use_kernels: bool = True

    def __post_init__(self):
        self._check_scope()
        self.device = resolve_device(self.device)
        self.dtype = self.dtype or default_dtype(self.device)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self.dtype}")
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        dev, dt_ = self.device, self.dtype

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self._n = self.V.ndofs
        layer = ionic_layer(self._ionic, self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                            self.v_index, n, dev, dt_, self.use_kernels)
        self._ionic_groups, self._ionic_fields, self._ode_step = layer.groups, layer.fields, layer.step
        self.init_states, self.v_index = layer.init_states, layer.v_index

        # operators, float64 on the host: one assembly per conductivity;
        # same mesh and assembler, so one pattern, and K_ie combines by value
        ck = self.cache_key
        mass, k_i = fem.assemble_mass_stiffness_auto(self.V, as_cell_tensors(self.M_i, self.mesh),
                                                      cache_key=None if ck is None else ck + "|i")
        _, k_e = fem.assemble_mass_stiffness_auto(self.V, as_cell_tensors(self.M_e, self.mesh),
                                                  cache_key=None if ck is None else ck + "|e")
        k_ie = k_i.combine(1.0, k_e, 1.0)

        # dtype-aware tolerances (bidomain.py:225-227 there): the defaults
        # are float64-grade; float32 CG cannot reach 1e-8
        if self.dtype == torch.float32:
            self.cg_rtol = max(self.cg_rtol, 1e-6)
            self.cg_atol = max(self.cg_atol, 1e-7)

        self._stim_quads, self._stim_terms, self._b_units = stimulus_loads(
            self.V, self.I_s, self.mesh, 4, dev, dt_
        )
        init = np.asarray(self.init_states, dtype=np.float64)
        states = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
        self.states = states_from_numpy(states, dev, dt_)
        self.u_e = torch.zeros(n, dtype=dt_, device=dev)
        self._build_operators(mass, k_i, k_ie)
        self._ops_cache: tuple | None = None
        self.host_syncs = 0  # values read back to the host: PCG exit tests, one residual per chunk
        self.cg_iterations = 0  # over every step (gs: both solves)
        self.steps = 0
        self.last_cg: CGInfo | None = None

    def _check_scope(self):
        """Refusals that need no mesh, in the JAX solver's words where it
        refuses the same (``bidomain.py:157-204``)."""
        if self.scheme not in ("monolithic", "gs"):
            raise ValueError(f"scheme must be 'monolithic' or 'gs', got {self.scheme!r}")
        every = int(self.u_solve_every)
        if every < 1:
            raise ValueError(f"u_solve_every must be >= 1, got {self.u_solve_every!r}")
        if every > 1 and self.scheme != "gs":
            raise ValueError(
                "u_solve_every > 1 requires scheme='gs' (the monolithic block solve has no separate "
                "elliptic sub-solve to skip)"
            )
        if every > 1:
            raise NotImplementedError(
                "u_solve_every > 1 (the gs elliptic cadence) is not ported: the JAX cadence reapplies a "
                "stale extrapolation slope (ROADMAP Queue C); a port needs a global step index and its own "
                "gate against u_solve_every=1"
            )
        if not 0.0 < self.theta <= 1.0:
            raise ValueError(f"splitting theta must lie in (0, 1], got {self.theta}")
        if not 0.0 < self.pde_theta <= 1.0:
            raise ValueError(f"pde_theta must lie in (0, 1], got {self.pde_theta}")
        if self.u_precond not in U_PRECONDS:
            raise ValueError(f"u_precond must be auto/dct/amg/jacobi, got {self.u_precond!r}")
        self._ionic = check_ionic_scope(self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                                        self.v_index)

    def _build_operators(self, mass, k_i, k_ie):
        """Device operators, the kernels that apply them and the DCT
        eigenvalue models (``bidomain.py:256-436`` there)."""
        dev, dt_ = self.device, self.dtype
        self._structured = isinstance(mass, StencilMatrix)
        spec = None
        if self._structured and self.u_precond in ("auto", "dct"):
            spec = stencil_dct_eigenvalues(k_ie, self.mesh, dtype=np.float64)
        if spec is None and self.u_precond == "dct":
            raise ValueError(
                "u_precond='dct' requires a constant-coefficient structured grid (stencil operator with "
                "constant interior rows)"
            )
        self._u_dct = spec is not None
        self._dims = spec[1] if spec is not None else None
        self._u_lam = torch.as_tensor(spec[0], device=dev) if spec is not None else None
        self._gs_lams = None
        if self.scheme == "gs" and spec is not None:
            # eigenvalue models of the parabolic block's two operators (the
            # same transform, so they combine like the operators per dt)
            spec_m = stencil_dct_eigenvalues(mass, self.mesh, dtype=np.float64)
            spec_ki = stencil_dct_eigenvalues(k_i, self.mesh, dtype=np.float64)
            if spec_m is not None and spec_ki is not None:
                self._gs_lams = (torch.as_tensor(spec_m[0], device=dev), torch.as_tensor(spec_ki[0], device=dev))
        k = self.use_kernels
        if self._structured:
            self._offsets = tuple(int(d) for d in mass.offsets)
            self._k0 = self._offsets.index(0)
            self._mT, self._kiT, self._kieT = (pack_values(A).to(device=dev, dtype=dt_) for A in (mass, k_i, k_ie))
            self._spmv = cuda_stencil.stencil_spmv if k else cuda_stencil.stencil_spmv_twin
        else:
            # one shared CSR layout for the three operators (the JAX
            # lane-gather group, bidomain.py:412-417), so combine is by value
            self._massC, self._kiC, self._kieC = (
                A.to(dev, dt_) for A in cuda_ell.CSRMatrix.from_operator_group((mass, k_i, k_ie))
            )
            self._csr_spmv = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
        # SA-AMG on the u block wherever the DCT declines (JAX's choice off
        # the TPU), or when asked for
        self._amg = None
        self.amg_setup_s = 0.0  # host build and push of the hierarchy
        if spec is None and self.u_precond in ("auto", "amg"):
            tic = time.perf_counter()
            opts = {**U_AMG_DEFAULTS, **(self.u_amg_opts or {})}
            hier = build_amg(k_ie, dtype=self._np_dtype, semidefinite=True, cache_key=self.cache_key, **opts)
            self._amg = hier.to_device(dev, dt_, level0_A=None if self._structured else self._kieC)
            self._amg_spmv = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
            self.amg_setup_s = time.perf_counter() - tic
        self._u_amg = self._amg is not None

    def _operators(self, dt: float) -> _StepOps:
        """The chunk's operators at ``dt``, combined once per dt
        (``bidomain.py:521-555`` there)."""
        if self._ops_cache is not None and self._ops_cache[0] == dt:
            return self._ops_cache[1]
        C_m, th = float(self.C_m), float(self.pde_theta)
        if self._structured:
            A = C_m * self._mT + (th * dt) * self._kiT
            B = C_m * self._mT - ((1.0 - th) * dt) * self._kiT
            spmv, offs, kiT, kieT = self._spmv, self._offsets, self._kiT, self._kieT
            mv = [lambda x, T=T: spmv(T, x, offs) for T in (A, B, kiT, kieT)]
            diag_v, diag_kie = A[self._k0], kieT[self._k0]
        else:
            A = self._massC.combine(C_m, self._kiC, th * dt)
            B = self._massC.combine(C_m, self._kiC, -(1.0 - th) * dt)
            spmv = self._csr_spmv
            mv = [lambda x, T=T: spmv(T, x) for T in (A, B, self._kiC, self._kieC)]
            diag_v, diag_kie = A.diagonal(), self._kieC.diagonal()
        v_lam = None
        if self._gs_lams is not None:
            lam_m, lam_ki = self._gs_lams
            v_lam = C_m * lam_m + (th * dt) * lam_ki
        ops = _StepOps(A, *mv, diag_v, diag_kie, self._u_lam, v_lam)
        self._ops_cache = (dt, ops)
        return ops

    # ------------------------------------------------------------------
    def _cg(self, matvec, b, x0, rtol, **prec):
        """PCG to ``rtol`` (and the solver's atol and maxiter); returns
        ``(x, iterations, ||r||, converged)``, the norm a 0-d tensor."""
        maxiter = int(self.cg_maxiter)
        x, k, rr, tol = cg_solve(matvec, b, x0, rtol=rtol, atol=float(self.cg_atol), maxiter=maxiter, **prec)
        rnorm = torch.sqrt(rr)
        converged = k < maxiter or bool(rnorm <= tol)
        self.host_syncs += k + 1  # k + 1 exit tests, or maxiter and the test above
        return x, k, rnorm, converged

    def _dct(self, r, lam):
        return dct_solve(r, lam, self._dims)

    def _u_inverse(self, r, lam):
        """The u block's preconditioner: the DCT inverse of ``K_ie`` (``lam``
        its eigenvalues) or one AMG V-cycle."""
        if lam is not None:
            return self._dct(r, lam)
        return amg_apply(self._amg, r, self._amg_spmv)

    def _stimulus(self, ts, amps):
        """The stimulus load at the PDE theta point ``ts``: each TimeWindow
        term whose window holds ``ts`` (inclusive at both ends, compared in
        the working dtype) and each general expression's load assembled at
        ``ts`` (``fem.CellQuadData.assemble_load``, one B8 product), or
        None (``bidomain.py:510-518`` there)."""
        w = self._np_dtype
        b = None
        for i, quad, expr, b_idx, window in self._stim_terms:
            if b_idx is None:
                load = quad.assemble_load(expr, float(ts), device=self.device, dtype=self.dtype,
                                          spmv=cuda_ell.csr_spmv if self.use_kernels else cuda_ell.csr_spmv_twin)
                term = float(amps[i]) * load
            elif w(window[0]) <= ts <= w(window[0] + window[1]):
                term = float(amps[i]) * self._b_units[b_idx]
            else:
                continue
            b = term if b is None else b + term
        return b

    def _step_monolithic(self, ops: _StepOps, v, u_e, dvu, ts, dt, amps):
        """One deflated block PCG (``bidomain.py:658-736`` there)."""
        th = float(self.pde_theta)
        rhs_v = ops.mvB(v)
        b_s = self._stimulus(ts, amps)
        if b_s is not None:
            rhs_v = rhs_v + dt * b_s
        rhs_u = -(dt / th) * (1.0 - th) * ops.mvKi(v)

        def deflate(x):
            return torch.stack([x[0], x[1] - x[1].mean()])

        def matvec(x):
            x = deflate(x)
            xv, xu = x[0], x[1]
            yv = ops.mvA(xv) + dt * ops.mvKi(xu)
            yu = dt * ops.mvKi(xv) + (dt / th) * ops.mvKie(xu)
            return deflate(torch.stack([yv, yu]))

        if ops.u_lam is not None or self._u_amg:
            # Jacobi on the mass-dominated v block, the DCT inverse of K_ie
            # or its AMG V-cycle on the u block (whose system block is
            # (dt/theta) K_ie)
            def precond(r):
                zv = r[0] / ops.diag_v
                zu = (th / dt) * self._u_inverse(r[1], ops.u_lam)
                return torch.stack([zv, zu - zu.mean()])

            prec = dict(precond=precond)
        else:
            prec = dict(precond_diag=torch.stack([ops.diag_v, (dt / th) * ops.diag_kie]))
        x0 = deflate(torch.stack([v, u_e]) + dvu)
        x, k, rnorm, conv = self._cg(matvec, deflate(torch.stack([rhs_v, rhs_u])), x0, float(self.cg_rtol),
                                     **prec)
        return x[0], x[1], x - torch.stack([v, u_e]), k, rnorm, conv

    def _step_gs(self, ops: _StepOps, v, u_e, dvu, ts, dt, amps):
        """The Gauss-Seidel step (``bidomain.py:557-656`` there): the
        parabolic v-solve with the lagged u_e extrapolated by the last
        increment, then the elliptic constraint at the theta point."""
        th = float(self.pde_theta)
        rtol = float(self.cg_rtol)
        v_rtol = rtol if self.gs_v_rtol is None else float(self.gs_v_rtol)
        u_rtol = rtol if self.gs_u_rtol is None else float(self.gs_u_rtol)
        rhs_v = ops.mvB(v) - dt * ops.mvKi(u_e + dvu[1])
        b_s = self._stimulus(ts, amps)
        if b_s is not None:
            rhs_v = rhs_v + dt * b_s
        if ops.v_lam is not None:
            v_prec = dict(precond=lambda r: self._dct(r, ops.v_lam))
        else:
            v_prec = dict(precond_diag=ops.diag_v)
        v_new, kv, rn_v, cv_v = self._cg(ops.mvA, rhs_v, v + dvu[0], v_rtol, **v_prec)

        def deflate(x):
            return x - x.mean()

        if ops.u_lam is not None or self._u_amg:
            u_prec = dict(precond=lambda r: deflate(self._u_inverse(r, ops.u_lam)))
        else:
            u_prec = dict(precond_diag=ops.diag_kie)
        u_star = deflate(u_e + dvu[1])
        rhs_u = deflate(-ops.mvKi(th * v_new + (1.0 - th) * v))
        u_new, ku, rn_u, cv_u = self._cg(lambda x: deflate(ops.mvKie(deflate(x))), rhs_u, u_star, u_rtol,
                                         **u_prec)
        dvu = torch.stack([v_new - v, u_new - u_e])
        return v_new, u_new, dvu, kv + ku, torch.maximum(rn_v, rn_u), cv_v and cv_u

    def run_chunk(self, t0: float, dt: float, n_steps: int, amps=None) -> BidomainChunk:
        """Advance ``n_steps`` steps of ``dt`` from ``t0``, updating
        :attr:`states` and :attr:`u_e` (``run_chunk`` of ``bidomain.py:741``
        there: step k at ``t0 + k dt`` in the working dtype, the warm-start
        increment from zero, u_e grounded to zero mean at the end)."""
        w = self._np_dtype
        amps = self.stimulus_amplitudes() if amps is None else amps
        dtw = w(dt)
        dt_f = float(dtw)
        th = float(self.theta)
        godunov = bool(np.isclose(th, 1.0))
        tent_dt, corr_dt = float(w(th) * dtw), float(w(1.0 - th) * dtw)
        ops = self._operators(dt_f)
        step = self._step_gs if self.scheme == "gs" else self._step_monolithic
        vi, states, u_e = self.v_index, self.states, self.u_e
        t0w = w(t0)
        v_cur = states[vi]
        dvu = torch.zeros((2, self._n), dtype=self.dtype, device=self.device)
        it_max = it_sum = 0
        conv = True
        rn_max = torch.zeros((), dtype=self.dtype, device=self.device)
        for k in range(n_steps):
            t = t0w + w(k) * dtw
            # tentative ionic step, the PDE voltage injected (theta dt)
            self._ode_step(states, v_cur, float(t), tent_dt)
            v = states[vi]
            v_new, u_e, dvu, iters, rnorm, ok = step(ops, v, u_e, dvu, t + w(self.pde_theta) * dtw, dt_f, amps)
            if not godunov:
                # corrective ionic step ((1 - theta) dt)
                self._ode_step(states, v_new, float(t + w(th) * dtw), corr_dt)
                v_new = states[vi]
            v_cur = v_new
            it_max, it_sum = max(it_max, iters), it_sum + iters
            rn_max = torch.maximum(rn_max, rnorm)
            conv = conv and ok
        states[vi].copy_(v_cur)  # Godunov: v_cur is the PDE result
        self.u_e = u_e - u_e.mean()  # ground the floating extracellular constant
        self.host_syncs += 1  # the chunk's residual norm
        self.cg_iterations += it_sum
        self.steps += n_steps
        return BidomainChunk(float(t0w + w(n_steps) * dtw), it_max, it_sum, float(rn_max), conv)

    # ------------------------------------------------------------------
    @property
    def v(self) -> torch.Tensor:
        return self.states[self.v_index]

    def stimulus_amplitudes(self) -> np.ndarray:
        """Live amplitude vector, read each chunk (``Stimulus.assign`` takes
        effect at the next chunk); 1.0 for a general expression."""
        amps = [float(stim.expr.amplitude) if stim is not None else 1.0 for _, _, stim in self._stim_quads]
        return np.asarray(amps or [0.0], dtype=self._np_dtype)

    def solve(
        self,
        interval: tuple[float, float],
        dt: float,
        save_freq: int | None = None,
        save_callback: Callable[[float, np.ndarray, np.ndarray], None] | None = None,
    ) -> Status:
        """March (T0, T] in chunks of ``save_freq`` steps;
        ``save_callback(t, v, u_e)`` receives host copies after each chunk.
        Records one :class:`~.ops.cg.CGInfo` per chunk (its worst step) in
        :attr:`last_cg` and the monitor; returns ``Status.NOT_CONVERGING``
        if any CG stopped at ``cg_maxiter`` without meeting its tolerance."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        amps = self.stimulus_amplitudes()
        t, done, ok = float(T0), 0, True
        while done < n_total:
            n = min(chunk, n_total - done)
            res = self.run_chunk(t, dt, n, amps)
            done += n
            t = T0 + done * dt
            ok = ok and res.converged
            if not res.converged:
                logger.warning("CG did not converge within cg_maxiter during the chunk ending t=%g", t)
            self.last_cg = CGInfo(res.iters_max, res.residual_norm, res.converged)
            if self.monitor is not None:
                self.monitor.record_ksp(self.last_cg)
            if save_callback is not None:
                # copies: on the CPU .numpy() would alias the state the next chunk steps in place
                save_callback(t, np.array(self.v.cpu()), np.array(self.u_e.cpu()))
        return Status.OK if ok else Status.NOT_CONVERGING
