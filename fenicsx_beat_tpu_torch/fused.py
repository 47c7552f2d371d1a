"""Fused monodomain splitting solver — the port's main path.

Port of ``fenicsx_beat_tpu/fused.py``: the whole time loop — ionic
Rush-Larsen step, voltage exchange, theta-rule PCG solve, activation
tracking and probe readout — over device-resident state.  Where JAX
compiles a chunk into one ``lax.scan`` with a ``lax.while_loop`` PCG, the
port runs a Python loop over eager kernel launches: the PCG's exit test
is the only value that comes back to the host, once per iteration
(``iterations + 1`` host syncs per step, counted in
:attr:`FusedMonodomainSolver.host_syncs`).

Two operator paths, chosen by the assembly as in JAX
(``fem.assemble_mass_stiffness_auto``):

- structured meshes (the Niederer slab): a symmetric stencil operator and
  the fused-kernel PCG, B2 + B3 + B4 per iteration (``fused.py:520-556``);
- unstructured meshes (the LV ellipsoid): the ELL pair packed into one
  shared CSR layout (:class:`~.ops.cuda_ell.CSRMatrix`), the theta-system
  operators built by value-level ``combine``, and the generic Jacobi-PCG
  of :mod:`.ops.cg` around the CSR SpMV kernel B8 (``fused.py:558-572``).
  Its exit test is ``sqrt(rr) > tol``, as JAX's ``cg``, so the iteration
  counts match the JAX solver's.

The ionic model is TP06, ToR-ORd dynCl or ToR-ORd dynCl + Land generalized
Rush-Larsen (V in row 0), FitzHugh-Nagumo forward Euler (V in row 1), or
either step of a model that ``odefile.load_ode`` generated (V in its row),
and the solver takes
its kernels from the model's entry in
:data:`~.ops.cuda_ode.IONIC_MODELS` (:func:`~.splitting.ionic_layer`,
shared with the bidomain solver): B1 for one parameter vector, B1's
per-node form for a node-aligned ``[NP, n]`` parameter field (2-D
``parameters``, as ``fenicsx_beat_tpu/fused.py:213-217`` routes it), or
B7 for marker-partitioned layers: a dict ``ode_fun`` with ``ode_markers``
composes through :func:`~.odesolver.make_multi_ode`, whose masks become
B7's per-node model index, one launch per model, each over the blocks
that hold its nodes where the markers mix models
(:func:`~.ops.cuda_ode.mixed_multi_step`).  Stimuli are separable TimeWindow
loads on cell or exterior-facet measures.  On the CPU every kernel runs as its plain
PyTorch twin, which is how the port is held against the JAX solver;
``use_kernels=False`` selects the twins on any device (the kernel check's
reference on the card); there is no silent switch between the two.

Scope of this port: TP06, ToR-ORd dynCl, ToR-ORd dynCl + Land,
FitzHugh-Nagumo and generated models (one parameter vector, a per-node
parameter field, or one vector per marker, the markers' models mixed or
not), P1, Godunov (theta=1) and Strang (theta=0.5) splitting.  Everything
else the JAX solver offers (merged Strang, other models, per-marker
parameter fields, non-TimeWindow stimuli) raises ``NotImplementedError``.  The node axis is not padded.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from . import fem
from .base_model import Status
from .conductivities import as_cell_tensors
from .config import default_dtype, resolve_device
from .convert import states_from_numpy
from .mesh import Mesh
from .ops import cuda_cg, cuda_ell, cuda_spmv
from .ops.cg import CGInfo, cg_solve
from .ops.sparse import StencilMatrix, pack_sym_values, stencil_is_symmetric
from .splitting import check_ionic_scope, ionic_layer, stimulus_loads

__all__ = ["FusedMonodomainSolver", "ChunkResult"]

logger = logging.getLogger(__name__)


class ChunkResult(NamedTuple):
    t: float  # time at the chunk's end, accumulated in the working dtype
    iters_max: int
    iters_sum: int
    residual_norm: torch.Tensor  # 0-d, last step's final ||r||
    converged: bool
    probes: torch.Tensor | None  # activation times at the probe points


@dataclass
class FusedMonodomainSolver:
    """Monodomain operator-splitting solver on device-resident state.

    Parameters
    ----------
    mesh : Mesh
    M : conductivity spec (scalar / tensor / ConductivityTensor)
    ode_fun : the ionic step, ``generalized_rush_larsen`` of
        ``models.tentusscher_panfilov_2006``, ``models.torord_dyncl``,
        ``models.torord_dyncl_land`` or ``models.fitzhughnagumo`` (whose
        ``forward_euler`` is the same step), or a dict marker -> one of
        those steps (multi-marker layers, of one model or several, with
        ``ode_markers``)
    init_states : (S,) or (S, n_nodes); a dict marker -> those with a dict ``ode_fun``
    parameters : the model's parameter vector (NP,), or a node-aligned
        (NP, n_nodes) field; a dict marker -> vector with a dict ``ode_fun``
    v_index : the model's voltage row in the state array (TP06 and
        ToR-ORd: 0, FHN: 1); a dict with a dict ``ode_fun``
    I_s : Stimulus | list[Stimulus] (TimeWindow expressions on cell or
        exterior-facet measures)
    theta : 1.0 Godunov / 0.5 Strang (``monodomain_solver.py:94-113``)
    monitor : any object with ``record_ksp(CGInfo)``, called once per chunk
    device, dtype : where the state lives: the card unless the CPU is
        named; float32 on CUDA, float64 on CPU by default (:mod:`.config`)
    use_kernels : False runs the plain PyTorch twins of the kernels
    ode_markers : per-node marker array (or an object with ``.x.array``)
    """

    mesh: Mesh
    M: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0  # splitting scheme (Godunov 1.0 / Strang 0.5)
    pde_theta: float = 0.5  # PDE time discretization (Crank-Nicolson)
    C_m: float = 1.0
    params: dict | None = None
    monitor: Any = None
    activation_threshold: float = 0.0
    probe_points: Any = None  # [np, gdim] physical probe coordinates
    device: Any = None
    dtype: Any = None
    use_kernels: bool = True
    ode_markers: Any = None
    merge_strang_halves: bool = False

    def __post_init__(self):
        self._check_scope()
        self.device = resolve_device(self.device)
        self.dtype = self.dtype or default_dtype(self.device)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self.dtype}")
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        f64 = self.dtype == torch.float64
        p = {
            "quadrature_degree": 4,
            "ksp_rtol": 1e-8 if f64 else 1e-6,
            "ksp_atol": 1e-10 if f64 else 1e-7,
            "ksp_max_it": 1000,
        }
        p.update(self.params or {})
        self._opts = p
        dev, dt_ = self.device, self.dtype

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs
        self._n = n

        # the ionic layer: B1, its per-node form, or B7 for marker layers
        # (fused.py:104-136), whose dicts compose through make_multi_ode
        layer = ionic_layer(self._ionic, self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                            self.v_index, n, dev, dt_, self.use_kernels)
        self._ionic_groups, self._ode_step = layer.groups, layer.step
        self.init_states, self.v_index = layer.init_states, layer.v_index

        # operators: assembled in float64 on the host (stencil first, ELL
        # otherwise, fem.assemble_mass_stiffness_auto)
        M_cells = as_cell_tensors(self.M, self.mesh)
        mass, stiff = fem.assemble_mass_stiffness_auto(self.V, M_cells)
        self._structured = isinstance(mass, StencilMatrix)
        if self._structured:
            for A in (mass, stiff):
                if not stencil_is_symmetric(A.offsets, A.vals.numpy()):
                    raise NotImplementedError(
                        "non-symmetric stencil operators (general stencil SpMV) are not ported yet"
                    )
            self._pos, mT = pack_sym_values(mass)
            _, kT = pack_sym_values(stiff)
            self._mT = mT.to(device=dev, dtype=dt_)
            self._kT = kT.to(device=dev, dtype=dt_)
            self._k0 = self._pos.index(0)
        else:
            # one shared CSR layout for the pair (fused.py:446-464), so the
            # theta-system operators combine by value
            self._pos = None
            self._mass, self._stiff = (
                A.to(dev, dt_) for A in cuda_ell.CSRMatrix.from_operator_pair(mass, stiff)
            )
        self._ops_cache: tuple | None = None

        # stimuli: separable TimeWindow loads, assembled once on the host
        self._stim_quads, self._stim_terms, self._b_units = stimulus_loads(
            self.V, self.I_s, self.mesh, p["quadrature_degree"], dev, dt_
        )

        init = np.asarray(self.init_states, dtype=np.float64)
        states = np.tile(init[:, None], (1, n)) if init.ndim == 1 else init
        self.states = states_from_numpy(states, dev, dt_)
        self.activation_time = torch.full((n,), -1.0, dtype=dt_, device=dev)

        if self.probe_points is not None:
            pdofs, pw = fem.point_evaluation_tables(self.V, np.asarray(self.probe_points))
            self._probe_dofs = torch.as_tensor(pdofs.astype(np.int64), device=dev)
            self._probe_w = torch.as_tensor(pw, device=dev).to(dt_)
        else:
            self._probe_dofs = self._probe_w = None

        k = self.use_kernels
        if self._structured:
            self._spmv = cuda_spmv.stencil_spmv_sym if k else cuda_spmv.stencil_spmv_sym_twin
            self._spmv_dot = cuda_spmv.stencil_spmv_sym_dot if k else cuda_spmv.stencil_spmv_sym_dot_twin
            self._cg_update = cuda_cg.cg_update if k else cuda_cg.cg_update_twin
            self._axpy = cuda_cg.axpy if k else cuda_cg.axpy_twin
        else:
            self._csr_spmv = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
        self.host_syncs = 0  # PCG exit tests read back to the host
        self.cg_iterations = 0  # over every step
        self.steps = 0
        self.last_solve_converged = True
        self.last_cg: CGInfo | None = None  # the last chunk's CG statistics

    def _check_scope(self):
        if self.merge_strang_halves:
            raise NotImplementedError("merged Strang splitting is not ported yet")
        self._ionic = check_ionic_scope(self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                                        self.v_index)
        if not (np.isclose(self.theta, 1.0) or np.isclose(self.theta, 0.5)):
            raise NotImplementedError(f"theta={self.theta}: the port runs Godunov (1) or Strang (0.5)")

    # ------------------------------------------------------------------
    def _operators(self, dt: float):
        """``(A, B, diag)``: the theta-system operators ``C_m M + theta dt K``
        and ``C_m M - (1 - theta) dt K`` and the Jacobi preconditioner, built
        once per dt.  Structured: packed ``[Kp, n]`` stencil values and the
        inverse diagonal; unstructured: :class:`~.ops.cuda_ell.CSRMatrix`
        combinations and the diagonal (``fused.py:466-469``)."""
        if self._ops_cache is not None and self._ops_cache[0] == dt:
            return self._ops_cache[1]
        C_m, th = float(self.C_m), float(self.pde_theta)
        if self._structured:
            A = C_m * self._mT + (th * dt) * self._kT
            B = C_m * self._mT - ((1.0 - th) * dt) * self._kT
            ops = (A, B, 1.0 / A[self._k0])
        else:
            A = self._mass.combine(C_m, self._stiff, th * dt)
            B = self._mass.combine(C_m, self._stiff, -(1.0 - th) * dt)
            ops = (A, B, A.diagonal())
        self._ops_cache = (dt, ops)
        return ops

    def _assemble_rhs(self, B, v_prev, t_stim, dt, amps):
        """b = B v_prev + the stimulus loads whose window holds ``t_stim``
        (inclusive at both ends, compared in the working dtype)."""
        b = self._spmv(B, v_prev, self._pos) if self._structured else self._csr_spmv(B, v_prev)
        w = self._np_dtype
        for i, _, _, b_idx, (start, dur) in self._stim_terms:
            if w(start) <= t_stim <= w(start + dur):
                b = b + float(w(dt) * amps[i]) * self._b_units[b_idx]
        return b

    def _pde_solve(self, ops, v_prev, x0, t_stim, dt, amps):
        """PCG for ``A x = b`` from ``x0``; returns ``(x, iterations, rr,
        converged)`` with ``rr = <r, r>`` a 0-d tensor.  Structured: the
        fused-kernel PCG (``fused.py:530-556``), B2, B3, B4 per iteration,
        the scalars kept on the device.  Unstructured: the generic
        Jacobi-PCG around B8 (``fused.py:560-572``)."""
        A, B, prec = ops
        rtol, atol = float(self._opts["ksp_rtol"]), float(self._opts["ksp_atol"])
        maxiter = int(self._opts["ksp_max_it"])
        b = self._assemble_rhs(B, v_prev, t_stim, dt, amps)
        if not self._structured:
            spmv = self._csr_spmv
            x, k, rr, tol = cg_solve(
                lambda u: spmv(A, u), b, x0, precond_diag=prec, rtol=rtol, atol=atol, maxiter=maxiter
            )
            converged = k < maxiter or bool(torch.sqrt(rr) <= tol)
            self.host_syncs += k + 1  # k + 1 exit tests, or maxiter and the test above
            return x, k, rr, converged
        minv, pos = prec, self._pos
        r = b - self._spmv(A, x0, pos)
        z = r * minv
        rz = torch.dot(r, z)
        rr = torch.dot(r, r)
        tol2 = torch.clamp(rtol * torch.sqrt(torch.dot(b, b)), min=atol) ** 2
        x, p = x0, z
        k = 0
        while k < maxiter:
            self.host_syncs += 1
            if not bool(rr > tol2):
                break
            Ap, pAp = self._spmv_dot(A, p, pos)
            alpha = rz / pAp
            x, r, z, rz_new, rr = self._cg_update(x, r, p, Ap, minv, alpha)
            p = self._axpy(z, p, rz_new / rz)
            rz = rz_new
            k += 1
        converged = k < maxiter or bool(rr <= tol2)
        return x, k, rr, converged

    def run_chunk(self, t0, dt: float, n_steps: int, amps=None, probed: bool = False) -> ChunkResult:
        """Advance ``n_steps`` steps of ``dt`` from time ``t0``, updating
        :attr:`states` and :attr:`activation_time` (``fused.py:604-693``)."""
        w = self._np_dtype
        amps = self.stimulus_amplitudes() if amps is None else amps
        dtw = w(dt)
        dt_f = float(dtw)
        theta = float(self.theta)
        strang = not np.isclose(theta, 1.0)
        tent_dt = float(w(theta) * dtw)
        corr_dt = float(w(1.0 - theta) * dtw)
        ops = self._operators(dt_f)
        thr = float(self.activation_threshold)
        vi = self.v_index
        states, act = self.states, self.activation_time
        t = w(t0)
        v_cur = states[vi]
        dv = torch.zeros_like(v_cur)  # solve increment, reset every chunk
        it_max = it_sum = 0
        all_conv = True
        rr = None
        for _ in range(n_steps):
            # tentative ODE step (monodomain_solver.py:68), PDE voltage injected
            self._ode_step(states, v_cur, float(t), tent_dt)
            v = states[vi]
            # PDE theta-step; stimulus at the PDE theta point; CG warm-started
            # from the previous step's increment
            t_stim = t + w(self.pde_theta) * dtw
            v_new, iters, rr, conv = self._pde_solve(ops, v, v + dv, t_stim, dt_f, amps)
            dv = v_new - v
            if strang:
                # corrective ODE step (Strang, monodomain_solver.py:99-113)
                self._ode_step(states, v_new, float(t + w(theta) * dtw), corr_dt)
                v_new = states[vi]
            act = torch.where((v_new > thr) & (act < 0), float(t), act)
            t = t + dtw
            v_cur = v_new
            it_max = max(it_max, iters)
            it_sum += iters
            all_conv &= conv
        # one voltage-row write-back per chunk (Godunov: v_cur is the PDE result)
        states[vi].copy_(v_cur)
        self.activation_time = act
        self.cg_iterations += it_sum
        self.steps += n_steps
        probes = None
        if probed:
            probes = (act[self._probe_dofs] * self._probe_w).sum(dim=1)
        rnorm = torch.sqrt(rr) if rr is not None else torch.zeros((), dtype=self.dtype, device=self.device)
        return ChunkResult(float(t), it_max, it_sum, rnorm, all_conv, probes)

    # ------------------------------------------------------------------
    def stimulus_amplitudes(self) -> np.ndarray:
        """Live amplitude vector, read each chunk (``Stimulus.assign`` takes
        effect at the next chunk)."""
        amps = [float(stim.expr.amplitude) for _, _, stim in self._stim_quads]
        return np.asarray(amps or [0.0], dtype=self._np_dtype)

    @property
    def v(self) -> torch.Tensor:
        return self.states[self.v_index]

    def solve(
        self,
        interval: tuple[float, float],
        dt: float,
        save_freq: int | None = None,
        save_callback: Callable[[float, np.ndarray], None] | None = None,
    ) -> Status:
        """Run the time loop on (T0, T] in chunks of ``save_freq`` steps;
        ``save_callback(t, v_host)`` fires after each chunk.  Returns
        ``Status.NOT_CONVERGING`` if any step's CG stopped at ``ksp_max_it``
        without meeting its tolerance."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        t = self._np_dtype(T0)
        done = 0
        all_converged = True
        while done < n_total:
            n = min(chunk, n_total - done)
            res = self.run_chunk(t, dt, n)
            t = self._np_dtype(res.t)
            done += n
            all_converged &= res.converged
            rnorm = float(res.residual_norm)
            if not res.converged:
                logger.warning(
                    "CG did not converge within ksp_max_it during chunk ending "
                    "t=%g (last residual norm %.3e)", res.t, rnorm,
                )
            self.last_cg = CGInfo(res.iters_max, rnorm, res.converged)
            if self.monitor is not None:
                self.monitor.record_ksp(self.last_cg)
            if save_callback is not None:
                save_callback(res.t, np.array(self.v.cpu()))  # a copy, not a view of the stepped state
        self.last_solve_converged = all_converged
        return Status.OK if all_converged else Status.NOT_CONVERGING

    def activation_times(self) -> np.ndarray:
        return self.activation_time.cpu().numpy()

    # ------------------------------------------------------------------
    # full-state checkpoint / resume, in the JAX fused solver's npz format
    # (fenicsx_beat_tpu/fused.py:831-890)
    def save_state(self, path, t: float = 0.0) -> Path:
        """Write all ionic states, activation times and the time to one npz."""
        out = Path(path).with_suffix(".npz")
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out,
            states=self.states.cpu().numpy(),
            activation_time=self.activation_time.cpu().numpy(),
            t=float(t),
            v_index=self.v_index,
        )
        return out

    def load_state(self, path) -> float:
        """Restore a :meth:`save_state` checkpoint (from either package);
        returns its time."""
        with np.load(Path(path).with_suffix(".npz")) as f:
            states = f["states"]
            act = f["activation_time"]
            if states.shape != tuple(self.states.shape) or act.shape != (self._n,):
                raise ValueError(
                    f"checkpoint shape {states.shape} incompatible with solver "
                    f"({self.states.shape[0]} states, {self._n} nodes)"
                )
            if int(f["v_index"]) != int(self.v_index):
                raise ValueError(
                    f"checkpoint v_index {int(f['v_index'])} != solver "
                    f"{self.v_index} (different ionic model?)"
                )
            self.states = states_from_numpy(states, self.device, self.dtype)
            self.activation_time = torch.as_tensor(act, device=self.device).to(self.dtype)
            return float(f["t"])
