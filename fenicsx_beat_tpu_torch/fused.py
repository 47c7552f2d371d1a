"""Fused monodomain splitting solver — the port's main path.

Port of ``fenicsx_beat_tpu/fused.py``: the whole time loop — ionic
Rush-Larsen step, voltage exchange, theta-rule PCG solve, activation
tracking and probe readout — over device-resident state.  Where JAX
compiles a chunk into one ``lax.scan`` with a ``lax.while_loop`` PCG, the
port runs a Python loop over eager kernel launches: the PCG's exit test
is the only value that comes back to the host, once per iteration
(``iterations + 1`` host syncs per step, counted in
:attr:`FusedMonodomainSolver.host_syncs`).

The diffusion step is :class:`~.theta_system.ThetaSystem`, shared with
the object-oriented model (:class:`~.base_model.BaseModel`): on
structured meshes (the Niederer slab) a symmetric stencil operator and the
fused-kernel PCG, three device launches per iteration (B2·B4, B3 and B3's
second pass); on unstructured meshes (the LV ellipsoid) the operator pair
in one shared CSR layout and the generic Jacobi-PCG around the CSR SpMV
kernel B8, whose exit test ``sqrt(rr) > tol`` is JAX's ``cg``'s, so the
iteration counts match the JAX solver's.

The ionic model is TP06, ToR-ORd dynCl or ToR-ORd dynCl + Land, generalized
Rush-Larsen or forward Euler (V in row 0), FitzHugh-Nagumo forward Euler (V
in row 1), or either step of a model that ``odefile.load_ode`` generated (V
in its row), and the solver takes
its kernels from the model's entry in
:data:`~.ops.cuda_ode.IONIC_MODELS` (:func:`~.splitting.ionic_layer`,
shared with the bidomain solver): B1 for one parameter vector, B1's
per-node form for a node-aligned ``[NP, n]`` parameter field (2-D
``parameters``, as ``fenicsx_beat_tpu/fused.py:213-217`` routes it), or
B7 for marker-partitioned layers: a dict ``ode_fun`` with ``ode_markers``
composes through :func:`~.odesolver.make_multi_ode`, whose masks become
B7's per-node model index, one launch per model, each over the blocks
that hold its nodes where the markers mix models
(:func:`~.ops.cuda_ode.mixed_multi_step`); a marker whose parameters are a
node-aligned ``[NP, n]`` field steps its own nodes through B1's per-node
form (:func:`~.splitting.ionic_layer`).  Stimuli on cell or exterior-facet
measures: a TimeWindow's load assembled once, any other expression's each
step at the PDE theta point (one B8 product).  On the CPU every kernel runs as its plain
PyTorch twin, which is how the port is held against the JAX solver;
``use_kernels=False`` selects the twins on any device (the kernel check's
reference on the card); there is no silent switch between the two.

Splitting: any theta (1 Godunov, 0.5 Strang; the tentative ionic step
``theta*dt``, the corrective ``(1-theta)*dt`` skipped at theta=1) and
merged Strang (``merge_strang_halves=True`` with theta=0.5: per chunk
A(dt/2) [B(dt) A(dt)]^{n-1} B(dt) A(dt/2), ``n_steps + 1`` ionic launches
instead of ``2*n_steps``, activation sampled at the midpoints).  Scope of
this port: TP06, ToR-ORd dynCl, ToR-ORd dynCl + Land, FitzHugh-Nagumo and
generated models (one parameter vector, a per-node parameter field, or one
vector or field per marker, the markers' models mixed or not), P1.  Other
models raise ``NotImplementedError``.  The node axis is not padded.
``operator_cache_key`` opts the assembly into the operator disk cache
(:func:`~.fem.assemble_mass_stiffness_auto`).
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
from .ops.cg import CGInfo
from .splitting import check_ionic_scope, ionic_layer
from .telemetry import NullMonitor
from .theta_system import ThetaSystem, stimulus_loads

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
    ode_fun : the ionic step, ``generalized_rush_larsen`` or
        ``forward_euler`` of ``models.tentusscher_panfilov_2006``,
        ``models.torord_dyncl``, ``models.torord_dyncl_land`` or
        ``models.fitzhughnagumo`` (whose two are one step), or a dict
        marker -> one of those steps (multi-marker layers, of one model or
        several, with ``ode_markers``)
    init_states : (S,) or (S, n_nodes); a dict marker -> those with a dict ``ode_fun``
    parameters : the model's parameter vector (NP,), or a node-aligned
        (NP, n_nodes) field; a dict marker -> vector or field with a dict
        ``ode_fun``
    v_index : the model's voltage row in the state array (TP06 and
        ToR-ORd: 0, FHN: 1); a dict with a dict ``ode_fun``
    I_s : Stimulus | list[Stimulus] on cell or exterior-facet measures
        (TimeWindow or any expression ``f(x, t)``)
    theta : the splitting, 1.0 Godunov / 0.5 Strang / any other value
        (``monodomain_solver.py:94-113``)
    monitor : a :class:`~.telemetry.BaseMonitor`: each chunk runs in its
        ``fused_chunk`` section, then ``record_ksp`` (the chunk's largest
        CG count, last residual, convergence) and ``advance_step`` over the
        chunk's interval; the ``NullMonitor`` when None
    device, dtype : where the state lives: the card unless the CPU is
        named; float32 on CUDA, float64 on CPU by default (:mod:`.config`)
    use_kernels : False runs the plain PyTorch twins of the kernels
    ode_markers : per-node marker array (or an object with ``.x.array``)
    operator_cache_key : opts the operator assembly into the disk cache
        (the content of mesh, conductivity and dtype decides a hit)
    merge_strang_halves : with theta=0.5, merge each chunk's interior ionic
        half-steps into full steps (ignored with a warning at other theta)
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
    monitor: Any = None  # BaseMonitor; NullMonitor when None
    activation_threshold: float = 0.0
    probe_points: Any = None  # [np, gdim] physical probe coordinates
    device: Any = None
    dtype: Any = None
    use_kernels: bool = True
    ode_markers: Any = None
    operator_cache_key: str | None = None
    merge_strang_halves: bool = False

    def __post_init__(self):
        self._check_scope()
        self.monitor = self.monitor or NullMonitor()
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
        self._ionic_groups, self._ionic_fields, self._ode_step = layer.groups, layer.fields, layer.step
        self.init_states, self.v_index = layer.init_states, layer.v_index

        # operators: assembled in float64 on the host (stencil first, ELL
        # otherwise, fem.assemble_mass_stiffness_auto), the theta system on
        # the device
        M_cells = as_cell_tensors(self.M, self.mesh)
        mass, stiff = fem.assemble_mass_stiffness_auto(self.V, M_cells, cache_key=self.operator_cache_key)
        self._pde = ThetaSystem(mass, stiff, self.C_m, self.pde_theta, p["ksp_rtol"], p["ksp_atol"],
                                p["ksp_max_it"], dev, dt_, self.use_kernels)
        self._structured, self._pos = self._pde.structured, self._pde.pos

        # stimuli: TimeWindow loads assembled once on the host, general
        # expressions each step on the device
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

        self.cg_iterations = 0  # over every step
        self.steps = 0
        self.last_solve_converged = True
        self.last_cg: CGInfo | None = None  # the last chunk's CG statistics

    def _check_scope(self):
        self._ionic = check_ionic_scope(self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                                        self.v_index)
        self._merged = bool(self.merge_strang_halves) and bool(np.isclose(self.theta, 0.5))
        if self.merge_strang_halves and not self._merged:
            logger.warning("merge_strang_halves requires theta=0.5 (got %g); ignored", self.theta)

    # ------------------------------------------------------------------
    @property
    def host_syncs(self) -> int:
        """PCG exit tests read back to the host, over every step."""
        return self._pde.host_syncs

    @host_syncs.setter
    def host_syncs(self, value: int) -> None:
        self._pde.host_syncs = value

    def _operators(self, dt: float):
        """The theta-system operators of ``dt``
        (:meth:`~.theta_system.ThetaSystem.operators`)."""
        return self._pde.operators(dt)

    def _assemble_rhs(self, B, v_prev, t_stim, dt, amps):
        """b = B v_prev + the stimulus loads at ``t_stim``: each TimeWindow's
        where its window holds it (inclusive at both ends, compared in the
        working dtype), each general expression's assembled at it."""
        return self._pde.rhs(B, v_prev, self._stim_terms, self._b_units, t_stim, dt, amps)

    def _pde_solve(self, ops, v_prev, x0, t_stim, dt, amps):
        """PCG for the step's system from ``x0``; returns ``(x, iterations,
        rr, converged)`` (:meth:`~.theta_system.ThetaSystem.solve`)."""
        b = self._assemble_rhs(ops[1], v_prev, t_stim, dt, amps)
        return self._pde.solve(ops, b, x0)

    def run_chunk(self, t0, dt: float, n_steps: int, amps=None, probed: bool = False) -> ChunkResult:
        """Advance ``n_steps`` steps of ``dt`` from time ``t0``, updating
        :attr:`states` and :attr:`activation_time` (``fused.py:604-693``).
        Each step: the tentative ionic step of ``theta*dt``, the PDE step,
        the corrective ionic step of ``(1-theta)*dt`` at ``t + theta*dt``
        (none at theta=1), the activation stamp ``t``.  Merged Strang: the
        tentative step is ``dt/2`` at k = 0 and ``dt`` after, no corrective
        step, the activation sampled at the midpoint of the carried and the
        stepped voltage and stamped ``t - dt`` for k > 0, and one trailing
        ``dt/2`` step with its own stamp closes the chunk (``n_steps + 1``
        ionic launches).  The steps run in the monitor's ``fused_chunk``
        section; then the monitor records the chunk's CG statistics and
        advances over ``(t0, t)``, as the JAX solver's ``solve`` does per
        chunk."""
        w = self._np_dtype
        amps = self.stimulus_amplitudes() if amps is None else amps
        dtw = w(dt)
        dt_f = float(dtw)
        theta = float(self.theta)
        merged = self._merged
        corrective = not merged and not np.isclose(theta, 1.0)
        tent_dt = float(w(theta) * dtw)
        corr_dt = float(w(1.0 - theta) * dtw)
        half_dt = float(w(0.5) * dtw)
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
        with self.monitor.track_time("fused_chunk"):
            for k in range(n_steps):
                # tentative ODE step (monodomain_solver.py:68), PDE voltage
                # injected; merged: A(dt/2) opens the chunk, A(dt) after
                self._ode_step(states, v_cur, float(t), (half_dt if k == 0 else dt_f) if merged else tent_dt)
                v = states[vi]
                if merged and k > 0:
                    # the previous step's Strang sample A(dt/2): the voltage
                    # row advances by forward Euler, so it is the midpoint
                    v_mid = 0.5 * (v_cur + v)
                    act = torch.where((v_mid > thr) & (act < 0), float(t - dtw), act)
                # PDE theta-step; stimulus at the PDE theta point; CG warm-started
                # from the previous step's increment
                t_stim = t + w(self.pde_theta) * dtw
                v_new, iters, rr, conv = self._pde_solve(ops, v, v + dv, t_stim, dt_f, amps)
                dv = v_new - v
                if corrective:
                    # corrective ODE step (Strang, monodomain_solver.py:99-113)
                    self._ode_step(states, v_new, float(t + w(theta) * dtw), corr_dt)
                    v_new = states[vi]
                if not merged:
                    act = torch.where((v_new > thr) & (act < 0), float(t), act)
                t = t + dtw
                v_cur = v_new
                it_max = max(it_max, iters)
                it_sum += iters
                all_conv &= conv
            if merged and n_steps:
                # the trailing A(dt/2) closes the chunk's Strang composition
                self._ode_step(states, v_cur, float(t), half_dt)
                v_cur = states[vi]
                act = torch.where((v_cur > thr) & (act < 0), float(t - dtw), act)
            # one voltage-row write-back per chunk (Godunov: v_cur is the PDE result)
            states[vi].copy_(v_cur)
        self.activation_time = act
        self.cg_iterations += it_sum
        self.steps += n_steps
        probes = None
        if probed:
            probes = (act[self._probe_dofs] * self._probe_w).sum(dim=1)
        rnorm = torch.sqrt(rr) if rr is not None else torch.zeros((), dtype=self.dtype, device=self.device)
        self.monitor.record_ksp(CGInfo(it_max, rnorm, all_conv))
        self.monitor.advance_step(float(t0), float(t))
        return ChunkResult(float(t), it_max, it_sum, rnorm, all_conv, probes)

    # ------------------------------------------------------------------
    def stimulus_amplitudes(self) -> np.ndarray:
        """Live amplitude vector, read each chunk (``Stimulus.assign`` takes
        effect at the next chunk); 1.0 for a general expression, whose
        value is its own."""
        amps = [float(stim.expr.amplitude) if stim is not None else 1.0 for _, _, stim in self._stim_quads]
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
        """Run the time loop on (T0, T] in chunks of ``save_freq`` steps
        (:meth:`run_chunk`, each reported to the monitor);
        ``save_callback(t, v_host)`` fires after each chunk.  Returns
        ``Status.NOT_CONVERGING`` if any step's CG stopped at ``ksp_max_it``
        without meeting its tolerance.

        The chunks are the JAX solver's (``fenicsx_beat_tpu/fused.py:762-823``):
        ``round((T - T0) / dt)`` steps cut into chunks of ``save_freq`` (one
        chunk when None), the last one shorter, the time carried between
        chunks in the working dtype.  A merged Strang run depends on its
        chunking (each chunk opens and closes with a half step), so equal
        chunks are what make it JAX's."""
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
