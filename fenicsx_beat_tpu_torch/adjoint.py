"""Differentiable monodomain and bidomain simulation on torch autograd.

Port of ``fenicsx_beat_tpu/adjoint.py``.  The splitting step is plain
torch, so ``torch.autograd`` differentiates voltage-trace losses with
respect to

* conductivity scalings (``K(g) = sum_i g_i K_i`` of pre-assembled unit
  stiffness operators: an isotropic scale, per-region scales, or
  fiber/transverse components),
* the ionic model's ``parameters`` vector (a tensor with
  ``requires_grad``: :func:`.models._common.unpack_params` keeps it in the
  graph),
* stimulus amplitudes (``TimeWindow`` windows, ``RandomActivation``
  patterns and facet ``ds`` stimuli).

The CG loop is not differentiated through: :func:`cg_implicit` solves
``A x = b`` without a graph and joins ``x`` to it by implicit
differentiation, as ``lax.custom_linear_solve`` does in JAX.  The backward
pass solves the same SPD system for the cotangent, and the operator's
parameters receive ``-lambda^T (dA/dtheta) x`` through ONE product of the
operator with the detached ``x`` under autograd, once per solve and not
once per CG iteration.  Memory over long horizons is bounded by
``torch.utils.checkpoint`` on every step (non-reentrant, so tensors the
step closes over, the combined operators, receive their gradients), and
optionally on segments of steps.

On unstructured meshes on the card the operators go through B8
(``csrc/csr_spmv.cu``) behind :class:`LaneCombo`'s autograd Function: the
forward is one B8 launch on the value-combined matrix, the backward is B8
again by symmetry plus one B8 product per component for the weights (the
JAX package's ``_lane_combo_factory``, ``adjoint.py:156-199``).  On CPU
tensors, and off the lane path on every device, the same Function runs
B8's twin: plain torch, a fixed-order segment sum with no float atomics.
Structured meshes keep the stencil's own product
(``StencilMatrix.__matmul__``), as the JAX package computes them outside
any Pallas kernel on this path.

Typical use::

    sim = build_diff_simulator(mesh, ode_fun=fhn.forward_euler, ...,
                               probe_points=pts, dt=0.1, n_steps=300)
    g = torch.tensor(0.002, dtype=torch.float64, requires_grad=True)
    loss = ((sim({"g": g, "ionic": ionic}) - observed) ** 2).mean()
    loss.backward()                     # g.grad
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import fem
from .config import default_dtype, resolve_device
from .ops.cg import cg_solve
from .ops.cuda_ell import CSRMatrix, csr_spmv, csr_spmv_twin
from .ops.sparse import StencilMatrix
from .stimulation import TimeWindow

__all__ = [
    "CGCounts",
    "LaneCombo",
    "cg_implicit",
    "build_diff_simulator",
    "build_diff_bidomain_simulator",
    "host_segmented_value_and_grad",
]


@dataclass
class CGCounts:
    """What the implicit solves of one simulator did: forward solves (the
    checkpoint's recomputations included) and adjoint solves, their CG
    iterations, and the host reads of CG's exit test (one per test:
    ``iterations + 1`` a solve, ``maxiter`` where it stops there)."""

    forward_solves: int = 0
    forward_iterations: int = 0
    adjoint_solves: int = 0
    adjoint_iterations: int = 0
    host_syncs: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def record(self, adjoint: bool, iterations: int, maxiter: int) -> None:
        if adjoint:
            self.adjoint_solves += 1
            self.adjoint_iterations += iterations
        else:
            self.forward_solves += 1
            self.forward_iterations += iterations
        self.host_syncs += iterations + (1 if iterations < maxiter else 0)


def _max_abs(r: torch.Tensor) -> torch.Tensor:
    return r.abs().max()


class _Implicit(torch.autograd.Function):
    """Joins ``x``, a solution of ``A x = b`` computed without a graph, to
    the graph.  ``b`` receives ``lambda = A^{-1} xbar`` and ``ax = A x``
    (the operator applied to the detached ``x`` under autograd) receives
    ``-lambda``, which autograd carries on to the operator's parameters:
    ``-lambda^T (dA/dtheta) x``.  A is symmetric, so the adjoint system is
    the forward one."""

    @staticmethod
    def forward(ctx, x, b, ax, adjoint_solve):
        ctx.adjoint_solve = adjoint_solve
        return x.clone()

    @staticmethod
    def backward(ctx, xbar):
        lam = ctx.adjoint_solve(xbar.contiguous())
        db = lam if ctx.needs_input_grad[1] else None
        dax = -lam if ctx.needs_input_grad[2] else None
        return None, db, dax, None


def cg_implicit(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    precond_diag: torch.Tensor | None = None,
    rtol: float = 1e-10,
    atol_scaled: float = 1e-12,
    maxiter: int = 1000,
    atol: float | None = None,
    dot: Callable | None = None,
    max_abs: Callable | None = None,
    counts: CGCounts | None = None,
) -> torch.Tensor:
    """Differentiable SPD solve ``x = A^{-1} b``.

    The forward pass is :func:`.ops.cg.cg_solve` (Jacobi PCG) without a
    graph; the backward pass solves the SAME system with the same CG for
    the cotangent (:class:`_Implicit`).  Gradients reach ``b`` and every
    tensor ``matvec`` closes over that requires grad (operator values, so
    conductivity parameters differentiate): where grad is enabled, ``x``
    joins the graph through one ``matvec(x.detach())`` under autograd.
    ``x0`` and ``precond_diag`` only affect convergence and carry no
    gradient.

    The adjoint solve starts from ZEROS, not ``x0``: the primal warm start
    says nothing about the cotangent system, and a zero start keeps the
    solve exactly equivariant under power-of-two scaling of its right-hand
    side, which ``host_segmented_value_and_grad(cotangent_scale=...)``
    relies on.

    Both solves NORMALIZE the right-hand side by its Chebyshev norm and
    rescale the solution: CG's inner products square the operand scale, so
    a float32 adjoint seed of ~1e-22 (a ``2**-64`` cotangent scale) would
    give ``||b||^2`` flushed to zero and an instantly "converged", exactly
    zero gradient.  The max-norm involves no squaring and dividing by it is
    exact for power-of-two scales.  The absolute tolerance therefore
    applies to the normalized system, relative to ``max|b|``; hence its
    name ``atol_scaled``.  ``atol`` is a deprecated alias.

    ``dot`` / ``max_abs`` override the inner product and the normalization
    norm.  ``counts`` (a :class:`CGCounts`) receives each solve's
    iterations."""
    if atol is not None:
        warnings.warn(
            "cg_implicit(atol=...) is deprecated: since the RHS is "
            "normalized by max|b|, the tolerance is relative to max|b|, "
            "not absolute — pass atol_scaled=... instead",
            DeprecationWarning,
            stacklevel=2,
        )
        atol_scaled = atol
    _max = max_abs if max_abs is not None else _max_abs
    diag = None if precond_diag is None else precond_diag.detach()

    def solve(rhs: torch.Tensor, guess: torch.Tensor | None, adjoint: bool) -> torch.Tensor:
        with torch.no_grad():
            nb = _max(rhs)
            nb = torch.where((nb > 0) & torch.isfinite(nb), nb, torch.ones_like(nb))
            x, k, _rr, _tol = cg_solve(
                matvec, rhs / nb, None if guess is None else guess / nb, precond_diag=diag,
                rtol=rtol, atol=atol_scaled, maxiter=maxiter, dot=dot,
            )
        if counts is not None:
            counts.record(adjoint, k, maxiter)
        return x * nb

    x = solve(b.detach(), None if x0 is None else x0.detach(), False)
    if not torch.is_grad_enabled():
        return x
    ax = matvec(x)
    if not (b.requires_grad or ax.requires_grad):
        return x
    return _Implicit.apply(x, b, ax, lambda xbar: solve(xbar, None, True))


# ---------------------------------------------------------------------------
# Operators


class _ComboSpMV(torch.autograd.Function):
    """``y = (sum_i w_i K_i) x`` on one product; its backward is the same
    product again: ``dx = K(w) ybar`` (every ``K_i`` is symmetric) and
    ``dw_i = ybar . (K_i x)``, one product per component, each only where
    asked for."""

    @staticmethod
    def forward(ctx, w, x, combo, A_w):
        ctx.combo, ctx.A_w = combo, A_w
        ctx.save_for_backward(x)
        return combo.product(A_w, x)

    @staticmethod
    def backward(ctx, yb):
        (x,) = ctx.saved_tensors
        dw, dx = ctx.combo.vjp(x, yb, ctx.A_w, need_w=ctx.needs_input_grad[0], need_x=ctx.needs_input_grad[1])
        return dw, dx, None, None


class LaneCombo:
    """Operators of one sparsity pattern (mass and stiffness components)
    packed as ONE CSR layout (``CSRMatrix.from_operator_group``), so a
    weighted combination is a combination of values: the port's form of
    the JAX package's lane-gather combination (``_lane_combo_factory``).
    :meth:`mv` is differentiable in the weights and in ``x``.  Its products
    are B8 launches on CUDA tensors; B8's twin (plain torch, a fixed-order
    segment sum, no float atomics) on CPU tensors, and on every device with
    ``use_kernels=False``."""

    backward_launches = 0

    def __init__(self, parts: tuple[CSRMatrix, ...], use_kernels: bool = True):
        self.parts = parts
        self.use_kernels = use_kernels
        self.vals = torch.stack([P.vals for P in parts])  # [nc, nnz]
        self.diags = torch.stack([P.diag for P in parts])  # [nc, n]

    @classmethod
    def pack(cls, ops, device, dtype, use_kernels: bool = True) -> "LaneCombo":
        return cls(tuple(P.to(device, dtype) for P in CSRMatrix.from_operator_group(ops)), use_kernels)

    def product(self, A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
        return csr_spmv(A, x) if self.use_kernels else csr_spmv_twin(A, x)

    def matrix(self, w: torch.Tensor) -> CSRMatrix:
        """``sum_i w_i K_i`` as a CSRMatrix (no graph), sharing the pattern
        and its list of long rows."""
        w = w.detach()
        A = copy.copy(self.parts[0])
        A.vals = torch.tensordot(w, self.vals, dims=1)
        A.diag = torch.tensordot(w, self.diags, dims=1)
        return A

    def diag(self, w: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(w.detach(), self.diags, dims=1)

    def vjp(self, x: torch.Tensor, yb: torch.Tensor, A_w: CSRMatrix, need_w: bool = True, need_x: bool = True):
        """The backward of :meth:`mv`: ``(dw, dx)`` for the cotangent ``yb``
        at ``x``, ``dx = A_w yb`` and ``dw_i = yb . (K_i x)`` (each ``K_i``
        is symmetric).  :attr:`backward_launches` counts the B8 launches
        made here (the wrapper's own count, read around them)."""
        n0 = csr_spmv.launches
        yb = yb.contiguous()
        dx = self.product(A_w, yb) if need_x else None
        dw = torch.stack([torch.dot(yb, self.product(K, x)) for K in self.parts]) if need_w else None
        LaneCombo.backward_launches += csr_spmv.launches - n0
        return dw, dx

    def mv(self, w: torch.Tensor, x: torch.Tensor, A_w: CSRMatrix | None = None) -> torch.Tensor:
        """``(sum_i w_i K_i) x``; ``A_w`` is :meth:`matrix` of ``w``, made
        once by a caller that applies the same combination many times."""
        return _ComboSpMV.apply(w, x.contiguous(), self, A_w if A_w is not None else self.matrix(w))


class _StencilCombo:
    """Stencil operators of one offset set as a value stack, the structured
    meshes' counterpart of :class:`LaneCombo`: :meth:`matrix` is a
    :class:`~.ops.sparse.StencilMatrix` whose values carry the weights'
    graph, and :meth:`mv` its own product, which autograd differentiates
    (shifted multiply-adds both ways, no float atomics)."""

    def __init__(self, ops, device, dtype):
        self.offsets, self.shape = ops[0].offsets, ops[0].shape
        self.vals = torch.stack([A.vals for A in ops]).to(device=device, dtype=dtype)  # [nc, n, K]

    def matrix(self, w: torch.Tensor) -> StencilMatrix:
        return StencilMatrix(offsets=self.offsets, vals=torch.tensordot(w, self.vals, dims=1), shape=self.shape)

    def diag(self, w: torch.Tensor) -> torch.Tensor:
        return self.matrix(w.detach()).diagonal()

    def mv(self, w: torch.Tensor, x: torch.Tensor, A_w: StencilMatrix | None = None) -> torch.Tensor:
        return (A_w if A_w is not None else self.matrix(w)) @ x


def _stack_components(V, spec_groups, device, dtype, use_kernels: bool = False):
    """The mass operator and the stiffness components of every group of
    conductivity specs, assembled with unit scaling into one combination:
    a :class:`_StencilCombo` on a structured mesh, a :class:`LaneCombo`
    otherwise (``use_kernels``: its products on B8).  Its operators are
    ``(mass, *group_0, *group_1, ...)``."""
    ops, mass = [], None
    for specs in spec_groups:
        for spec in specs:
            mass, k_i = fem.assemble_mass_stiffness_auto(V, spec)
            ops.append(k_i)
    ops = [mass, *ops]
    if all(isinstance(A, StencilMatrix) for A in ops):
        if any(A.offsets != mass.offsets for A in ops):
            raise ValueError("stiffness components must share the mass pattern")
        return _StencilCombo(ops, device, dtype)
    if any(isinstance(A, StencilMatrix) for A in ops):
        raise ValueError("stiffness components must share the mass pattern")
    return LaneCombo.pack(ops, device, dtype, use_kernels)


def _weights(*parts, device, dtype) -> torch.Tensor:
    """One combination's weights, ``(mass, *components)`` in order: Python
    numbers and tensors (their graph kept) alike."""
    return torch.cat([_param(p, device, dtype) for p in parts])


# ---------------------------------------------------------------------------
# Stimulus, probes, the checkpointed loop


def _np_type(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _stimulus_setup(V, I_s, quadrature_degree, device, dtype, n):
    """Differentiable stimulus tables shared by the mono/bidomain diff
    simulators.

    TimeWindow protocols keep the separable fast path (one precomputed
    unit load each; the amplitude is the differentiable knob and the
    window is read on the host from the step's time); every other
    expression (RandomActivation patterns, space-time callables) is
    assembled each step from its quadrature tables
    (:meth:`.fem.CellQuadData.assemble_load`), its amplitude factored out
    where it carries one.  Cell and facet (``ds``) measures alike.

    Returns ``(default_amps, n_slots, b_stim)`` with ``b_stim(t, amps,
    scale)`` the assembled load ``[n]``, or None where nothing is on."""
    npt = _np_type(dtype)
    if I_s is None:
        stimuli = []
    elif hasattr(I_s, "expr"):  # a single Stimulus (itself a tuple subclass)
        stimuli = [I_s]
    else:
        stimuli = list(I_s)
    loads, windows, win_slots = [], [], []
    general = []  # (quad, unit expression, slot)
    for slot, s in enumerate(stimuli):
        ents = s.dz.entities()
        if s.dz.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        else:
            quad = fem.facet_quadrature(V, ents, degree=quadrature_degree, dtype=np.float64)
        if isinstance(s.expr, TimeWindow):
            loads.append(torch.as_tensor(np.asarray(quad.assemble_load_host()), device=device).to(dtype))
            windows.append((float(s.expr.start), float(s.expr.duration)))
            win_slots.append(slot)
            continue
        expr = s.expr
        if hasattr(expr, "amplitude") and dataclasses.is_dataclass(expr):
            # the unit pattern; the amplitude rides the params slot
            expr = dataclasses.replace(expr, amplitude=1.0)
        elif not callable(expr):
            val = float(expr)
            expr = lambda x, t, _v=val: _v * torch.ones_like(x[0])  # noqa: E731
        general.append((quad, expr, slot))
    default_amps = [float(s.expr.amplitude) if hasattr(s.expr, "amplitude") else 1.0 for s in stimuli] or [0.0]
    win_start = np.asarray([w[0] for w in windows], dtype=npt)
    win_end = win_start + np.asarray([w[1] for w in windows], dtype=npt)

    def b_stim(t: float, amps: torch.Tensor, scale: float):
        # inclusive window end, as TimeWindow.indicator and the fused
        # solver; t is not differentiated (window edges are zero-measure)
        tt = npt(t)
        b = None
        for j in np.nonzero((tt >= win_start) & (tt <= win_end))[0]:
            term = amps[win_slots[j]] * loads[j]
            b = term if b is None else b + term
        if b is not None:
            b = scale * b
        for quad, expr, slot in general:
            term = scale * amps[slot] * quad.assemble_load(expr, t, device=device, dtype=dtype)
            b = term if b is None else b + term
        return b

    return default_amps, max(len(stimuli), 1), b_stim


def _time_add(npt, t: float, d: float) -> float:
    """``t + d`` in the simulation's float type, as the JAX package traces it."""
    return float(npt(t) + npt(d))


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _tree_map(fn, tree, *rest):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def _stack_traces(traces: list):
    if isinstance(traces[0], (tuple, list)):
        return tuple(_stack_traces([tr[i] for tr in traces]) for i in range(len(traces[0])))
    return torch.stack(traces)


def _checkpointed_scan(step, init, ts: list[float], checkpoint_segments):
    """The step loop, each step ``torch.utils.checkpoint``-ed (non-reentrant:
    the tensors a step closes over receive their gradients), optionally
    nested into ``K = checkpoint_segments`` checkpointed segments of ``m =
    n_steps / K`` steps (two-level treeverse: peak carry memory ``(K + m)
    * carry_bytes`` instead of ``n_steps * carry_bytes``, at one extra
    forward recomputation of each segment)."""
    n_steps = len(ts)

    def run(carry, ts_seg):
        outs = []
        for t in ts_seg:
            carry, out = checkpoint(step, carry, t, use_reentrant=False, preserve_rng_state=False)
            outs.append(out)
        return carry, outs

    if checkpoint_segments and checkpoint_segments > 1:
        K = int(checkpoint_segments)
        if n_steps % K:
            raise ValueError(f"checkpoint_segments={K} must divide n_steps={n_steps}")
        m = n_steps // K
        carry, outs = init, []
        for k in range(K):
            carry, seg = checkpoint(run, carry, ts[k * m : (k + 1) * m], use_reentrant=False,
                                    preserve_rng_state=False)
            outs.extend(seg)
    else:
        carry, outs = run(init, ts)
    return carry, _stack_traces(outs)


def _times(t0, n_steps: int, dt: float, npt) -> list[float]:
    """``t0 + k dt`` in the simulation's float type, as Python floats."""
    return (npt(float(t0)) + np.arange(n_steps, dtype=npt) * npt(dt)).astype(np.float64).tolist()


def _set_row(states: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    return torch.cat([states[:i], v[None], states[i + 1 :]])


def _param(value, device, dtype) -> torch.Tensor:
    """A params entry as a 1-D tensor (graph kept); Python numbers and
    sequences are read as float64 first, never as torch's default float32."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value, dtype=np.float64), device=device)
    return torch.atleast_1d(value.to(device=device, dtype=dtype))


def _probe_tables(V, points, device, dtype):
    dofs, w = fem.point_evaluation_tables(V, np.asarray(points))
    return (torch.as_tensor(np.asarray(dofs, dtype=np.int64), device=device),
            torch.as_tensor(np.asarray(w, dtype=np.float64), device=device).to(dtype))


# ---------------------------------------------------------------------------
# Simulators


def build_diff_simulator(
    mesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    dt: float,
    n_steps: int,
    electrode_points=None,
    sigma_b: float = 1.0,
    theta: float = 1.0,
    pde_theta: float = 1.0,
    C_m: float = 1.0,
    chi: float = 1.0,
    stiffness_components=None,
    quadrature_degree: int = 4,
    cg_rtol: float = 1e-10,
    cg_atol: float = 1e-12,
    cg_maxiter: int = 1000,
    dtype=None,
    checkpoint_segments: int | None = None,
    use_lane_ops: bool | None = None,
    device=None,
) -> Callable[[dict], torch.Tensor]:
    """Build ``simulate(params) -> probe voltages [n_steps, n_probes]``.

    With ``electrode_points``, ``simulate`` returns ``{"probes": [n_steps,
    n_probes], "ecg": [n_steps, n_electrodes]}``: each step also recovers
    ``Im = -(1/C_m) Mass^{-1} K(g) v`` through a second implicit solve and
    evaluates the pseudo-ECG electrode potentials
    (:func:`.ecg.electrode_weight_matrix`).

    ``params`` keys (all optional, all differentiable):

    * ``"g"``: conductivity scaling, a scalar (the unit isotropic
      stiffness) or a vector ``[len(stiffness_components)]``.
    * ``"ionic"``: the ionic model's ``parameters`` vector.
    * ``"stim_amplitude"``: stimulus amplitude(s), scalar or
      ``[n_stimuli]``.

    ``stiffness_components``: conductivity specs (each accepted by
    :func:`.fem.assemble_mass_stiffness_auto`), assembled once with unit
    scaling and combined as ``K(g) = sum_i g_i K_i``; default one
    isotropic unit component.

    Splitting is the reference's theta choreography (``theta=1`` Godunov,
    ``theta=0.5`` Strang); the PDE stage is the ``pde_theta`` rule.  Every
    step is checkpointed; ``checkpoint_segments = K`` nests the loop into K
    checkpointed segments (K must divide ``n_steps``).

    ``use_lane_ops``: the unstructured operators through
    :class:`LaneCombo` (B8 and its backward).  None means: on a CUDA
    device, for an unstructured (ELL) mesh of at least 4096 nodes.  Asking
    for it on a structured mesh raises, and so does asking for it with
    float64 on the card (B8 takes float32).  False runs B8's twin through
    the same Function.

    ``device``: the card unless the CPU is named; ``dtype`` None is the
    device's working type (float32 on the card, float64 on the CPU).
    ``cg_atol`` is relative to ``max|b|`` of each solve (see
    :func:`cg_implicit`).  The returned function carries ``cg_counts``, a
    :class:`CGCounts` over every solve it made, ``operators``, its
    :class:`LaneCombo` (or a structured mesh's stencil stack), and
    ``lane_combo``, the same :class:`LaneCombo` on the lane path and None
    off it."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    npt = _np_type(dtype)
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    specs = stiffness_components if stiffness_components is not None else [1.0]
    ops = _stack_components(V, [specs], dev, dtype)
    structured = isinstance(ops, _StencilCombo)
    if use_lane_ops is None:
        use_lane_ops = dev.type == "cuda" and not structured and n >= 4096
    if use_lane_ops and structured:
        raise ValueError("use_lane_ops requires an unstructured (ELL) mesh")
    if use_lane_ops and dev.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"use_lane_ops on the card takes float32 (B8), got {dtype}")
    if not structured:
        ops.use_kernels = bool(use_lane_ops)

    default_amps, n_slots, b_stim_tables = _stimulus_setup(V, I_s, quadrature_degree, dev, dtype, n)
    probe_dofs, probe_w = _probe_tables(V, probe_points, dev, dtype)

    W_e = None
    if electrode_points is not None:
        from .ecg import electrode_weight_matrix

        W_e = electrode_weight_matrix(V, np.asarray(electrode_points), sigma_b=sigma_b, device=dev, dtype=dtype)

    states0 = torch.as_tensor(np.asarray(init_states, dtype=np.float64), device=dev).to(dtype)
    if states0.ndim == 1:
        states0 = states0[:, None].repeat(1, n)

    th = float(pde_theta)
    dt_f = float(dt)
    strang = abs(theta - 0.5) < 1e-12
    counts = CGCounts()

    def simulate(params: dict, *, states0_in=None, t0=0.0, return_final: bool = False):
        gvec = _param(params.get("g", 1.0), dev, dtype)
        ionic = params.get("ionic", None)
        amps = torch.broadcast_to(_param(params.get("stim_amplitude", default_amps), dev, dtype), (n_slots,))
        w_a = _weights(chi * C_m, th * dt_f * gvec, device=dev, dtype=dtype)
        w_k = _weights(0.0, gvec, device=dev, dtype=dtype)
        w_m = _weights(1.0, torch.zeros_like(gvec), device=dev, dtype=dtype)
        A_c, K_c, M_c = ops.matrix(w_a), ops.matrix(w_k), ops.matrix(w_m)

        def Amv(u):
            return ops.mv(w_a, u, A_c)

        def Mmv(u):
            return ops.mv(w_m, u, M_c)

        def Kmv(u):
            return ops.mv(w_k, u, K_c)

        diagA = ops.diag(w_a)
        diagM = ops.diag(w_m) if W_e is not None else None

        def ionic_step(states, t, sub_dt):
            return ode_fun(states, t, ionic, sub_dt)

        def pde_step(v, t):
            # stimulus at the PDE theta point, as the production solvers
            rhs = chi * C_m * Mmv(v)
            if th != 1.0:
                rhs = rhs - (1.0 - th) * dt_f * Kmv(v)
            b = b_stim_tables(_time_add(npt, t, th * dt_f), amps, chi)
            if b is not None:
                rhs = rhs + dt_f * b
            return cg_implicit(Amv, rhs, x0=v, precond_diag=diagA, rtol=cg_rtol, atol_scaled=cg_atol,
                               maxiter=cg_maxiter, counts=counts)

        def step(states, t):
            # the reference's splitting choreography (monodomain_solver.py:53-116)
            if strang:
                states = ionic_step(states, t, 0.5 * dt_f)
                states = _set_row(states, v_index, pde_step(states[v_index], t))
                states = ionic_step(states, _time_add(npt, t, 0.5 * dt_f), 0.5 * dt_f)
            else:
                states = ionic_step(states, t, dt_f)
                states = _set_row(states, v_index, pde_step(states[v_index], t))
            vv = states[v_index]
            probe_v = (vv[probe_dofs] * probe_w).sum(dim=1)
            if W_e is None:
                return states, probe_v
            # pseudo-ECG: Im = -(1/C_m) Mass^{-1} K(g) v, phi = W Im
            im = cg_implicit(Mmv, Kmv(vv), precond_diag=diagM, rtol=cg_rtol, atol_scaled=cg_atol,
                             maxiter=cg_maxiter, counts=counts) * (-1.0 / C_m)
            return states, (probe_v, W_e @ im)

        init = states0 if states0_in is None else states0_in
        final, traces = _checkpointed_scan(step, init, _times(t0, n_steps, dt_f, npt), checkpoint_segments)
        out = traces if W_e is None else {"probes": traces[0], "ecg": traces[1]}
        if return_final:
            return out, final
        return out

    simulate.cg_counts = counts
    simulate.operators = ops
    simulate.lane_combo = ops if use_lane_ops else None
    return simulate


def build_diff_bidomain_simulator(
    mesh,
    *,
    ode_fun: Callable,
    init_states: np.ndarray,
    v_index: int,
    I_s=None,
    probe_points,
    u_probe_points=None,
    dt: float,
    n_steps: int,
    theta: float = 1.0,
    pde_theta: float = 0.5,
    C_m: float = 1.0,
    intra_components=None,
    extra_components=None,
    quadrature_degree: int = 4,
    cg_rtol: float = 1e-10,
    cg_atol: float = 1e-12,
    cg_maxiter: int = 1000,
    dtype=None,
    checkpoint_segments: int | None = None,
    device=None,
) -> Callable[[dict], torch.Tensor]:
    """Differentiable BIDOMAIN simulation: the two-potential counterpart of
    :func:`build_diff_simulator`, with :class:`~.bidomain.BidomainSolver`'s
    block discretization, mean deflation and splitting theta.

    ``simulate(params) -> v probe traces [n_steps, n_probes]``, or, with
    ``u_probe_points``, ``{"v": ..., "u_e": [n_steps, n_u_probes]}``
    (``u_e`` grounded to zero mesh mean each step, the solver's
    convention).  ``params``: ``"gi"`` / ``"ge"`` (scalars on the unit
    isotropic stiffness, or vectors combining ``intra_components`` /
    ``extra_components``), ``"ionic"`` and ``"stim_amplitude"``, all
    differentiable.

    The block operator is symmetric positive SEMIdefinite (the constant
    u_e nullspace), handled by the deflation: the projection is linear and
    symmetric, so the adjoint solve reuses it unchanged.  The simulator
    keeps the ``states0_in`` / ``t0`` / ``return_final`` contract with the
    carry ``(states, u_e)``, so :func:`host_segmented_value_and_grad`
    covers bidomain fits too.  Operators are plain torch, as in the JAX
    package: the stencil's own product, or B8's twin through
    :class:`LaneCombo`."""
    if not 0.0 < theta <= 1.0:
        raise ValueError(f"splitting theta must lie in (0, 1], got {theta}")
    if not 0.0 < pde_theta <= 1.0:
        raise ValueError(f"pde_theta must lie in (0, 1], got {pde_theta}")
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    npt = _np_type(dtype)
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs

    intra = intra_components if intra_components is not None else [1.0]
    extra = extra_components if extra_components is not None else [1.0]
    ops = _stack_components(V, [intra, extra], dev, dtype)

    default_amps, n_slots, b_stim_tables = _stimulus_setup(V, I_s, quadrature_degree, dev, dtype, n)
    probe_dofs, probe_w = _probe_tables(V, probe_points, dev, dtype)
    u_dofs = u_w = None
    if u_probe_points is not None:
        u_dofs, u_w = _probe_tables(V, u_probe_points, dev, dtype)

    states0 = torch.as_tensor(np.asarray(init_states, dtype=np.float64), device=dev).to(dtype)
    if states0.ndim == 1:
        states0 = states0[:, None].repeat(1, n)
    u0 = torch.zeros(n, dtype=dtype, device=dev)

    th = float(pde_theta)
    th_s = float(theta)
    godunov = abs(th_s - 1.0) < 1e-12
    dt_f = float(dt)
    counts = CGCounts()

    def deflate(x):
        # remove the constant-u_e nullspace component (the solver's float32
        # lesson: rounding feeds the nullspace); linear and symmetric, so
        # exactly the operator the implicit solve differentiates
        return torch.stack([x[0], x[1] - torch.mean(x[1])])

    def simulate(params: dict, *, states0_in=None, t0=0.0, return_final: bool = False):
        ionic = params.get("ionic", None)
        amps = torch.broadcast_to(_param(params.get("stim_amplitude", default_amps), dev, dtype), (n_slots,))
        gi, ge = _param(params.get("gi", 1.0), dev, dtype), _param(params.get("ge", 1.0), dev, dtype)
        zi = torch.zeros(len(intra), dtype=dtype, device=dev)
        ze = torch.zeros(len(extra), dtype=dtype, device=dev)
        w_a = _weights(C_m, th * dt_f * gi, ze, device=dev, dtype=dtype)
        w_i = _weights(0.0, gi, ze, device=dev, dtype=dtype)
        w_ie = _weights(0.0, gi, ge, device=dev, dtype=dtype)
        w_m = _weights(1.0, zi, ze, device=dev, dtype=dtype)
        A, Ki, Kie, M = ops.matrix(w_a), ops.matrix(w_i), ops.matrix(w_ie), ops.matrix(w_m)
        diag = torch.stack([ops.diag(w_a), (dt_f / th) * ops.diag(w_ie)])

        def Amv(u):
            return ops.mv(w_a, u, A)

        def Kimv(u):
            return ops.mv(w_i, u, Ki)

        def Kiemv(u):
            return ops.mv(w_ie, u, Kie)

        def block_matvec(x):
            x = deflate(x)
            xv, xu = x[0], x[1]
            yv = Amv(xv) + dt_f * Kimv(xu)
            yu = dt_f * Kimv(xv) + (dt_f / th) * Kiemv(xu)
            return deflate(torch.stack([yv, yu]))

        def pde_step(v, u_e, t):
            kv_ = Kimv(v)
            rhs_v = C_m * ops.mv(w_m, v, M) - (1.0 - th) * dt_f * kv_
            b = b_stim_tables(_time_add(npt, t, th * dt_f), amps, 1.0)
            if b is not None:
                rhs_v = rhs_v + dt_f * b
            rhs_u = -(dt_f / th) * (1.0 - th) * kv_
            x = cg_implicit(block_matvec, deflate(torch.stack([rhs_v, rhs_u])),
                            x0=deflate(torch.stack([v, u_e])), precond_diag=diag, rtol=cg_rtol,
                            atol_scaled=cg_atol, maxiter=cg_maxiter, counts=counts)
            return x[0], x[1] - torch.mean(x[1])

        def step(carry, t):
            # the solver's general theta choreography: tentative theta*dt
            # ionic step, block PDE solve over dt, corrective (1-theta)*dt
            states, u_e = carry
            states = ode_fun(states, t, ionic, th_s * dt_f)
            v, u_e = pde_step(states[v_index], u_e, t)
            states = _set_row(states, v_index, v)
            if not godunov:
                states = ode_fun(states, _time_add(npt, t, th_s * dt_f), ionic, (1.0 - th_s) * dt_f)
            probe_v = (states[v_index][probe_dofs] * probe_w).sum(dim=1)
            if u_dofs is None:
                return (states, u_e), probe_v
            return (states, u_e), (probe_v, (u_e[u_dofs] * u_w).sum(dim=1))

        init = (states0, u0) if states0_in is None else states0_in
        final, traces = _checkpointed_scan(step, init, _times(t0, n_steps, dt_f, npt), checkpoint_segments)
        out = traces if u_dofs is None else {"v": traces[0], "u_e": traces[1]}
        if return_final:
            return out, final
        return out

    simulate.cg_counts = counts
    return simulate


# ---------------------------------------------------------------------------
# Host-chained segment adjoints


def _param_leaf(value, like: torch.Tensor) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(like.device)
    return torch.as_tensor(np.asarray(value, dtype=np.float64), device=like.device).to(like.dtype)


def _dict_add(a: dict | None, b: dict) -> dict:
    return dict(b) if a is None else {k: a[k] + b[k] for k in a}


def host_segmented_value_and_grad(
    sim: Callable,
    params: dict,
    seg_loss: Callable,
    seg_aux: list,
    *,
    segment_ms: float,
    states0,
    truncate_every: int | None = None,
    carry_clip: float | None = None,
    cotangent_scale: float = 1.0,
    window_outlier: float | None = None,
    window_grads_out: list | None = None,
    segment_seconds: dict | None = None,
):
    """``(value, grads)`` of ``sum_k seg_loss(sim_segment_k, seg_aux[k])``
    with the horizon split into HOST-CHAINED segments.

    The forward pass runs each segment without a graph and keeps the
    segment-boundary states on the device; the backward pass re-runs each
    segment, last first, under autograd of the augmented objective
    ``seg_loss + <cotangent, final_state>`` and hands the state cotangent
    to the segment before: the standard adjoint chaining, equal to the
    monolithic gradient.

    ``sim``: a simulator built with ``n_steps = segment_steps``, called as
    ``sim(params, states0_in=s, t0=t0, return_final=True)``.  ``seg_loss
    (traces, aux) -> scalar`` uses only the segment's own traces;
    ``seg_aux`` holds one entry per segment.  ``states0``: a tensor or a
    tuple of tensors (the bidomain's ``(states, u_e)``).  Every ``params``
    entry is differentiated (Python numbers become tensors of ``states0``'s
    type); ``grads`` has the same keys.

    ``truncate_every``: truncated BPTT over windows of that many segments;
    the state cotangent is zeroed at every window boundary.  The gradient
    is exact for the windowed objective.

    ``carry_clip``: if ``max|d_state| > carry_clip`` (Chebyshev norm, in
    TRUE cotangent space) the carry is rescaled to it; a non-finite carry
    resets to zero.  Composes with ``truncate_every``.

    ``window_outlier``: per-window gradients whose Chebyshev norm exceeds
    ``window_outlier * median(window norms)`` (non-finite ones always) are
    dropped from the sum; needs ``truncate_every`` and engages from 3
    windows on.

    ``window_grads_out``: a list that receives ``(segment_index,
    {key: float64 numpy})`` per window, unfiltered and unscaled, last window
    first.

    ``cotangent_scale``: seed the loss cotangent at ``scale`` and divide the
    gradient back at the end: mixed-precision loss scaling on the adjoint
    side, exact for a power of two (with a purely relative CG tolerance).

    ``segment_seconds``: a dict that receives the wall seconds of each
    segment's forward and backward (``"forward"``, ``"backward"`` lists),
    the device synchronized."""
    n_seg = len(seg_aux)
    if truncate_every is not None and truncate_every < 1:
        raise ValueError(f"truncate_every={truncate_every} must be >= 1")
    if carry_clip is not None and not carry_clip > 0.0:
        raise ValueError(f"carry_clip={carry_clip} must be > 0")
    cs = float(cotangent_scale)
    if not (cs > 0.0 and np.isfinite(cs)):
        raise ValueError(f"cotangent_scale={cotangent_scale} must be finite > 0")
    if window_outlier is not None:
        if not window_outlier > 0.0:
            raise ValueError(f"window_outlier={window_outlier} must be > 0")
        if truncate_every is None:
            raise ValueError("window_outlier requires truncate_every")

    like = _leaves(states0)[0]
    p = {k: _param_leaf(v, like) for k, v in params.items()}
    timed = segment_seconds is not None
    if timed:
        segment_seconds.setdefault("forward", [])
        segment_seconds.setdefault("backward", [])

    def clock():
        if like.device.type == "cuda":
            torch.cuda.synchronize(like.device)
        return time.perf_counter()

    def clip(d):
        clip_at = carry_clip * cs  # the carry is held in cs-scaled space
        m = torch.stack([leaf.abs().max() for leaf in _leaves(d)]).max()
        scale = torch.where(torch.isfinite(m), torch.clamp(clip_at / torch.clamp(m, min=1e-30), max=1.0),
                            torch.zeros_like(m))
        # zero non-finite entries explicitly: Inf * 0 = NaN would leak the
        # overflow this reset exists to contain
        return _tree_map(lambda leaf: torch.where(torch.isfinite(leaf), leaf, torch.zeros_like(leaf)) * scale, d)

    def seg_vg(s, t0, aux, d_final):
        with torch.enable_grad():
            p_ = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            s_ = _tree_map(lambda a: a.detach().requires_grad_(True), s)
            traces, fin = sim(p_, states0_in=s_, t0=t0, return_final=True)
            carry = sum(torch.sum(a * b) for a, b in zip(_leaves(d_final), _leaves(fin)))
            # the whole backward pass runs in cs-scaled cotangent space
            aug = cs * seg_loss(traces, aux) + carry
            inputs = list(p_.values()) + _leaves(s_)
            grads = torch.autograd.grad(aug, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
        dp = dict(zip(p_.keys(), grads[: len(p_)]))
        it = iter(grads[len(p_):])
        d_state = _tree_map(lambda _a: next(it), s)
        return dp, d_state

    # forward sweep: boundary states stay on the device
    bounds = [states0]
    s = states0
    value = 0.0
    for k in range(n_seg):
        tic = clock() if timed else 0.0
        with torch.no_grad():
            traces, s = sim(p, states0_in=s, t0=k * segment_ms, return_final=True)
            value += float(seg_loss(traces, seg_aux[k]))
        if timed:
            segment_seconds["forward"].append(clock() - tic)
        if k + 1 < n_seg:
            bounds.append(s)

    collect = window_grads_out is not None or window_outlier is not None
    d_state = _tree_map(torch.zeros_like, states0)
    grads = None
    win_list: list = []  # (segment_index, summed dp) per window
    win_acc = None
    for k in reversed(range(n_seg)):
        tic = clock() if timed else 0.0
        dp, d_state = seg_vg(bounds[k], k * segment_ms, seg_aux[k], d_state)
        if collect:
            win_acc = _dict_add(win_acc, dp)
        else:
            grads = _dict_add(grads, dp)
        if truncate_every is not None and k % truncate_every == 0:
            # window boundary: the window started from a stop-gradient state
            d_state = _tree_map(torch.zeros_like, d_state)
            if collect:
                win_list.append((k, win_acc))
                win_acc = None
        elif carry_clip is not None:
            d_state = clip(d_state)
        if timed:
            segment_seconds["backward"].append(clock() - tic)
    if collect and win_acc is not None:
        win_list.append((0, win_acc))

    if collect:
        if window_grads_out is not None:
            for k, w in win_list:
                window_grads_out.append(
                    (k, {key: g.detach().cpu().double().numpy() / cs for key, g in w.items()}))
        keep = win_list
        if window_outlier is not None and len(win_list) >= 3:
            norms = np.array([max(float(g.abs().max()) for g in w.values()) for _, w in win_list])
            # non-finite window sums always count as outliers; the median
            # over finite norms keeps the cut meaningful
            finite = norms[np.isfinite(norms)]
            cut = window_outlier * (np.median(finite) if finite.size else 0.0)
            keep = [wl for wl, m in zip(win_list, norms) if np.isfinite(m) and m <= cut] or win_list
        for _, w in keep:
            grads = _dict_add(grads, w)
    if cs != 1.0:
        grads = {k: g / cs for k, g in grads.items()}
    return value, grads
