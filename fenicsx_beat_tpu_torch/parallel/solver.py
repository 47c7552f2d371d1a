"""Sharded fused monodomain solver: SPMD ranks, halo exchanges, all-reduced CG.

Port of ``fenicsx_beat_tpu/parallel/solver.py``.  The JAX package runs
one ``shard_map`` program over a device mesh; the port runs one process
per rank (:mod:`.distributed`), each holding its own block of the node
axis on its device, and every cross-rank transfer goes through the
rank's :class:`~.comm.Communicator`:

| reference (MPI/PETSc)                 | JAX (XLA collectives)  | port (torch.distributed)        |
|---------------------------------------|------------------------|---------------------------------|
| scatter_forward after KSP solve       | ``ppermute`` halos     | ``halo_extend`` before each SpMV |
| KSP inner-product allreduce           | ``lax.psum`` in CG     | ``all_reduce_sum`` in the PCG   |

Every rank builds the same partition from the full mesh (host numpy,
:mod:`.partition`) and keeps its own block.  Structured slabs keep their
lexicographic order and their stencil; unstructured meshes are renumbered
by reverse Cuthill-McKee (:func:`~..native.rcm_ordering`) so the block
partition has a bounded halo, the spilled apex rows carried in each rank's
COO tail and merged into its CSR block (:func:`.lane.partition_lane_gather`).
Outputs (:attr:`ShardedMonodomainSolver.v`,
:meth:`ShardedMonodomainSolver.activation_times`) are gathered on every
rank in the mesh's original dof order.

Each rank's work runs on the port's kernels: the ionic step through
:func:`~..splitting.ionic_layer` (B1, its per-node form, or B7 for marker
layers), the local product over the halo-extended vector through B5
(``csrc/stencil_spmv.cu``, with its fused dot) on structured meshes and B8
(``csrc/csr_spmv.cu``) on unstructured ones, and the PCG's updates
through B3 (``cg_update``, whose two partial dots are then all-reduced)
and B4 (``axpy``).  B2 and B2·B4 are not used: their alpha needs the
global dot inside the kernel.  On CPU tensors the kernels' plain twins
run, which is how the port is held against the JAX package.

Padded dofs (the last rank's block past ``n_global``) replicate node 0's
ionic state, as in JAX, and their rows are EMPTY in the rank's device
operators (JAX keeps an identity row and masks its CG dots instead): their
residual is zero throughout, so they enter no dot and the real dofs see
JAX's arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from .. import fem
from ..base_model import Status
from ..conductivities import as_cell_tensors
from ..config import default_dtype
from ..mesh import Mesh
from ..ops import cuda_cg, cuda_ell, cuda_stencil
from ..ops.cg import CGInfo
from ..ops.cuda_ell import CSRMatrix
from ..ops.sparse import StencilMatrix
from ..splitting import check_ionic_scope, ionic_layer
from ..stimulation import _transform_I_s, separable_stimulus_terms, stimulus_quadratures
from ..stimulation import dx as dx_measure
from ..telemetry import NullMonitor
from ..theta_system import add_stimulus_loads
from .comm import Communicator
from .distributed import DeviceMesh
from .lane import partition_lane_gather
from .partition import Partition1D, pad_global, partition_ell, partition_quadrature, partition_stencil

__all__ = ["ShardedMonodomainSolver", "PartitionedStimuli", "partition_stimuli"]


@dataclass
class PartitionedStimuli:
    """Stimulus data laid out for the 1-D node partition (separable
    TimeWindow unit vectors and per-rank quadrature tables for general
    space-time expressions); shared by the sharded monodomain and
    bidomain solvers."""

    stimuli: list  # amps-slot-aligned: Stimulus or None (general exprs)
    b_units: np.ndarray  # [n_separable, n_pad]
    windows: list
    win_amp_idx: list
    gen_tables: tuple
    gen_Ns: list
    gen_exprs: list
    gen_amp_idx: list

    def amplitudes(self, dtype=np.float64) -> np.ndarray:
        """Live amplitude vector (read each chunk; 1.0 for a general
        expression, whose value is its own)."""
        amps = [float(s.expr.amplitude) if s is not None else 1.0 for s in self.stimuli]
        return np.asarray(amps or [0.0], dtype=dtype)


def ell_adjacency(mass) -> tuple[np.ndarray, np.ndarray]:
    """CSR adjacency ``(indptr, cols)`` straight from a padded-ELL
    structure, for RCM reordering (each row its own index first, then its
    off-diagonal columns; tail-spilled apex edges are omitted, which only
    perturbs the heuristic ordering near the apex: the partition's halo
    bound still checks the result)."""
    n = mass.shape[0]
    mcols = np.asarray(mass.cols)
    rowids = np.broadcast_to(np.arange(n, dtype=mcols.dtype)[:, None], mcols.shape)
    live = np.count_nonzero(mcols != rowids, axis=1) + 1
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(live, out=indptr[1:])
    keep = (mcols != rowids).ravel()
    ucols = np.empty(int(indptr[-1]), dtype=np.int32)
    ucols[indptr[:-1]] = np.arange(n, dtype=np.int32)
    fill = np.ones(int(indptr[-1]), dtype=bool)
    fill[indptr[:-1]] = False
    ucols[fill] = mcols.ravel()[keep].astype(np.int32)
    return indptr, ucols


def partition_stimuli(V, mesh: Mesh, I_s, part: Partition1D, perm, iperm, dtype=np.float64) -> PartitionedStimuli:
    """Normalize and partition stimuli: TimeWindow protocols stay separable
    (``b(t) = sum_s window_s(t) b_s``, one precomputed unit vector each,
    renumbered and padded); every other expression gets per-rank
    quadrature tables and is assembled inside the step at the time
    given."""
    stim_quads = stimulus_quadratures(V, _transform_I_s(I_s, dZ=dx_measure(mesh)), degree=4)
    terms, b_units_host = separable_stimulus_terms(stim_quads)
    b_units, windows, win_amp_idx = [], [], []
    gen_tables, gen_exprs, gen_Ns, gen_amp_idx = [], [], [], []
    for slot, quad, expr, b_idx, window in terms:
        if b_idx is not None:
            b_unit = b_units_host[b_idx]
            if perm is not None:
                b_unit = b_unit[perm]
            b_units.append(pad_global(b_unit, part))
            windows.append(window)
            win_amp_idx.append(slot)
        else:
            X3, W3, N, D3, O3 = partition_quadrature(quad, part, iperm)
            gen_tables.append((X3, W3, D3, O3))
            gen_Ns.append(N)
            gen_exprs.append(expr)
            gen_amp_idx.append(slot)
    npdt = np.dtype(dtype)
    return PartitionedStimuli(
        stimuli=[sq[2] for sq in stim_quads],
        b_units=np.stack(b_units).astype(npdt) if b_units else np.zeros((0, part.n_pad), dtype=npdt),
        windows=windows,
        win_amp_idx=win_amp_idx,
        gen_tables=tuple(gen_tables),
        gen_Ns=gen_Ns,
        gen_exprs=gen_exprs,
        gen_amp_idx=gen_amp_idx,
    )


# ---------------------------------------------------------------------------
# a rank's share of the setup


def rank_block(x, perm, part: Partition1D, rank: int) -> np.ndarray:
    """``rank``'s block of the node axis (the last) of ``x``: renumbered by
    ``perm`` (None: identity), padded by repeating the first renumbered
    node (a finite ionic state on the fictitious dofs, as JAX pads)."""
    x = np.asarray(x)
    if perm is not None:
        x = x[..., perm]
    lo = rank * part.n_local
    blk = x[..., lo : lo + part.n_local]
    short = part.n_local - blk.shape[-1]
    if short:
        blk = np.concatenate([blk, np.repeat(x[..., :1], short, axis=-1)], axis=-1)
    return np.ascontiguousarray(blk)


def assemble_partitioned(V, mesh: Mesh, conductivities: list, cache_key: str | None = None):
    """The mass and one stiffness per conductivity, in partition-friendly
    numbering: ``(perm, mass, stiffs)`` with ``perm`` None and
    :class:`~..ops.sparse.StencilMatrix` operators where the mesh gives one
    stencil for all of them (lexicographic slabs), else ``perm`` the RCM
    renumbering (``perm[new] = old``) and ELL operators assembled on the
    renumbered mesh (``parallel/solver.py:252-339`` there)."""
    from ..native import rcm_ordering

    pairs = []
    for i, M in enumerate(conductivities):
        # the first pair under the key itself: the fused solver's slot for the same problem
        key = None if cache_key is None else (cache_key if i == 0 else f"{cache_key}|{i}")
        pairs.append(fem.assemble_mass_stiffness_auto(V, M, cache_key=key))
    if all(isinstance(m, StencilMatrix) for m, _ in pairs) and len({m.offsets for m, _ in pairs}) == 1:
        return None, pairs[0][0], [k for _, k in pairs]
    mass = pairs[0][0]
    if isinstance(mass, StencilMatrix):
        mass = fem.assemble_mass_stiffness(V, conductivities[0])[0]
    indptr, ucols = ell_adjacency(mass)
    perm = rcm_ordering(indptr, ucols).astype(np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size)
    pm = Mesh(coords=mesh.coords[perm], cells=iperm[mesh.cells.astype(np.int64)].astype(np.int32),
              cell_type=mesh.cell_type)
    Vp = fem.functionspace(pm, ("P", 1))
    stiffs = []
    for M in conductivities:
        mass, k = fem.assemble_mass_stiffness(Vp, M)
        stiffs.append(k)
    return perm, mass, stiffs


class LocalOperators:
    """A rank's blocks of operators of one pattern on its device, applied
    to the halo-extended vector ``[H | owned | H]``: on structured meshes
    ``[K, n_local + 2H]`` stencil tables for B5 (zero on the halo columns
    and on padded rows), on unstructured meshes ``(n_local, n_local + 2H)``
    CSR blocks of one layout for B8 (padded rows empty).  ``mats`` holds
    them in the order given; :meth:`combine` makes a value combination."""

    def __init__(self, n_devices: int, rank: int, host_ops: list, device, dtype):
        nd, self.rank = n_devices, rank
        self.structured = isinstance(host_ops[0], StencilMatrix)
        if self.structured:
            part = partition_stencil(host_ops[0], nd)[0]
        else:
            parted = [partition_ell(A, nd) for A in host_ops]
            part = parted[0][0]
        self.part = part
        self.H, self.nl = part.halo, part.n_local
        self.n_real = part.real_rows(rank)
        if self.structured:
            self.offsets = tuple(int(d) for d in host_ops[0].offsets)
            self.k0 = self.offsets.index(0)
            mats = []
            for A in host_ops:
                _, vals3 = partition_stencil(A, nd)
                T = np.zeros((len(self.offsets), self.nl + 2 * self.H))
                T[:, self.H : self.H + self.n_real] = vals3[rank, : self.n_real].T
                mats.append(torch.as_tensor(T, device=device).to(dtype).contiguous())
            self.mats = mats
        else:
            cols3 = parted[0][1]
            for p in parted[1:]:
                if p[0] != parted[0][0] or not np.array_equal(p[1], cols3):
                    raise ValueError("the operators of one LocalOperators share one sparsity pattern")
            vals = [p[2].copy() for p in parted]
            for v in vals:  # padded rows empty (module docstring)
                v[rank, self.n_real :] = 0.0
            tail = None
            if parted[0][3] is not None:
                tail = (parted[0][3][0], parted[0][3][1], *(p[3][2] for p in parted))
            blocks, _, _ = partition_lane_gather(part, cols3, vals, tail, ranks=[rank])
            self.mats = [A.to(device, dtype) for A in blocks[rank]]
        self.tail = None if self.structured else parted[0][3]

    def combine(self, coefs) -> Any:
        """``sum_i coefs[i] * mats[i]`` (a table or a CSR block)."""
        if self.structured:
            out = coefs[0] * self.mats[0]
            for c, T in zip(coefs[1:], self.mats[1:]):
                out = out + c * T
            return out.contiguous()
        out = self.mats[0].combine(coefs[0], None, 0.0)
        for c, A in zip(coefs[1:], self.mats[1:]):
            out = out.combine(1.0, A, c)
        return out

    def apply(self, A, x_ext: torch.Tensor) -> torch.Tensor:
        """``A`` times the extended vector: the owned rows, ``[n_local]``."""
        if self.structured:
            return cuda_stencil.stencil_spmv(A, x_ext, self.offsets)[self.H : self.H + self.nl]
        return cuda_ell.csr_spmv(A, x_ext)

    def apply_dot(self, A, x_ext: torch.Tensor):
        """``(A x, <x, A x>)`` over the owned rows, the dot a 0-d tensor of
        this rank's share (B5's fused dot on structured meshes)."""
        if self.structured:
            y, d = cuda_stencil.stencil_spmv_dot(A, x_ext, self.offsets)
            return y[self.H : self.H + self.nl], d
        y = cuda_ell.csr_spmv(A, x_ext)
        return y, torch.dot(x_ext[self.H : self.H + self.nl], y)

    def diagonal(self, A) -> torch.Tensor:
        """The owned rows' diagonal (0 on padded rows)."""
        if self.structured:
            return A[self.k0, self.H : self.H + self.nl]
        return A.diag


class LocalQuadrature:
    """A rank's quadrature tables of one general stimulus: points ``X``
    [gdim, ne, nq], weights ``W``, basis ``N`` and the owned slots'
    cell-to-dof sum as one CSR product (B8), ``[n_local, ne * nd]``;
    :meth:`assemble_load` is :meth:`.fem.CellQuadData.assemble_load` on
    these tables."""

    def __init__(self, tables, N, rank: int, n_local: int, device, dtype):
        X3, W3, D3, O3 = tables
        D, O = D3[rank].ravel(), O3[rank].ravel() > 0

        def on_dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)

        self.X = on_dev(np.moveaxis(X3[rank], -1, 0))
        self.W = on_dev(W3[rank])
        self.N = on_dev(N)
        S = sp.csr_matrix((np.ones(int(O.sum())), (D[O], np.flatnonzero(O))), shape=(n_local, D.size))
        self.csr_spmv = cuda_ell.csr_spmv
        self.scatter = CSRMatrix.from_operator(S).to(device, dtype)

    def device_tables(self, device=None, dtype=None) -> "LocalQuadrature":
        return self  # built on the rank's device and dtype

    assemble_load = fem.CellQuadData.assemble_load


class RankStimuli:
    """A rank's stimuli in :func:`~..theta_system.add_stimulus_loads`'s
    form: ``terms`` (the separable unit vectors' slots and windows, the
    general expressions' local tables) and ``b_units``, the unit vectors'
    owned block."""

    def __init__(self, st: PartitionedStimuli, part: Partition1D, rank: int, device, dtype):
        lo, nl = rank * part.n_local, part.n_local
        self.b_units = torch.as_tensor(st.b_units[:, lo : lo + nl], device=device).to(dtype)
        self.terms = [(slot, None, None, i, window) for i, (slot, window) in enumerate(zip(st.win_amp_idx, st.windows))]
        self.terms += [(slot, LocalQuadrature(tab, N, rank, nl, device, dtype), expr, None, None)
                       for slot, tab, N, expr in zip(st.gen_amp_idx, st.gen_tables, st.gen_Ns, st.gen_exprs)]

    def add_loads(self, b: torch.Tensor, t, dt: float, amps) -> torch.Tensor:
        """``b`` plus ``dt`` times the amplitude-weighted loads at ``t``, a
        scalar of the working numpy dtype."""
        return add_stimulus_loads(b, self.terms, self.b_units, t, dt, amps)


def local_ionic(ionic, ode_fun, ode_markers, init_states, parameters, v_index, perm, part, rank, n, device,
                dtype):
    """The :func:`~..splitting.ionic_layer` of ``rank``'s block: every
    node-aligned argument (markers, ``[S, n]`` states, ``[NP, n]``
    parameter fields, per marker too) cut to the block by
    :func:`rank_block`; returns the layer and the block's ``[S, n_local]``
    initial states (numpy)."""

    def local(x):
        return rank_block(x, perm, part, rank) if np.ndim(x) == 2 and np.shape(x)[-1] == n else x

    markers = None
    if isinstance(ode_fun, dict):
        m = ode_markers.x.array if hasattr(ode_markers, "x") else ode_markers
        m = np.asarray(m).astype(np.int64)
        if m.shape[0] != n:
            raise ValueError(f"ode_markers has {m.shape[0]} entries, expected {n}")
        markers = rank_block(m, perm, part, rank)
        init_states = {k: local(v) for k, v in init_states.items()}
        parameters = {k: local(v) for k, v in parameters.items()}
    else:
        init_states, parameters = local(init_states), local(parameters)
    layer = ionic_layer(ionic, ode_fun, markers, init_states, parameters, v_index, part.n_local, device, dtype,
                        use_kernels=True)
    init = np.asarray(layer.init_states, dtype=np.float64)
    states = np.tile(init[:, None], (1, part.n_local)) if init.ndim == 1 else init
    return layer, states


class ShardedPCG:
    """Jacobi-PCG on a rank's block (``ops/cg.py``'s recurrences and exit
    test ``sqrt(<r, r>) > max(rtol ||b||, atol)``, the dots all-reduced):
    per iteration one halo exchange, the local product with its dot (B5
    or B8 and a dot), one all-reduce, B3's update with its two partial
    dots, a second all-reduce of both, and B4's ``p = z + beta p``.  The
    exit test reads the reduced ``<r, r>`` back to the host (the same
    value on every rank, so every rank stops together)."""

    def __init__(self, ops: LocalOperators, comm: Communicator, rtol, atol, maxiter):
        self.ops, self.comm = ops, comm
        self.rtol, self.atol, self.maxiter = float(rtol), float(atol), int(maxiter)
        self.update = cuda_cg.CGUpdate(ops.nl, comm.device)
        self._ext = None
        self.host_syncs = 0

    def ext(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` halo-extended into this solver's buffer (overwritten by the next call)."""
        if self._ext is None or self._ext.dtype != x.dtype:
            self._ext = torch.empty(self.ops.nl + 2 * self.ops.H, dtype=x.dtype, device=x.device)
        return self.comm.halo_extend(x, self.ops.H, out=self._ext)

    def apply(self, A, x: torch.Tensor) -> torch.Tensor:
        return self.ops.apply(A, self.ext(x))

    def solve(self, A, minv: torch.Tensor, b: torch.Tensor, x0: torch.Tensor):
        """``(x, iterations, ||r||, converged)`` of ``A x = b`` from ``x0``."""
        comm = self.comm
        r = b - self.apply(A, x0)
        z = r * minv
        s = comm.all_reduce_sum(torch.stack([torch.dot(r, z), torch.dot(r, r), torch.dot(b, b)]))
        rz, rr = s[0], s[1]
        tol = torch.clamp(self.rtol * torch.sqrt(s[2]), min=self.atol)
        x, p, rz_prev = x0, None, None
        k = 0
        while k < self.maxiter:
            self.host_syncs += 1
            if not bool(torch.sqrt(rr) > tol):
                break
            p = z if p is None else cuda_cg.axpy(z, p, rz / rz_prev)
            Ap, pAp = self.ops.apply_dot(A, self.ext(p))
            alpha = rz / comm.all_reduce_sum(pAp.reshape(1))[0]
            x, r, z, rz_new, rr = self.update(x, r, p, Ap, minv, alpha)
            s = comm.all_reduce_sum(torch.stack([rz_new, rr]))
            rz_prev, rz, rr = rz, s[0], s[1]
            k += 1
        rnorm = torch.sqrt(rr)
        return x, k, rnorm, k < self.maxiter or bool(rnorm <= tol)


class ShardedChunk(NamedTuple):
    t: float
    iters_max: int
    iters_sum: int
    residual_norm: float
    converged: bool


@dataclass
class ShardedMonodomainSolver:
    """Monodomain splitting solver sharded over the ranks of a 1-D
    :class:`~.distributed.DeviceMesh` (module docstring).

    The JAX solver's constructor vocabulary (``parallel/solver.py:173-197``
    there) without its TPU switch ``use_lane_gather``; ``device_mesh`` is
    :func:`~.distributed.make_device_mesh`'s, and it names the rank's
    device.  ``cg_rtol`` and ``cg_atol`` default to 1e-8 and 1e-10 in
    float64 and to the fused solver's 1e-6 and 1e-7 in float32, the card's
    type.  Every rank must construct the solver and call each method that
    moves data between ranks (:meth:`solve`, :meth:`run_chunk`, :attr:`v`,
    :meth:`activation_times`, :meth:`save_state`) together.
    ``TimeWindow`` stimuli take the separable fast path; any other
    expression is assembled on each rank inside the step.  Multi-marker
    ionic models (dict ``ode_fun``, ``init_states``, ``parameters`` and
    ``v_index`` with ``ode_markers``) follow ``DolfinMultiODESolver``'s
    semantics through :func:`~..odesolver.make_multi_ode`."""

    mesh: Mesh
    M: Any
    ode_fun: Callable
    init_states: np.ndarray
    parameters: np.ndarray | None
    device_mesh: DeviceMesh
    v_index: int = 0
    I_s: Any = None
    theta: float = 1.0
    pde_theta: float = 0.5
    C_m: float = 1.0
    cg_rtol: float | None = None
    cg_atol: float | None = None
    cg_maxiter: int = 1000
    activation_threshold: float = 0.0
    dtype: Any = None
    monitor: Any = field(default_factory=NullMonitor)
    ode_markers: Any = None
    operator_cache_key: str | None = None

    def __post_init__(self):
        dm = self.device_mesh
        dev = self.device = dm.device
        self.dtype = self.dtype or default_dtype(dev)
        if dev.type == "cuda" and self.dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self.dtype}")
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        f64 = self.dtype == torch.float64
        self.cg_rtol = (1e-8 if f64 else 1e-6) if self.cg_rtol is None else self.cg_rtol
        self.cg_atol = (1e-10 if f64 else 1e-7) if self.cg_atol is None else self.cg_atol
        self.monitor = self.monitor or NullMonitor()
        self.rank, nd = dm.rank, dm.world_size
        self.comm = Communicator(dm)
        ionic = check_ionic_scope(self.ode_fun, self.ode_markers, self.init_states, self.parameters, self.v_index)

        self.V = fem.functionspace(self.mesh, ("P", 1))
        n = self.V.ndofs
        M_cells = as_cell_tensors(self.M, self.mesh)
        perm, mass, (stiff,) = assemble_partitioned(self.V, self.mesh, [M_cells], self.operator_cache_key)
        self._perm = perm
        self._iperm = None
        if perm is not None:
            self._iperm = np.empty_like(perm)
            self._iperm[perm] = np.arange(n)
        self.ops = LocalOperators(nd, self.rank, [mass, stiff], dev, self.dtype)
        self.part: Partition1D = self.ops.part
        self._offsets = self.ops.offsets if self.ops.structured else None
        self._tail = self.ops.tail
        self._pcg = ShardedPCG(self.ops, self.comm, self.cg_rtol, self.cg_atol, self.cg_maxiter)

        self._st = partition_stimuli(self.V, self.mesh, self.I_s, self.part, perm, self._iperm)
        self._rank_stim = RankStimuli(self._st, self.part, self.rank, dev, self.dtype)

        layer, states = local_ionic(ionic, self.ode_fun, self.ode_markers, self.init_states, self.parameters,
                                    self.v_index, perm, self.part, self.rank, n, dev, self.dtype)
        self._ode_step, self.v_index = layer.step, layer.v_index
        self.states = torch.as_tensor(states, device=dev).to(self.dtype).contiguous()
        self.activation_time = torch.full((self.part.n_local,), -1.0, dtype=self.dtype, device=dev)
        self._ops_cache = None
        self.cg_iterations = 0
        self.steps = 0
        self.last_solve_converged = True
        self.comm.barrier()

    # ------------------------------------------------------------------
    @property
    def host_syncs(self) -> int:
        return self._pcg.host_syncs

    def _operators(self, dt: float):
        """``(A, B, minv)`` of ``dt``: ``C_m M + theta dt K``, ``C_m M -
        (1 - theta) dt K`` and the Jacobi inverse diagonal (1 on padded
        rows), built once per dt."""
        if self._ops_cache is not None and self._ops_cache[0] == dt:
            return self._ops_cache[1]
        C_m, th = float(self.C_m), float(self.pde_theta)
        A = self.ops.combine([C_m, th * dt])
        B = self.ops.combine([C_m, -(1.0 - th) * dt])
        d = self.ops.diagonal(A)
        real = torch.arange(self.part.n_local, device=self.device) < self.ops.n_real
        minv = torch.where(real, d, torch.ones_like(d)).reciprocal().contiguous()
        ops = (A, B, minv)
        self._ops_cache = (dt, ops)
        return ops

    def stimulus_amplitudes(self) -> np.ndarray:
        return self._st.amplitudes(self._np_dtype)

    def run_chunk(self, t0, dt: float, n_steps: int, amps=None) -> ShardedChunk:
        """Advance ``n_steps`` steps of ``dt`` from ``t0`` (JAX's
        ``local_chunk``): the tentative ionic step of ``theta dt``, the
        PDE step warm-started from the last increment (reset each chunk),
        the corrective ionic step (none at theta=1), the activation stamp."""
        w = self._np_dtype
        amps = self.stimulus_amplitudes() if amps is None else amps
        dtw = w(dt)
        dt_f = float(dtw)
        theta = float(self.theta)
        corrective = not np.isclose(theta, 1.0)
        tent_dt, corr_dt = float(w(theta) * dtw), float(w(1.0 - theta) * dtw)
        A, B, minv = self._operators(dt_f)
        thr = float(self.activation_threshold)
        vi, states, act = self.v_index, self.states, self.activation_time
        t = w(t0)
        v_cur = states[vi].clone()
        dv = torch.zeros_like(v_cur)
        it_max = it_sum = 0
        conv, rnorm = True, None
        with self.monitor.track_time("sharded_chunk"):
            for _ in range(n_steps):
                self._ode_step(states, v_cur, float(t), tent_dt)
                v = states[vi]
                b = self._rank_stim.add_loads(self._pcg.apply(B, v), t + w(self.pde_theta) * dtw, dt_f, amps)
                v_new, iters, rnorm, ok = self._pcg.solve(A, minv, b, v + dv)
                dv = v_new - v
                if corrective:
                    self._ode_step(states, v_new, float(t + w(theta) * dtw), corr_dt)
                    v_new = states[vi]
                act = torch.where((v_new > thr) & (act < 0), float(t), act)
                t = t + dtw
                v_cur = v_new
                it_max, it_sum = max(it_max, iters), it_sum + iters
                conv = conv and ok
            states[vi].copy_(v_cur)
        self.activation_time = act
        self.cg_iterations += it_sum
        self.steps += n_steps
        rn = float(rnorm) if rnorm is not None else 0.0
        self.monitor.record_ksp(CGInfo(it_max, rn, conv))
        self.monitor.advance_step(float(t0), float(t))
        return ShardedChunk(float(t), it_max, it_sum, rn, conv)

    # ------------------------------------------------------------------
    def _global(self, x_loc: torch.Tensor) -> torch.Tensor:
        """The gathered ``[..., n_global]`` array in original dof order."""
        g = self.comm.gather_global(x_loc)[..., : self.part.n_global]
        if self._iperm is not None:
            g = g[..., torch.as_tensor(self._iperm, device=g.device)]
        return g

    @property
    def v(self) -> torch.Tensor:
        """Voltage in the mesh's original dof order, on every rank."""
        return self._global(self.states[self.v_index])

    def activation_times(self) -> np.ndarray:
        """Activation times in the mesh's original dof order, on every rank."""
        return self._global(self.activation_time).cpu().numpy()

    def solve(self, interval, dt, save_freq: int | None = None, save_callback=None) -> Status:
        """Sharded time loop in chunks of ``save_freq`` steps; returns
        ``Status.NOT_CONVERGING`` if any step's CG hit ``cg_maxiter``
        without meeting its tolerance.  ``save_callback(t, v)`` receives the
        gathered voltage (original order) on every rank."""
        T0, T = interval
        n_total = int(round((T - T0) / dt))
        chunk = save_freq or n_total
        t = self._np_dtype(T0)
        done, ok = 0, True
        while done < n_total:
            n = min(chunk, n_total - done)
            res = self.run_chunk(t, dt, n)
            t = self._np_dtype(res.t)
            done += n
            ok = ok and res.converged
            self.last_cg = CGInfo(res.iters_max, res.residual_norm, res.converged)
            if save_callback is not None:
                save_callback(res.t, self.v.cpu().numpy())
        self.last_solve_converged = ok
        return Status.OK if ok else Status.NOT_CONVERGING

    # ------------------------------------------------------------------
    # checkpoints: the npz both fused solvers share, in original dof order,
    # so a checkpoint moves across rank counts, renumberings and solvers
    def save_state(self, path, t: float = 0.0) -> Path:
        """Gather every state and write them from rank 0; every rank returns
        the path after a barrier."""
        states = self._global(self.states).cpu().numpy()
        act = self.activation_times()
        out = Path(path).with_suffix(".npz")
        if self.rank == 0:
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(out, states=states, activation_time=act, t=float(t), v_index=self.v_index)
        self.comm.barrier()
        return out

    def load_state(self, path) -> float:
        """Every rank reads the checkpoint and keeps its block; returns its time."""
        with np.load(Path(path).with_suffix(".npz")) as f:
            states, act = f["states"], f["activation_time"]
            t, ck_vi = float(f["t"]), int(f["v_index"])
        n = self.part.n_global
        if states.shape[1] != n:
            raise ValueError(f"checkpoint has {states.shape[1]} nodes, mesh has {n}")
        if states.shape[0] != self.states.shape[0]:
            raise ValueError(f"checkpoint has {states.shape[0]} ionic states, solver has "
                             f"{self.states.shape[0]} (different model?)")
        if ck_vi != int(self.v_index):
            raise ValueError(f"checkpoint v_index {ck_vi} != solver {self.v_index} (different ionic model?)")
        blk = rank_block(states, self._perm, self.part, self.rank)
        self.states = torch.as_tensor(blk, device=self.device).to(self.dtype).contiguous()
        a = rank_block(act, self._perm, self.part, self.rank).copy()
        a[self.ops.n_real :] = -1.0
        self.activation_time = torch.as_tensor(a, device=self.device).to(self.dtype)
        return t
