"""Pseudo-ECG recovery, 12-lead algebra, QT-interval analysis.

Port of ``fenicsx_beat_tpu/ecg.py``:

* :class:`ECGRecovery` recovers the transmembrane current Im by solving
  ``-C_m * Mass @ Im = K(M) @ v`` with the generic Jacobi-CG of
  :mod:`.ops.cg`, then evaluates the infinite-homogeneous-conductor
  integral ``phi_e(p) = 1/(4 pi sigma_b) ∫ Im / |r - p| dx``.  On a
  structured mesh mass and stiffness are ``[K, n]`` stencil tables and every
  product is the general stencil SpMV: B5 (``csrc/stencil_spmv.cu``), or B6
  (``csrc/stencil_spmv_window.cu``) for an operand over 8 MiB, the JAX
  package's choice (``ecg.py:287-294``).  On an unstructured mesh they are
  one shared CSR layout and the product is B8.  Each solve warm-starts
  from the previous Im; :meth:`ECGRecovery.register_electrodes` computes
  the ``[n_electrodes, n]`` weight matrix once on the device, so a frame's
  potentials are one small product and only ``n_electrodes`` scalars come
  back to the host.
* :class:`Leads12` implements the Einthoven / Wilson / Goldberger lead
  algebra.
* ``detect_r_peaks`` / ``detect_t_end`` / ``qt_interval``, ``apd`` and
  ``restitution_curve`` are numpy/scipy and copied unchanged.

The node axis is not padded: JAX pads only for its TPU kernel and masks
the CG's dot products so that the padded solve is the unpadded one.  There
is no silent switch between a kernel and its twin: ``use_kernels=False``
selects the twins on any device, and a CPU device runs them.
"""

from __future__ import annotations

import logging
import math
import time as _time
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch
from scipy.signal import find_peaks

from . import fem
from .conductivities import as_cell_tensors
from .config import default_dtype, resolve_device
from .ops import cuda_ell, cuda_stencil
from .ops.cg import cg
from .ops.quadrature import simplex_rule
from .ops.sparse import StencilMatrix, pack_values

logger = logging.getLogger(__name__)

__all__ = [
    "detect_r_peaks",
    "detect_t_end",
    "QTIntervalResult",
    "qt_interval",
    "apd",
    "electrode_weight_matrix",
    "restitution_curve",
    "ECGRecovery",
    "Leads12",
    "example",
]

# The stencil operand size above which the JAX package takes its windowed
# kernel (B6): ceil(n / 128) * 128 entries of the working dtype over 8 MiB.
WINDOW_OPERAND_BYTES = 8 * 1024 * 1024
CG_MAXITER = 1000  # the JAX package's cg default


def detect_r_peaks(ecg_signal: np.ndarray, min_distance: float = 20) -> np.ndarray:
    """R-peak indices (height-thresholded), behavioral match of reference
    ``ecg.py:20-42``: peaks at least ``min_distance`` samples apart and, when
    the signal goes positive, at least half the global maximum tall."""
    top = np.max(ecg_signal)
    peaks, _ = find_peaks(
        ecg_signal, distance=min_distance, height=0.5 * top if top > 0 else None
    )
    return peaks


def detect_t_end(
    averaged_rr: np.ndarray,
    r_peak_index: int,
    window_start_offset: int = 50,
    window_end_offset: int = 400,
) -> int:
    """T-wave end by the steepest-descent criterion.

    Within the search window ``[r_peak + start_offset, r_peak +
    end_offset)`` the T peak is the sample of largest magnitude; T-end is
    where the first derivative is most negative after that peak
    (behavioral match of reference ``ecg.py:45-130``).  Degenerate
    geometry (window off the end of the signal, T peak on the window
    edge, T-end not after the R peak) is warned about, not fatal.
    """
    if averaged_rr is None or len(averaged_rr) == 0:
        raise RuntimeError("detect_t_end needs a non-empty signal")

    lo = max(0, r_peak_index + window_start_offset)
    hi = min(len(averaged_rr), r_peak_index + window_end_offset)
    window = np.asarray(averaged_rr[lo:hi])
    if window.size == 0:
        logger.warning("T-end search window [%d, %d) is empty", lo, hi)
        return int(min(len(averaged_rr) - 1, max(0, r_peak_index)))
    if window.size < 2:
        logger.warning("T-end search window [%d, %d) holds fewer than 2 samples", lo, hi)

    t_peak = int(np.argmax(np.abs(window)))
    tail = np.diff(window)[t_peak:]
    if tail.size == 0:
        logger.warning("T peak sits on the edge of the search window")
        t_end = lo + t_peak
    else:
        t_end = lo + t_peak + int(np.argmin(tail))
    if t_end <= r_peak_index:
        logger.warning("detected T-end (index %d) does not follow the R peak", t_end)
    return int(t_end)


class QTIntervalResult(NamedTuple):
    qt_interval: float
    start_index: int
    end_index: int


def qt_interval(
    t: np.ndarray,
    ecg_signal: np.ndarray,
    min_distance: float = 20.0,
    window_start_offset: int = 50,
    window_end_offset: int = 400,
) -> QTIntervalResult:
    """QT interval: first R peak to the T-end that follows it (behavioral
    match of reference ``ecg.py:180-226``)."""
    r_peaks = detect_r_peaks(ecg_signal=ecg_signal, min_distance=min_distance)
    if len(r_peaks) == 0:
        raise RuntimeError("no R peaks found; cannot measure a QT interval")
    r0 = int(r_peaks[0])
    t_end = detect_t_end(
        ecg_signal,
        r0,
        window_start_offset=window_start_offset,
        window_end_offset=window_end_offset,
    )
    return QTIntervalResult(qt_interval=t[t_end] - t[r0], start_index=r0, end_index=t_end)


def _beat_intervals(t, v, repolarization, threshold):
    """Per-beat (beat_index, t_activation, t_repolarization) from a trace.

    Beats are upward ``threshold`` crossings; activation is the linearly
    interpolated crossing, repolarization the first interpolated drop
    below ``v_peak - p/100 * (v_peak - v_rest)`` after the beat's peak
    (v_rest = pre-upstroke voltage).  Beats that do not repolarize before
    the next beat (or the trace end) are omitted — note the beat INDEX is
    kept so callers can detect the gap."""
    t = np.asarray(t, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    up = np.nonzero((v[:-1] < threshold) & (v[1:] >= threshold))[0]
    out = []
    for k, u in enumerate(up):
        end = up[k + 1] if k + 1 < len(up) else v.size - 1
        f = (threshold - v[u]) / (v[u + 1] - v[u])
        t_act = t[u] + f * (t[u + 1] - t[u])
        v_rest = v[max(u - 1, 0)]
        pk = u + int(np.argmax(v[u : end + 1]))
        v_peak = v[pk]
        level = v_peak - (repolarization / 100.0) * (v_peak - v_rest)
        below = np.nonzero(v[pk : end + 1] <= level)[0]
        if below.size == 0 or below[0] == 0:
            continue  # beat does not repolarize inside this window
        j = pk + below[0]
        f = (level - v[j - 1]) / (v[j] - v[j - 1])
        t_rep = t[j - 1] + f * (t[j] - t[j - 1])
        out.append((k, t_act, t_rep))
    return out


def apd(
    t: np.ndarray,
    v: np.ndarray,
    repolarization: float = 90.0,
    threshold: float = 0.0,
) -> np.ndarray:
    """Per-beat action-potential durations APD_p from a voltage trace.

    See :func:`_beat_intervals` for the beat model.  Goes beyond the
    reference's analysis set (its ``ecg.py`` stops at R-peak/T-end/QT);
    APD/DI are the standard tissue-level restitution measures
    (pace_train/pvc protocols)."""
    beats = _beat_intervals(t, v, repolarization, threshold)
    return np.asarray([t_rep - t_act for _, t_act, t_rep in beats])


def restitution_curve(
    t: np.ndarray,
    v: np.ndarray,
    repolarization: float = 90.0,
    threshold: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(diastolic intervals, following APDs) from a paced voltage trace.

    ``DI_k`` is the gap between beat k's APD_p repolarization and beat
    k+1's activation; the returned pairs ``(DI_k, APD_{k+1})`` are the
    standard S1-S2 / dynamic restitution relation (consumer of the
    ``pace_train`` protocol).  Pairs are formed only between
    CONSECUTIVE detected beats: if a beat fails to repolarize (short-DI
    / alternans regimes), the pairs on both sides of the gap are
    dropped rather than fabricating a DI that spans two beats."""
    beats = _beat_intervals(t, v, repolarization, threshold)
    di, apds = [], []
    for (k0, _, rep0), (k1, act1, rep1) in zip(beats, beats[1:]):
        if k1 != k0 + 1:
            continue  # a non-repolarizing beat sits between: no valid pair
        di.append(act1 - rep0)
        apds.append(rep1 - act1)
    return np.asarray(di), np.asarray(apds)


@dataclass
class ECGRecovery:
    """Recover Im = -(1/C_m) Mass^{-1} K v and expose electrode-potential
    evaluation.

    Two electrode paths, as in the JAX package:

    * :meth:`eval` returns a lazy :class:`~.fem.ScalarForm` (host
      quadrature assembly) -- right for small meshes and API parity.
    * :meth:`register_electrodes` + :meth:`electrode_potentials` precompute
      a device-resident ``[n_electrodes, n]`` weight matrix with the SAME
      quadrature rule; per frame the ECG is one small product and only
      ``n_electrodes`` scalars cross to the host.

    ``device``: the card unless the CPU is named (raises without a card);
    float32 on CUDA, float64 on the CPU (:mod:`.config`).  ``use_kernels``
    False runs the kernels' plain PyTorch twins.  After construction,
    ``kernel`` names the SpMV of the solve (``"B5"``, ``"B6"`` or ``"B8"``)
    and ``setup_s`` holds the seconds of its parts.  ``operator_cache_key``
    opts the operator assembly into the disk cache (``ecg.py:228`` there).
    """

    v: fem.Function
    sigma_b: float = 1.0
    C_m: float = 1.0
    dx: Any = None
    M: Any = 1.0
    petsc_options: dict[str, Any] = field(
        default_factory=lambda: {"ksp_type": "cg", "ksp_rtol": 1.0e-8, "ksp_atol": 1.0e-8}
    )
    operator_cache_key: str | None = None  # opts the assembly into the operator disk cache
    device: Any = None
    dtype: Any = None
    use_kernels: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dtype = self.dtype or default_dtype(self.device)
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise TypeError(f"the CUDA path runs in float32, got {self.dtype}")
        self._np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        dev, dt_ = self.device, self.dtype
        self.sol = fem.Function(self.V, name="Im")
        n = self._n = self.V.ndofs

        # host assembly in float64: the stencil where the mesh allows,
        # ELL otherwise (fem.assemble_mass_stiffness_auto), from the
        # operator disk cache where operator_cache_key opts in
        tic = _time.perf_counter()
        mass, stiff = fem.assemble_mass_stiffness_auto(self.V, as_cell_tensors(self.M, self.mesh),
                                                       cache_key=self.operator_cache_key)
        self.setup_s = {"assembly_s": _time.perf_counter() - tic}

        tic = _time.perf_counter()
        k = self.use_kernels
        if isinstance(mass, StencilMatrix):
            offsets = mass.offsets
            operand_bytes = -(-n // 128) * 128 * torch.finfo(dt_).bits // 8
            if operand_bytes > WINDOW_OPERAND_BYTES:
                self.kernel = "B6"
                spmv = cuda_stencil.stencil_spmv_window if k else cuda_stencil.stencil_spmv_twin
            else:
                self.kernel = "B5"
                spmv = cuda_stencil.stencil_spmv if k else cuda_stencil.stencil_spmv_twin
            self._mT = pack_values(mass).to(device=dev, dtype=dt_)
            self._kT = pack_values(stiff).to(device=dev, dtype=dt_)
            self.offsets = offsets
            self._apply_mass = lambda u: spmv(self._mT, u, offsets)
            self._apply_stiff = lambda u: spmv(self._kT, u, offsets)
            mass_diag = self._mT[offsets.index(0)]
        else:
            self.kernel = "B8"
            self.offsets = None
            self._mass, self._stiff = (
                A.to(dev, dt_) for A in cuda_ell.CSRMatrix.from_operator_pair(mass, stiff)
            )
            csr = cuda_ell.csr_spmv if k else cuda_ell.csr_spmv_twin
            self._apply_mass = lambda u: csr(self._mass, u)
            self._apply_stiff = lambda u: csr(self._stiff, u)
            mass_diag = self._mass.diagonal()
        self._rtol = float(self.petsc_options.get("ksp_rtol", 1e-8))
        self._atol = float(self.petsc_options.get("ksp_atol", 1e-8))
        self._prec = float(self.C_m) * mass_diag
        # warm start: consecutive frames of a propagating wave are close,
        # so the previous Im is a good initial iterate
        self._x0 = torch.zeros(n, dtype=dt_, device=dev)
        self._im_device = None
        self.last_info = None
        self.last_upload_s = 0.0
        self.host_syncs = 0  # values read back to the host by the solves
        self._electrode_W = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_s["operators_s"] = _time.perf_counter() - tic

    @property
    def V(self) -> fem.FunctionSpace:
        return self.v.function_space

    @property
    def mesh(self):
        return self.v.function_space.mesh

    def _recover(self, v_arr: torch.Tensor, x0: torch.Tensor):
        # -C_m Mass Im = K v  =>  (C_m Mass) Im = -(K v)
        C_m = float(self.C_m)
        b = -self._apply_stiff(v_arr)
        x, info = cg(
            lambda u: C_m * self._apply_mass(u),
            b,
            x0=x0,
            precond_diag=self._prec,
            rtol=self._rtol,
            atol=self._atol,
            maxiter=CG_MAXITER,
        )
        # the loop's exit tests, then the residual norm and the converged flag
        self.host_syncs += min(info.iterations + 1, CG_MAXITER) + 2
        return x, info

    def solve_device(self):
        """Recover Im on the device; returns ``(im, CGInfo)`` without pulling
        the solution to the host.  Production loops pair this with
        :meth:`electrode_potentials`.  Uploads ``v.x.array`` (host) in the
        working dtype; ``last_upload_s`` is that copy's host time."""
        tic = _time.perf_counter()
        v_host = np.ascontiguousarray(self.v.x.array, dtype=self._np_dtype)
        v_arr = torch.from_numpy(v_host).to(self.device)
        self.last_upload_s = _time.perf_counter() - tic
        x, info = self._recover(v_arr, self._x0)
        self._x0 = x
        self._im_device = x
        self.last_info = info
        return x, info

    def solve(self) -> None:
        """Recover Im and sync it into ``self.sol`` (host) for the lazy
        :meth:`eval` forms.  Pulls n values to the host -- fine at demo
        scale; use :meth:`solve_device` in production loops."""
        logger.debug("Solving ECG recovery")
        im, _ = self.solve_device()
        self.sol.x.array[:] = im.cpu().numpy()

    def eval(self, point) -> fem.ScalarForm:
        """Electrode potential form: assembles to
        ``1/(4 pi sigma_b) ∫ Im / |x - p| dx`` using the *current* ``sol``
        (lazy, like the reference's returned dolfinx form)."""
        p = np.zeros(self.mesh.gdim)
        p[: len(point)] = np.asarray(point, dtype=np.float64)[: self.mesh.gdim]
        sigma_b = float(self.sigma_b)

        def integrand(x, u):
            # x: [gdim, ne, nq]; u: [ne, nq]
            diff = np.stack([x[i] - p[i] for i in range(len(p))])
            dist = np.sqrt(np.sum(diff**2, axis=0))
            return (1.0 / (4 * np.pi * sigma_b)) * u / dist

        return fem.function_integral(self.sol, integrand, degree=4)

    # -- production electrode path --------------------------------------
    def electrode_weights(self, points, degree: int = 4, cells_per_chunk: int = 1 << 20) -> torch.Tensor:
        """Device-resident ``[n_electrodes, n]`` weight matrix W with
        ``phi_e = W @ Im`` (:func:`electrode_weight_matrix`)."""
        return electrode_weight_matrix(
            self.V,
            points,
            sigma_b=self.sigma_b,
            degree=degree,
            device=self.device,
            dtype=self.dtype,
            cells_per_chunk=cells_per_chunk,
        )

    def register_electrodes(self, points, degree: int = 4) -> None:
        """Precompute and hold device electrode weights for
        :meth:`electrode_potentials`."""
        self._electrode_W = self.electrode_weights(points, degree=degree)

    def electrode_potentials(self, im: torch.Tensor | None = None) -> np.ndarray:
        """``[n_electrodes]`` potentials from the device-resident Im of the
        last :meth:`solve_device`/:meth:`solve` (or an explicit ``im``).
        Only these scalars cross to the host."""
        if self._electrode_W is None:
            raise RuntimeError("call register_electrodes(points) first")
        if im is None:
            if self._im_device is None:
                raise RuntimeError("no recovered Im yet; call solve_device() first")
            im = self._im_device
        self.host_syncs += 1
        return torch.matmul(self._electrode_W, im).cpu().numpy()


def electrode_weight_matrix(
    V,
    points,
    sigma_b: float = 1.0,
    degree: int = 4,
    device=None,
    dtype=None,
    cells_per_chunk: int = 1 << 20,
) -> torch.Tensor:
    """Device-resident ``[n_electrodes, n]`` weight matrix W with
    ``phi_e = W @ Im``.

    The electrode integral is linear in Im, so its quadrature collapses
    into per-dof weights ``W[e, j] = Σ_cells Σ_q w_q N_j(q) / (4 pi
    sigma_b |x_q - p_e|)``, computed on ``device`` (the card unless the CPU
    is named) in chunks of ``cells_per_chunk`` cells, one electrode at a
    time (``[B, nq]`` intermediates).  The per-cell contributions go to one
    slot per (cell, local dof); each dof then sums its slots in slot order
    through a table built once by a stable sort of the cell dofs, so W is
    the same bits run after run (no scatter with float atomics)."""
    dev = resolve_device(device)
    dt_ = dtype or default_dtype(dev)
    mesh = V.mesh
    tdim, gdim = mesh.tdim, mesh.gdim
    pts, wts = simplex_rule(tdim, degree)  # [nq, tdim], [nq]
    N = V.element.tabulate(tdim, pts)  # [nq, nd]
    P = np.zeros((len(points), gdim))
    for e, p in enumerate(points):
        P[e, : min(len(p), gdim)] = np.asarray(p, dtype=np.float64)[:gdim]
    n_e, (nq, nd) = P.shape[0], N.shape
    nc, n = mesh.num_cells, V.ndofs

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt_)

    coords, pts_t, wts_t, N_t, P_t = (on_dev(a) for a in (mesh.coords, pts, wts, N, P))
    scale = 1.0 / (4.0 * math.pi * float(sigma_b))
    slots = torch.zeros(n_e, nc * nd + 1, dtype=dt_, device=dev)  # the last slot stays 0
    B = max(1, min(cells_per_chunk, nc))
    for c0 in range(0, nc, B):
        c1 = min(c0 + B, nc)
        verts = coords[torch.as_tensor(mesh.cells[c0:c1], device=dev).long()]  # [b, tdim+1, gdim]
        edges = verts[:, 1:, :] - verts[:, :1, :]  # [b, tdim, gdim]
        # Gram-determinant volume: covers gdim == tdim and embedded cells
        G = torch.einsum("cik,cjk->cij", edges, edges)
        if tdim == 1:
            detG = G[:, 0, 0]
        elif tdim == 2:
            detG = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 1, 0]
        else:
            detG = (
                G[:, 0, 0] * (G[:, 1, 1] * G[:, 2, 2] - G[:, 1, 2] * G[:, 2, 1])
                - G[:, 0, 1] * (G[:, 1, 0] * G[:, 2, 2] - G[:, 1, 2] * G[:, 2, 0])
                + G[:, 0, 2] * (G[:, 1, 0] * G[:, 2, 1] - G[:, 1, 1] * G[:, 2, 0])
            )
        # rule weights sum to the reference simplex volume 1/tdim!, so the
        # physical quadrature weight is sqrt(det G) * w_q
        wq = torch.sqrt(torch.abs(detG))[:, None] * wts_t[None, :]  # [b, nq]
        xq = verts[:, :1, :] + torch.einsum("qd,cdg->cqg", pts_t, edges)  # [b, nq, gdim]
        for e in range(n_e):
            inv_r = 1.0 / torch.sqrt(torch.sum((xq - P_t[e]) ** 2, dim=-1))  # [b, nq]
            contrib = scale * torch.einsum("bq,bq,qd->bd", inv_r, wq, N_t)  # [b, nd]
            slots[e, c0 * nd : c1 * nd] = contrib.reshape(-1)
    # each dof's slots, in slot order, padded with the zero slot
    flat = torch.as_tensor(V.cell_dofs.reshape(-1), device=dev).long()
    dof_sorted, order = torch.sort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat.numel(), device=dev) - starts[dof_sorted]
    table = torch.full((n, int(counts.max())), nc * nd, dtype=torch.long, device=dev)
    table[dof_sorted, pos] = order
    return torch.stack([slots[e][table].sum(dim=1) for e in range(n_e)])


def _check_attr(attr) -> None:
    if attr is None:
        raise AttributeError(f"Missing attribute {attr}")


class Leads12(NamedTuple):
    """Standard 12-lead ECG algebra from electrode potentials
    (Einthoven I/II/III, Wilson central terminal, Goldberger augmented
    leads, precordial V1-V6); reference ``ecg.py:307-396``."""

    RA: np.ndarray
    LA: np.ndarray
    LL: np.ndarray
    RL: np.ndarray | None = None
    V1: np.ndarray | None = None
    V2: np.ndarray | None = None
    V3: np.ndarray | None = None
    V4: np.ndarray | None = None
    V5: np.ndarray | None = None
    V6: np.ndarray | None = None

    @property
    def I(self) -> np.ndarray:  # noqa: E743
        """LA - RA."""
        return self.LA - self.RA

    @property
    def II(self) -> np.ndarray:
        """LL - RA."""
        return self.LL - self.RA

    @property
    def III(self) -> np.ndarray:
        """LL - LA."""
        return self.LL - self.LA

    @property
    def Vw(self) -> np.ndarray:
        """Wilson's central terminal: mean of the limb electrodes."""
        return (1 / 3) * (self.RA + self.LA + self.LL)

    @property
    def aVR(self) -> np.ndarray:
        return (3 / 2) * (self.RA - self.Vw)

    @property
    def aVL(self) -> np.ndarray:
        return (3 / 2) * (self.LA - self.Vw)

    @property
    def aVF(self) -> np.ndarray:
        return (3 / 2) * (self.LL - self.Vw)

    @property
    def V1_(self) -> np.ndarray:
        _check_attr(self.V1)
        return self.V1 - self.Vw

    @property
    def V2_(self) -> np.ndarray:
        _check_attr(self.V2)
        return self.V2 - self.Vw

    @property
    def V3_(self) -> np.ndarray:
        _check_attr(self.V3)
        return self.V3 - self.Vw

    @property
    def V4_(self) -> np.ndarray:
        _check_attr(self.V4)
        return self.V4 - self.Vw

    @property
    def V5_(self) -> np.ndarray:
        _check_attr(self.V5)
        return self.V5 - self.Vw

    @property
    def V6_(self) -> np.ndarray:
        _check_attr(self.V6)
        return self.V6 - self.Vw


def example(
    sampling_rate_hz: int = 1000,
    duration_s: float = 10,
    heart_rate_bpm: float = 60,
    q_offset_ms: float = 40,
    s_offset_ms: float = 40,
    t_peak_offset_ms: float = 200,
    r_width_ms: float = 20,
    q_width_ms: float = 20,
    s_width_ms: float = 30,
    t_width_ms: float = 60,
    qrs_peak_time: float = 200,
    noise_amplitude: float = 0.0,
    wander_freq_hz: float = 0.2,
    wander_amplitude: float = 0.1,
):
    """Synthetic Gaussian-wave ECG (behavioral match of reference
    ``ecg.py:399-499``): each beat is four Gaussian deflections — Q, R, S,
    T — placed relative to its R peak, vectorized over a ``[beat, wave,
    time]`` broadcast instead of a per-beat accumulation loop.  Optional
    white noise and sinusoidal baseline wander on top.

    Returns ``(t_ms, signal)``.
    """
    rr_ms = 60_000.0 / heart_rate_bpm
    n_beats = int(duration_s * heart_rate_bpm / 60.0)
    t_ms = np.arange(int(duration_s * sampling_rate_hz)) * (1000.0 / sampling_rate_hz)

    # per-wave (amplitude, offset-from-R, width) rows: Q, R, S, T
    amp = np.array([-0.2, 1.0, -0.3, 0.4])
    off = np.array([-q_offset_ms, 0.0, s_offset_ms, t_peak_offset_ms])
    wid = np.array([q_width_ms, r_width_ms, s_width_ms, t_width_ms])

    r_times = (np.arange(n_beats) + qrs_peak_time / 1000.0) * rr_ms  # [beat]
    z = (t_ms[None, None, :] - (r_times[:, None] + off[None, :])[..., None]) / wid[
        None, :, None
    ]
    signal = np.einsum("w,bwt->t", amp, np.exp(-z * z))

    if noise_amplitude > 0:
        signal = signal + noise_amplitude * np.random.randn(t_ms.size)
    signal = signal + wander_amplitude * np.sin(2e-3 * np.pi * wander_freq_hz * t_ms)
    return t_ms, signal
