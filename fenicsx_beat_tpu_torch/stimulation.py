"""Stimulus protocols: measures, unit-aware amplitudes, activation patterns.

Port of ``fenicsx_beat_tpu/stimulation.py``.  A :class:`TimeWindow`
stimulus is a 0/1 window in time times a fixed spatial load, so the load
is assembled once on the host (:func:`separable_stimulus_terms`) and the
solvers evaluate only the window per step.  Any other stimulus is a
general space-time expression: a callable ``expr(x, t) -> value`` on
torch tensors, ``x`` shaped ``[gdim, ...]`` and ``t`` a 0-d tensor
(scalars are wrapped as constants), evaluated at the quadrature points on
the solver's device each step (``fem.CellQuadData.assemble_load``); the
random activation pattern (:func:`generate_random_activation`) is one.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np

import torch

from .mesh import Mesh, MeshTags
from .units import Quantity, ureg

logger = logging.getLogger(__name__)

__all__ = [
    "Measure",
    "dx",
    "ds",
    "Stimulus",
    "TimeWindow",
    "compute_effective_dim",
    "get_dZ",
    "convert_amplitude",
    "compute_stimulus_unit",
    "convert_chi",
    "define_stimulus",
    "stimulus_quadratures",
    "separable_stimulus_terms",
    "near",
    "RandomActivation",
    "generate_random_activation",
]


# ---------------------------------------------------------------------------
# Measures (replaces ufl.Measure; reference get_dZ at stimulation.py:63-111)


@dataclass(frozen=True)
class Measure:
    kind: str  # "cell" | "exterior_facet"
    mesh: Mesh
    subdomain_data: MeshTags | None = None
    subdomain_id: int | None = None
    metadata: dict | None = None

    def __call__(self, subdomain_id: int) -> "Measure":
        return replace(self, subdomain_id=subdomain_id)

    def integral_type(self) -> str:
        return self.kind

    def entities(self) -> np.ndarray:
        """Entity (cell or facet) indices this measure integrates over."""
        if self.subdomain_data is not None and self.subdomain_id is not None:
            return self.subdomain_data.find(self.subdomain_id)
        if self.kind == "cell":
            return np.arange(self.mesh.num_cells)
        return self.mesh.exterior_facets()


def dx(domain: Mesh, subdomain_data: MeshTags | None = None, metadata: dict | None = None) -> Measure:
    return Measure("cell", domain, subdomain_data, None, metadata)


def ds(domain: Mesh, subdomain_data: MeshTags | None = None, metadata: dict | None = None) -> Measure:
    return Measure("exterior_facet", domain, subdomain_data, None, metadata)


# ---------------------------------------------------------------------------
# Stimulus expression objects


@dataclass
class TimeWindow:
    """``amplitude`` if start <= t <= start+duration else 0.

    Mirrors the conditional window built at reference
    ``stimulation.py:270``.  ``amplitude`` is mutable to support
    ``Stimulus.assign`` (``stimulation.py:23-24``).
    """

    amplitude: float
    start: float = 0.0
    duration: float = 2.0

    def __call__(self, x, t):
        return self.amplitude * self.indicator(x, t)

    def indicator(self, x, t):
        """0/1 window with the amplitude factored out."""
        on = (t >= self.start) and (t <= self.start + self.duration)
        return (1.0 if on else 0.0) * np.ones_like(x[0])


class Stimulus(NamedTuple):
    """(expr, measure, marker) — API-compatible with reference
    ``stimulation.py:14-24``; ``expr`` is a callable ``(x, t) -> value``
    or a scalar."""

    expr: object
    dZ: Measure
    marker: int | None = None

    @property
    def dz(self) -> Measure:
        if self.marker is None:
            return self.dZ
        return self.dZ(self.marker)

    def assign(self, amp: float) -> None:
        self.expr.amplitude = amp


def _transform_I_s(I_s, dZ: Measure) -> list[Stimulus]:
    """Normalize the stimulus argument to a list of Stimulus
    (mirrors reference ``base_model.py:33-45``)."""
    if I_s is None:
        return []
    if isinstance(I_s, Stimulus):
        return [I_s]
    if callable(I_s) or np.isscalar(I_s):
        return [Stimulus(expr=I_s, dZ=dZ)]
    return list(I_s)


def _as_expr(expr):
    """Wrap scalars as constant space-time callables of torch tensors."""
    if callable(expr):
        return expr
    val = float(expr)
    return lambda x, t: val * torch.ones_like(x[0])


def stimulus_quadratures(V, stimuli, degree: int = 4, dtype=None):
    """Quadrature triples ``(quad, expr, stim)`` for a list of
    :class:`Stimulus`: the entities of each measure, cell or facet
    quadrature by its integral type, and the expression: a TimeWindow's
    0/1 ``indicator`` with ``stim`` its Stimulus (the live amplitude
    multiplies the window), any other expression (scalars wrapped as
    constants) with ``stim`` None.  Empty measures are skipped."""
    from . import fem  # lazy: fem imports ops that import the models

    dtype = dtype or np.float64
    out = []
    for s in stimuli:
        measure = s.dz
        ents = measure.entities()
        if len(ents) == 0:
            continue
        if measure.integral_type() == "cell":
            quad = fem.cell_quadrature(V, ents, degree=degree, dtype=dtype)
        else:
            quad = fem.facet_quadrature(V, ents, degree=degree, dtype=dtype)
        if isinstance(s.expr, TimeWindow):
            out.append((quad, s.expr.indicator, s))
        else:
            out.append((quad, _as_expr(s.expr), None))
    return out


def separable_stimulus_terms(stim_quads):
    """Shared precompute of separable (TimeWindow) stimulus terms.

    ``stim_quads``: list of ``(quad, expr, stim)`` where ``stim`` is the
    originating :class:`Stimulus` for TimeWindow entries and ``None``
    otherwise.  Returns ``(terms, b_units_host)`` with ``terms`` entries
    ``(slot, quad, expr, b_idx, window)``: separable entries carry
    ``b_idx`` into ``b_units_host`` and ``window = (start, duration)``;
    general entries carry their quadrature tables and expression.
    """
    terms, b_units = [], []
    for i, (quad, expr, stim) in enumerate(stim_quads):
        if stim is not None:
            window = (float(stim.expr.start), float(stim.expr.duration))
            terms.append((i, None, None, len(b_units), window))
            b_units.append(np.asarray(quad.assemble_load_host()))
        else:
            terms.append((i, quad, expr, None, None))
    return terms, b_units


# ---------------------------------------------------------------------------
# Effective dimension & unit conversions (mirror stimulation.py:27-207)


def compute_effective_dim(mesh: Mesh, subdomain_data: MeshTags) -> int:
    dim = subdomain_data.dim
    if mesh.tdim == 3:
        return dim
    elif mesh.tdim == 2:
        return dim + 1
    elif mesh.tdim == 1:
        return dim + 2
    raise ValueError("Invalid mesh topology dimension")


def get_dZ(mesh: Mesh, subdomain_data: MeshTags) -> Measure:
    dim = subdomain_data.dim
    if dim == mesh.tdim - 1:
        if mesh.tdim <= 1:
            raise ValueError("Invalid mesh topology dimension")
        return Measure("exterior_facet", mesh, subdomain_data)
    elif dim == mesh.tdim:
        return Measure("cell", mesh, subdomain_data)
    raise ValueError("Invalid subdomain data dimension")


def convert_amplitude(effective_dim: int, amplitude: float | Quantity) -> Quantity:
    if isinstance(amplitude, Quantity):
        return amplitude
    if effective_dim <= 1:
        unit = ureg("uA / cm")
    elif effective_dim == 2:
        unit = ureg("uA / cm**2")
    elif effective_dim == 3:
        unit = ureg("uA / cm**3")
    else:
        raise ValueError(f"Invalid effective dimension {effective_dim}. Must be 0, 1, 2 or 3.")
    logger.debug(f"Assuming amplitude is in {unit}")
    return amplitude * unit


def compute_stimulus_unit(effective_dim: int, mesh_unit: str) -> Quantity:
    if effective_dim < 0:
        raise ValueError("Effective dimension must be non-negative")
    if effective_dim > 3:
        raise ValueError("Effective dimension must be less than or equal to 3")
    if effective_dim == 0:
        return ureg("uA")
    return ureg(f"uA/{mesh_unit}**{effective_dim - 1}")


def convert_chi(chi: float | Quantity, mesh_unit: str) -> Quantity:
    if isinstance(chi, Quantity):
        return chi
    logger.debug(f"Assuming chi is in {mesh_unit}^-1")
    return chi * ureg(f"{mesh_unit}**-1")


def define_stimulus(
    mesh: Mesh,
    chi: float | Quantity,
    time,
    subdomain_data: MeshTags,
    marker: int,
    mesh_unit: str = "cm",
    duration: float = 2.0,
    amplitude: float = 500.0,
    start: float = 0.0,
) -> Stimulus:
    """Unit-aware stimulus definition (mirrors reference
    ``stimulation.py:210-272``): amplitude is converted to the effective
    integration dimension and divided by the surface-to-volume ratio chi."""
    effective_dim = compute_effective_dim(mesh, subdomain_data)
    chi_q = convert_chi(chi, mesh_unit)
    A = convert_amplitude(effective_dim, amplitude)
    dZ = get_dZ(mesh, subdomain_data)
    unit = compute_stimulus_unit(effective_dim, mesh_unit)
    amp = (A / chi_q).to(unit.units).magnitude
    expr = TimeWindow(amplitude=amp, start=start, duration=duration)
    return Stimulus(dZ=dZ, marker=marker, expr=expr)


def near(a, b, tol: float = 1e-12):
    """``b - tol <= a <= b + tol``, elementwise (tensors or arrays)."""
    return (a >= b - tol) & (a <= b + tol)


@dataclass
class RandomActivation:
    """Spatio-temporal activation pattern over discrete points: amplitude
    where ``x`` lies within ``tol`` of a point (every coordinate) while
    that point's delayed window holds.

    Evaluation is one broadcast over the point and delay arrays (the
    reference builds an N-term UFL conditional tree,
    ``stimulation.py:335-362``), on the device of ``x``; a numpy ``x`` (a
    function's dof coordinates, as ``fem.Function.interpolate`` passes
    them) is read on the CPU."""

    points: np.ndarray  # [N, d]
    delays: np.ndarray  # [N]
    stim_start: float = 0.0
    stim_duration: float = 2.0
    amplitude: float = 1.0
    tol: float = 1e-12

    def __call__(self, x, t) -> torch.Tensor:
        x = torch.as_tensor(x)
        P = torch.as_tensor(self.points, device=x.device).to(x.dtype)  # [N, d]
        D = torch.as_tensor(self.delays, device=x.device).to(x.dtype)  # [N]
        xd = torch.stack([x[i] for i in range(P.shape[1])], dim=-1)  # [..., d]
        near_all = ((xd[..., None, :] - P).abs() <= self.tol).all(dim=-1)  # [..., N]
        t_on = (t >= self.stim_start + D) & (t <= self.stim_start + self.stim_duration + D)  # [N]
        return self.amplitude * (near_all & t_on).any(dim=-1).to(xd.dtype)


def generate_random_activation(
    mesh: Mesh,
    time,
    points: np.ndarray,
    delays: np.ndarray,
    stim_start: float = 0.0,
    stim_duration: float = 2.0,
    stim_amplitude: float = 1.0,
    tol: float = 1e-12,
) -> RandomActivation:
    """Random multi-point (Purkinje-like) activation pattern (reference
    ``stimulation.py:279-363``) as a data-driven callable."""
    if len(points) != len(delays):
        raise AssertionError("Points and delays must have the same length")
    return RandomActivation(
        points=np.asarray(points, dtype=np.float64),
        delays=np.asarray(delays, dtype=np.float64),
        stim_start=stim_start,
        stim_duration=stim_duration,
        amplitude=stim_amplitude,
        tol=tol,
    )
