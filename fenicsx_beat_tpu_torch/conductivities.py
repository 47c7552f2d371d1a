"""Conductivity presets and anisotropic tensors.

TPU-native counterpart of reference ``src/beat/conductivities.py``.  The
reference represents the tensor symbolically via UFL
(``conductivities.py:101-104``); here :class:`ConductivityTensor` carries
the data (s_l, s_t, fiber field) and materializes per-cell ``[nc, g, g]``
numpy tensors consumed by the stiffness assembly.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from .units import Quantity, to_quantity, ureg

logger = logging.getLogger(__name__)

__all__ = [
    "get_dimension",
    "default_conductivities",
    "Conductivities",
    "get_harmonic_mean_conductivity",
    "ConductivityTensor",
    "conductivity_tensor",
    "define_conductivity_tensor",
    "as_cell_tensors",
]


def get_dimension(u) -> int:
    """Geometric dimension of a fiber vector/field (reference
    ``conductivities.py:13-26``)."""
    try:
        return int(np.asarray(u).shape[-1])
    except Exception as ex:
        logger.warning(ex)
        logger.warning("Assume dimension is 3")
        return 3


def default_conductivities(name: str = "Niederer") -> dict[str, Quantity]:
    """Literature presets (reference ``conductivities.py:29-55``)."""
    if name == "Niederer":
        return {
            "g_il": 0.17 * ureg("S/m"),
            "g_it": 0.019 * ureg("S/m"),
            "g_el": 0.62 * ureg("S/m"),
            "g_et": 0.24 * ureg("S/m"),
            "chi": 1400.0 * ureg("cm**-1"),
        }
    elif name == "Bishop":
        return {
            "g_il": 0.34 * ureg("S/m"),
            "g_it": 0.060 * ureg("S/m"),
            "g_el": 0.12 * ureg("S/m"),
            "g_et": 0.08 * ureg("S/m"),
            "chi": 1400.0 * ureg("cm**-1"),
        }
    elif name == "Potse":
        return {
            "g_il": 3.0 * ureg("mS/cm"),
            "g_it": 0.3 * ureg("mS/cm"),
            "g_el": 3.0 * ureg("mS/cm"),
            "g_et": 1.2 * ureg("mS/cm"),
            "chi": 800.0 * ureg("cm**-1"),
        }
    raise ValueError(f"Unknown conductivity tensor {name}")


class Conductivities(NamedTuple):
    s_l: float
    s_t: float


def get_harmonic_mean_conductivity(
    chi,
    g_il=0.17,
    g_it=0.019,
    g_el=0.62,
    g_et=0.24,
) -> Conductivities:
    """Monodomain harmonic mean of intra/extracellular conductivities,
    scaled by 1/chi to uA/mV (reference ``conductivities.py:63-98``)."""
    sigma_il = to_quantity(g_il, "S/m")
    sigma_it = to_quantity(g_it, "S/m")
    sigma_el = to_quantity(g_el, "S/m")
    sigma_et = to_quantity(g_et, "S/m")

    def harmonic_mean(a, b):
        return a * b / (a + b)

    sigma_l = harmonic_mean(sigma_il, sigma_el)
    sigma_t = harmonic_mean(sigma_it, sigma_et)
    logger.info(f"Harmonic mean conductivities {sigma_l=} {sigma_t=}")

    s_l = (sigma_l / chi).to("uA/mV").magnitude
    s_t = (sigma_t / chi).to("uA/mV").magnitude
    logger.info(f"Scaled harmonic mean conductivities {s_l=} {s_t=}")
    return Conductivities(s_l, s_t)


@dataclass
class ConductivityTensor:
    """M = s_l f0⊗f0 + s_t (I − f0⊗f0); f0 constant vector or per-cell
    field (reference builds this in UFL at ``conductivities.py:101-104``)."""

    s_l: float
    s_t: float
    f0: np.ndarray  # [g] or [nc, g]

    def cell_tensors(self, mesh) -> np.ndarray:
        f0 = np.asarray(self.f0, dtype=np.float64)
        g = mesh.gdim
        if f0.ndim == 1:
            outer = np.outer(f0, f0)
            return self.s_l * outer + self.s_t * (np.eye(g) - outer)
        if f0.shape[0] == mesh.num_vertices and f0.shape[0] != mesh.num_cells:
            # vertex field -> per-cell average direction
            f0 = f0[mesh.cells].mean(axis=1)
            norms = np.linalg.norm(f0, axis=1, keepdims=True)
            f0 = f0 / np.where(norms > 0, norms, 1.0)
        outer = np.einsum("ci,cj->cij", f0, f0)
        return self.s_l * outer + self.s_t * (np.eye(g)[None] - outer)


def conductivity_tensor(s_l: float, s_t: float, f0) -> ConductivityTensor:
    f0_arr = np.asarray(f0, dtype=np.float64)
    dim = get_dimension(f0_arr)
    logger.info(f"Define conductivity tensor {s_l=} {s_t=} {dim=}")
    return ConductivityTensor(s_l=float(s_l), s_t=float(s_t), f0=f0_arr)


def define_conductivity_tensor(
    chi,
    f0,
    g_il=0.17,
    g_it=0.019,
    g_el=0.62,
    g_et=0.24,
) -> ConductivityTensor:
    """Reference ``conductivities.py:107-118``."""
    if f0 is None:
        raise ValueError("f0 must be provided")
    s_l, s_t = get_harmonic_mean_conductivity(chi, g_il, g_it, g_el, g_et)
    return conductivity_tensor(s_l, s_t, f0)


def as_cell_tensors(M, mesh):
    """Normalize any accepted conductivity spec to scalar / [g,g] /
    [nc,g,g] numpy for assembly."""
    if isinstance(M, ConductivityTensor):
        return M.cell_tensors(mesh)
    if hasattr(M, "cell_tensors"):
        return M.cell_tensors(mesh)
    if hasattr(M, "value"):  # fem.Constant
        M = M.value
    arr = np.asarray(M, dtype=np.float64)
    return arr
