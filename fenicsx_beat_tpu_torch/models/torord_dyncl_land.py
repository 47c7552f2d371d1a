"""ToR-ORd dynCl coupled to the Land (2017) human contraction model, in
torch.

Port of ``fenicsx_beat_tpu/models/torord_dyncl_land.py`` (the published
models: J. Tomek et al., eLife 8:e48890, 2019, dynCl variant; S. Land et
al., "A model of cardiac contraction based on novel measurements of tension
development in human cardiomyocytes", JMCC 106, 2017) with the same
contract over a ``(52, n_points)`` state tensor: ``init_state_values`` /
``init_parameter_values`` / ``state_index`` / ``parameter_index`` / ``rhs``
/ ``forward_euler`` / ``generalized_rush_larsen`` and ``active_tension``,
with the same state and parameter names and order.

The ionic part is :mod:`.torord_dyncl`'s ``_compute``; Land adds 7
mechanics states (XS, XW, CaTrpn, TmB, Zetas, Zetaw, Cd), each a
diagonally linear state, and 28 parameters.  Troponin buffering leaves the
instantaneous ``Bcai`` for the CaTrpn ODE (``J_TRPN``), with the variant's
``dcai`` (``INaCa_i / 3``, no ``ICaL_i``), and ``cai`` starts at 1e-4.  The
formulas are the JAX package's, term for term, in the dtype of the states;
``parameters`` is the 136-entry vector (Python floats) or a node-aligned
``[136, n]`` field (:mod:`._common`).  The generalized Rush-Larsen step is
the plain twin of ``csrc/torord_land_grl.cu``,
``csrc/torord_land_grl_node.cu`` and ``csrc/torord_land_grl_multi.cu``
(``csrc/torord_land.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import torord_dyncl as _base
from ._common import exp, unpack_params, where_like

__all__ = [
    "init_state_values",
    "init_parameter_values",
    "state_index",
    "parameter_index",
    "rhs",
    "forward_euler",
    "generalized_rush_larsen",
    "active_tension",
]

_MECH_STATE_NAMES = ["XS", "XW", "CaTrpn", "TmB", "Zetas", "Zetaw", "Cd"]
_STATE_NAMES = _base._STATE_NAMES + _MECH_STATE_NAMES

_DEFAULT_STATES = dict(_base._DEFAULT_STATES)
_DEFAULT_STATES.update(
    {
        # the Land .ode variant re-initializes cai at 1e-4
        "cai": 0.0001,
        "XS": 0.0,
        "XW": 0.0,
        "CaTrpn": 1e-8,
        "TmB": 1.0,
        "Zetas": 0.0,
        "Zetaw": 0.0,
        "Cd": 0.0,
    }
)

_MECH_PARAM_DEFAULTS = [
    ("emcoupling", 1.0),
    ("lmbda", 1.0),
    ("dLambda", 0.0),
    ("mode", 1.0),
    ("isacs", 0.0),
    ("calib", 1.0),
    ("ktrpn", 0.1),
    ("ntrpn", 2.0),
    ("Trpn50", 0.35),
    ("rw", 0.5),
    ("rs", 0.25),
    ("gammas", 0.0085),
    ("gammaw", 0.615),
    ("phi", 2.23),
    ("Tot_A", 25.0),
    ("Beta0", 2.3),
    ("Beta1", -2.4),
    ("cat50_ref", 0.805),
    ("Tref", 120.0),
    ("kuw", 0.182),
    ("kws", 0.012),
    ("ku", 0.04),
    ("ntm", 2.4),
    ("p_a", 2.1),
    ("p_b", 9.1),
    ("p_k", 7.0),
    ("etal", 200.0),
    ("etas", 20.0),
]

_PARAM_DEFAULTS = _base._PARAM_DEFAULTS + _MECH_PARAM_DEFAULTS
_PARAM_NAMES = [n for n, _ in _PARAM_DEFAULTS]


def state_index(name: str) -> int:
    return _STATE_NAMES.index(name)


def parameter_index(name: str) -> int:
    return _PARAM_NAMES.index(name)


def init_state_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_STATE_NAMES)
    if unknown:
        raise KeyError(f"Unknown state name(s): {sorted(unknown)}")
    vals = dict(_DEFAULT_STATES)
    vals.update(overrides)
    return np.array([vals[n] for n in _STATE_NAMES], dtype=np.float64)


def init_parameter_values(**overrides) -> np.ndarray:
    unknown = set(overrides) - set(_PARAM_NAMES)
    if unknown:
        raise KeyError(f"Unknown parameter name(s): {sorted(unknown)}")
    vals = dict(_PARAM_DEFAULTS)
    vals.update(overrides)
    return np.array([vals[n] for n in _PARAM_NAMES], dtype=np.float64)


def _minimum(x, hi: float):
    return torch.clamp_max(x, hi) if isinstance(x, torch.Tensor) else min(x, hi)


def _mechanics(s, p, where):
    """Land's rates: a (x_inf, rate) pair for each mechanics state (all
    diagonally linear) and the troponin flux ``J_TRPN`` that enters
    ``dcai`` (``fenicsx_beat_tpu/models/torord_dyncl_land.py:_mechanics``)."""
    kuw, kws, ku = p["kuw"], p["kws"], p["ku"]
    rw, rs = p["rw"], p["rs"]
    kwu = kuw * (1.0 / rw - 1.0) - kws
    ksu = kws * rw * (1.0 / rs - 1.0)
    Aw = p["Tot_A"] * rs / ((1.0 - rs) * rw + rs)
    As = Aw
    cw = p["phi"] * kuw * ((1.0 - rs) * (1.0 - rw)) / ((1.0 - rs) * rw)
    cs = p["phi"] * kws * ((1.0 - rs) * rw) / rs

    lam = _minimum(p["lmbda"], 1.2)
    CaTrpn = torch.clamp_min(s["CaTrpn"], 0.0)

    gammawu = p["gammaw"] * torch.abs(s["Zetaw"])
    # distortion-dependent detachment: Zetas above 0 or below -1
    zs_pos = where(s["Zetas"] > 0.0, s["Zetas"], 0.0)
    zs_neg = where(s["Zetas"] < -1.0, -s["Zetas"] - 1.0, 0.0)
    gammasu = p["gammas"] * torch.maximum(zs_pos, zs_neg)

    cat50 = p["cat50_ref"] + p["Beta1"] * (lam - 1.0)
    catn = (s["cai"] * 1000.0 / cat50) ** p["ntrpn"]
    kb = ku * p["Trpn50"] ** p["ntm"] / (1.0 - rs - (1.0 - rs) * rw)
    unbind = torch.clamp_max(CaTrpn ** (-p["ntm"] / 2.0), 100.0)
    bind = CaTrpn ** (p["ntm"] / 2.0)

    a_xw = kuw + kwu + kws + gammawu
    a_tmb = kb * unbind + ku * bind
    linear = {
        "XS": (kws * s["XW"] / (ksu + gammasu), ksu + gammasu),
        "XW": (kuw * (1.0 - s["TmB"] - s["XS"]) / a_xw, a_xw),
        "CaTrpn": (catn / (catn + 1.0), p["ktrpn"] * (catn + 1.0)),
        "TmB": (kb * unbind * (1.0 - s["XS"] - s["XW"]) / a_tmb, a_tmb),
        "Zetas": (As * p["dLambda"] / cs, cs),
        "Zetaw": (Aw * p["dLambda"] / cw, cw),
    }
    # Cd relaxes toward C = lam - 1 with a state-dependent viscosity
    C = lam - 1.0
    eta = where(C - s["Cd"] < 0.0, p["etas"], p["etal"])
    linear["Cd"] = (C, p["p_k"] / eta)

    dCaTrpn = p["ktrpn"] * (catn * (1.0 - s["CaTrpn"]) - s["CaTrpn"])
    return linear, dCaTrpn * p["trpnmax"]


def _compute(states, t, p):
    s = {name: states[i] for i, name in enumerate(_STATE_NAMES)}
    gates, linear, explicit, aux = _base._compute(states[: len(_base._STATE_NAMES)], t, p)
    mech_linear, J_TRPN = _mechanics(s, p, where_like(states))
    linear = {**linear, **mech_linear}

    # Land-variant dcai: troponin buffering through CaTrpn, INaCa_i / 3, no ICaL_i
    b_cmdn = p["kmcmdn"] + s["cai"]
    Bcai = 1.0 / (1.0 + aux["cmdnmax"] * p["kmcmdn"] / (b_cmdn * b_cmdn))
    dcai = Bcai * (
        -(aux["IpCa"] + aux["ICab"] - 2.0 * aux["INaCa_i"] / 3.0) * aux["Acap"] / (2.0 * p["F"] * aux["vmyo"])
        - aux["Jup"] * aux["vnsr"] / aux["vmyo"]
        + aux["Jdiff"] * aux["vss"] / aux["vmyo"]
        - J_TRPN
    )
    explicit = {**explicit, "cai": dcai}
    return gates, linear, explicit


def active_tension(states, parameters):
    """Land's active and passive tension ``(Ta, Tp, Ttot)`` of the states
    (a vector or a node-aligned field of parameters, as the steps take)."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    s = {name: states[i] for i, name in enumerate(_STATE_NAMES)}
    where = where_like(states)
    lam = _minimum(p["lmbda"], 1.2)
    lam087 = _minimum(lam, 0.87)
    h_prima = 1.0 + p["Beta0"] * (lam + lam087 - 1.87)
    h_lambda = torch.clamp_min(h_prima, 0.0) if isinstance(h_prima, torch.Tensor) else max(h_prima, 0.0)
    Ta = h_lambda * (p["Tref"] / p["rs"]) * (s["XS"] * (s["Zetas"] + 1.0) + s["XW"] * s["Zetaw"])
    C = lam - 1.0
    dCd = C - s["Cd"]
    Fd = where(dCd < 0.0, p["etas"], p["etal"]) * dCd
    F1 = exp(p["p_b"] * C) - 1.0
    Tp = p["p_a"] * (F1 + Fd)
    return Ta, Tp, Ta + Tp


def rhs(states: torch.Tensor, t, parameters) -> torch.Tensor:
    """Full right-hand side d(states)/dt, shape (52, n)."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    gates, linear, explicit = _compute(states, t, p)
    out = []
    for i, name in enumerate(_STATE_NAMES):
        x = states[i]
        if name in gates:
            x_inf, tau = gates[name]
            out.append((x_inf - x) / tau)
        elif name in linear:
            x_inf, rate = linear[name]
            out.append((x_inf - x) * rate)
        else:
            out.append(explicit[name])
    return torch.stack(out)


def forward_euler(states: torch.Tensor, t, parameters, dt, **kwargs) -> torch.Tensor:
    return states + dt * rhs(states, t, parameters)


def generalized_rush_larsen(states: torch.Tensor, t, parameters, dt, **kwargs) -> torch.Tensor:
    """Generalized Rush-Larsen step: the exponential update for ToR-ORd's
    26 gates and 7 linear states and Land's 7 mechanics states, the
    explicit update for V and the concentrations.  ``t`` and ``dt`` are
    Python floats (``t`` may be a 0-d tensor)."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    gates, linear, explicit = _compute(states, t, p)
    out = []
    for i, name in enumerate(_STATE_NAMES):
        x = states[i]
        if name in gates:
            x_inf, tau = gates[name]
            out.append(x_inf + (x - x_inf) * exp(-dt / tau))
        elif name in linear:
            x_inf, rate = linear[name]
            out.append(x_inf + (x - x_inf) * exp(-dt * rate))
        else:
            out.append(x + dt * explicit[name])
    return torch.stack(out)
