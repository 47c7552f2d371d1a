"""Tomek-Rodriguez-O'Hara-Rudy (ToR-ORd) human ventricular model, dynCl
variant (dynamic intracellular/subspace chloride), in torch.

Port of ``fenicsx_beat_tpu/models/torord_dyncl.py`` (the published model:
J. Tomek et al., "Development, calibration, and validation of a novel
human ventricular myocyte model in health, disease, and drug block",
eLife 8:e48890, 2019; dynCl update 2020) with the same contract:
``init_state_values`` / ``init_parameter_values`` / ``state_index`` /
``parameter_index`` / ``rhs`` / ``forward_euler`` /
``generalized_rush_larsen`` over a ``(45, n_points)`` state tensor, and the
same state and parameter names and order.  ``celltype`` 0=endo, 1=epi,
2=mid switches the published transmural scalings.

The formulas are the JAX package's, term for term: the same GHK driving
force with its ``|x| < 1e-5`` series branch, the same ``where`` splits on
``v``, the same pacing window.  They run in the dtype of the states.
``parameters`` is the 108-entry vector (each entry a Python float, as the
JAX kernel bakes them) or a node-aligned ``[108, n]`` field (each entry a
row, the per-node parameter form, :mod:`._common`).  The generalized Rush-Larsen step is the
plain twin of the CUDA kernels ``csrc/torord_grl.cu``,
``csrc/torord_grl_node.cu`` and ``csrc/torord_grl_multi.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import exp, floor, log, maximum, sqrt, unpack_params, where_like

__all__ = [
    "init_state_values",
    "init_parameter_values",
    "state_index",
    "parameter_index",
    "rhs",
    "forward_euler",
    "generalized_rush_larsen",
]

_STATE_NAMES = [
    "v",
    "CaMKt",
    "cai",
    "cass",
    "cansr",
    "cajsr",
    "cli",
    "clss",
    "ki",
    "kss",
    "nai",
    "nass",
    "m",
    "h",
    "hp",
    "j",
    "jp",
    "mL",
    "hL",
    "hLp",
    "a",
    "ap",
    "iF",
    "iS",
    "iFp",
    "iSp",
    "d",
    "ff",
    "fs",
    "fcaf",
    "fcas",
    "jca",
    "ffp",
    "fcafp",
    "nca_ss",
    "nca_i",
    "C1",
    "C2",
    "C3",
    "O",
    "I",
    "xs1",
    "xs2",
    "Jrel_np",
    "Jrel_p",
]

# Published endo initial conditions (odes/torord/ToRORd_dynCl_endo.ode states)
_DEFAULT_STATES = {
    "v": -89.74808,
    "CaMKt": 1.095026e-2,
    "cai": 7.453481e-5,
    "cass": 6.497341e-5,
    "cansr": 1.528001,
    "cajsr": 1.525693,
    "cli": 29.20698,
    "clss": 29.20696,
    "ki": 147.7115,
    "kss": 147.7114,
    "nai": 12.39736,
    "nass": 12.3977,
    "m": 6.517154e-4,
    "h": 0.8473267,
    "hp": 0.7018454,
    "j": 0.8471657,
    "jp": 0.8469014,
    "mL": 1.351203e-4,
    "hL": 0.5566017,
    "hLp": 0.3115491,
    "a": 8.899259e-4,
    "ap": 4.534165e-4,
    "iF": 0.9996716,
    "iS": 0.5988908,
    "iFp": 0.9996716,
    "iSp": 0.6620692,
    "d": 1.588841e-31,
    "ff": 1.0,
    "fs": 0.9401791,
    "fcaf": 1.0,
    "fcas": 0.9999014,
    "jca": 0.9999846,
    "ffp": 1.0,
    "fcafp": 1.0,
    "nca_ss": 4.899378e-4,
    "nca_i": 8.326009e-4,
    "C1": 0.9982511,
    "C2": 7.93602e-4,
    "C3": 6.532143e-4,
    "O": 2.922449e-4,
    "I": 9.804083e-6,
    "xs1": 0.243959,
    "xs2": 1.586167e-4,
    "Jrel_np": 1.808248e-22,
    "Jrel_p": 4.358608e-21,
}

_PARAM_DEFAULTS = [
    # physical constants
    ("F", 96485.0),
    ("R", 8314.0),
    ("T", 310.0),
    # extracellular
    ("cao", 1.8),
    ("clo", 150.0),
    ("ko", 5.0),
    ("nao", 140.0),
    # cell geometry
    ("L", 0.01),
    ("rad", 0.0011),
    # CaMK
    ("CaMKo", 0.05),
    ("KmCaM", 0.0015),
    ("KmCaMK", 0.15),
    ("aCaMK", 0.05),
    ("bCaMK", 0.00068),
    # buffers
    ("BSLmax", 1.124),
    ("BSRmax", 0.047),
    ("KmBSL", 0.0087),
    ("KmBSR", 0.00087),
    ("cmdnmax_b", 0.05),
    ("csqnmax", 10.0),
    ("kmcmdn", 0.00238),
    ("kmcsqn", 0.8),
    ("kmtrpn", 0.0005),
    ("trpnmax", 0.07),
    # INa / INaL
    ("GNa", 11.7802),
    ("GNaL_b", 0.0279),
    ("thL", 200.0),
    # Ito
    ("EKshift", 0.0),
    ("Gto_b", 0.16),
    # ICaL
    ("Aff", 0.6),
    ("ICaL_fractionSS", 0.8),
    ("Kmn", 0.002),
    ("PCa_b", 8.3757e-05),
    ("dielConstant", 74.0),
    ("k2n", 500.0),
    ("offset", 0.0),
    ("tjca", 72.5),
    ("vShift", 0.0),
    # IKr
    ("GKr_b", 0.0321),
    ("alpha_1", 0.154375),
    ("beta_1", 0.1911),
    # IKs
    ("GKs_b", 0.0011),
    # IK1
    ("GK1_b", 0.6992),
    # INaCa
    ("Gncx_b", 0.0034),
    ("INaCa_fractionSS", 0.35),
    ("KmCaAct", 0.00015),
    ("kasymm", 12.5),
    ("kcaoff", 5000.0),
    ("kcaon", 1500000.0),
    ("kna1", 15.0),
    ("kna2", 5.0),
    ("kna3", 88.12),
    ("qca", 0.167),
    ("qna", 0.5224),
    ("wca", 60000.0),
    ("wna", 60000.0),
    ("wnaca", 5000.0),
    # INaK
    ("H", 1e-07),
    ("Khp", 1.698e-07),
    ("Kki", 0.5),
    ("Kko", 0.3582),
    ("Kmgatp", 1.698e-07),
    ("Knai0", 9.073),
    ("Knao0", 27.78),
    ("Knap", 224.0),
    ("Kxkur", 292.0),
    ("MgADP", 0.05),
    ("MgATP", 9.8),
    ("Pnak_b", 15.4509),
    ("delta", -0.155),
    ("eP", 4.2),
    ("k1m", 182.4),
    ("k1p", 949.5),
    ("k2m", 39.4),
    ("k2p", 687.2),
    ("k3m", 79300.0),
    ("k3p", 1899.0),
    ("k4m", 40.0),
    ("k4p", 639.0),
    # IKb / INab / ICab / IpCa
    ("GKb_b", 0.0189),
    ("PNab", 1.9239e-09),
    ("PCab", 5.9194e-08),
    ("GpCa", 0.0005),
    ("KmCap", 0.0005),
    # ICl
    ("Fjunc", 1.0),
    ("GClCa", 0.2843),
    ("GClb", 0.00198),
    ("KdClCa", 0.1),
    # I_katp
    ("A_atp", 2.0),
    ("K_atp", 0.25),
    ("K_o_n", 5.0),
    ("fkatp", 0.0),
    ("gkatp", 4.3195),
    # ryr / SERCA / fluxes
    ("Jrel_b", 1.5378),
    ("bt", 4.75),
    ("cajsr_half", 1.7),
    ("Jup_b", 1.0),
    ("tauCa", 0.2),
    ("tauCl", 2.0),
    ("tauK", 2.0),
    ("tauNa", 2.0),
    # reversal potentials
    ("PKNa", 0.01833),
    # environment
    ("celltype", 0.0),
    # pacing stimulus (0-D mode; zero in tissue mode)
    ("i_Stim_Amplitude", -53.0),
    ("i_Stim_Start", 0.0),
    ("i_Stim_End", 1e17),
    ("i_Stim_Period", 1000.0),
    ("i_Stim_PulseDuration", 1.0),
]

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


def _ghk(z, ci_gamma, co_gamma, vfrt, F):
    """GHK driving force z*F*(x/(e^x - 1))*(ci*g_i*e^x - co*g_o), x = z*vfrt,
    guarded at x = 0 (limit z*F*(ci*g_i - co*g_o))."""
    x = z * vfrt
    small = torch.abs(x) < 1e-5
    # exp(x)-1 as the JAX package has it (not expm1); small |x| uses the series
    denom = torch.exp(torch.where(small, torch.ones_like(x), x)) - 1.0
    ratio = torch.where(small, 1.0 - 0.5 * x + x * x / 12.0, x / denom)
    return z * F * ratio * (ci_gamma * torch.exp(x) - co_gamma)


def _inaca(v, ca, na, p, vfrt, Gncx_frac, allo_cap):
    """Na/Ca exchanger flux for one compartment (i or ss); returns I [A/F].

    ``ca``/``na`` are the compartment concentrations, ``Gncx_frac`` the
    conductance already scaled by the compartment fraction."""
    hca = torch.exp(p["qca"] * vfrt)
    hna = torch.exp(p["qna"] * vfrt)
    h1 = (na / p["kna3"]) * (hna + 1.0) + 1.0
    h2 = (hna * na) / (h1 * p["kna3"])
    h3 = 1.0 / h1
    h4 = (na / p["kna1"]) * (1.0 + na / p["kna2"]) + 1.0
    h5 = (na * na) / (p["kna2"] * h4 * p["kna1"])
    h6 = 1.0 / h4
    h7 = (p["nao"] / p["kna3"]) * (1.0 + 1.0 / hna) + 1.0
    h8 = p["nao"] / (h7 * hna * p["kna3"])
    h9 = 1.0 / h7
    h10 = (p["nao"] / p["kna1"]) * (1.0 + p["nao"] / p["kna2"]) + (p["kasymm"] + 1.0)
    h11 = (p["nao"] * p["nao"]) / (p["kna2"] * h10 * p["kna1"])
    h12 = 1.0 / h10
    k1 = p["kcaon"] * p["cao"] * h12
    k2 = p["kcaoff"]
    k3p = h9 * p["wca"]
    k3pp = h8 * p["wnaca"]
    k3 = k3p + k3pp
    k4p = (h3 * p["wca"]) / hca
    k4pp = h2 * p["wnaca"]
    k4 = k4p + k4pp
    k5 = p["kcaoff"]
    k6 = p["kcaon"] * ca * h6
    k7 = p["wna"] * h2 * h5
    k8 = p["wna"] * h11 * h8
    x1 = (k2 * k4) * (k6 + k7) + (k5 * k7) * (k2 + k3)
    x2 = (k1 * k7) * (k4 + k5) + (k4 * k6) * (k1 + k8)
    x3 = (k1 * k3) * (k6 + k7) + (k6 * k8) * (k2 + k3)
    x4 = (k2 * k8) * (k4 + k5) + (k3 * k5) * (k1 + k8)
    s = x1 + x2 + x3 + x4
    E1, E2, E3, E4 = x1 / s, x2 / s, x3 / s, x4 / s
    r = p["KmCaAct"] / allo_cap
    allo = 1.0 / (r * r + 1.0)
    JncxNa = -E2 * k3pp + (E3 * k4pp + 3.0 * (-E1 * k8 + E4 * k7))
    JncxCa = -E1 * k1 + E2 * k2
    return (allo * Gncx_frac) * (2.0 * JncxCa + 1.0 * JncxNa)


def _compute(states, t, p):
    """All currents, gate (inf, tau) pairs, linear (x_inf, rate) pairs and
    explicit derivatives (``fenicsx_beat_tpu/models/torord_dyncl.py:_compute``)."""
    s = {name: states[i] for i, name in enumerate(_STATE_NAMES)}
    v = s["v"]
    where = where_like(v)

    ct = p["celltype"]
    is_epi = ct == 1.0
    is_mid = ct == 2.0

    F, R, T = p["F"], p["R"], p["T"]
    vfrt = F * v / (R * T)

    # cell geometry
    L, rad = p["L"], p["rad"]
    pi = 3.14
    Ageo = L * (2.0 * pi * rad) + rad * (2.0 * pi * rad)
    Acap = 2.0 * Ageo
    vcell = 1000.0 * pi * rad * rad * L
    vmyo = 0.68 * vcell
    vnsr = 0.0552 * vcell
    vjsr = 0.0048 * vcell
    vss = 0.02 * vcell

    # CaMK
    CaMKb = (p["CaMKo"] * (1.0 - s["CaMKt"])) / (p["KmCaM"] / s["cass"] + 1.0)
    CaMKa = CaMKb + s["CaMKt"]
    dCaMKt = -s["CaMKt"] * p["bCaMK"] + (CaMKb * p["aCaMK"]) * (CaMKb + s["CaMKt"])
    f_phos = 1.0 / (1.0 + p["KmCaMK"] / CaMKa)  # shared CaMK phosphorylation factor

    # reversal potentials
    RTF = R * T / F
    ENa = RTF * log(p["nao"] / s["nai"])
    EK = RTF * log(p["ko"] / s["ki"])
    EKs = RTF * log((p["PKNa"] * p["nao"] + p["ko"]) / (p["PKNa"] * s["nai"] + s["ki"]))
    ECl = -RTF * log(p["clo"] / s["cli"])
    EClss = -RTF * log(p["clo"] / s["clss"])

    # ---- INa (fast sodium) --------------------------------------------
    em = torch.exp(-(v + 56.86) / 9.03) + 1.0
    mss = 1.0 / (em * em)
    q1, q2 = (v - 4.823) / 51.12, (v + 45.79) / 15.54
    tm = 0.06487 * torch.exp(-(q1 * q1)) + 0.1292 * torch.exp(-(q2 * q2))
    eh = torch.exp((v + 71.55) / 7.43) + 1.0
    hss = 1.0 / (eh * eh)
    ehp = torch.exp((v + 77.55) / 7.43) + 1.0
    hssp = 1.0 / (ehp * ehp)
    jss = hss
    vlo = v <= -40.0
    ah = where(vlo, 4.43126792958051e-7 * torch.exp(-0.147058823529412 * v), 0.0)
    bh = where(
        vlo,
        2.7 * torch.exp(0.079 * v) + 310000.0 * torch.exp(0.3485 * v),
        0.77
        * torch.exp(0.0900900900900901 * v)
        / (0.13 * torch.exp(0.0900900900900901 * v) + 0.0497581410839387),
    )
    aj = where(
        vlo,
        -(v + 37.78)
        * (25428.0 * torch.exp(0.28831 * v) + 6.948e-6)
        * torch.exp(-0.04391 * v)
        / (50262745825.954 * torch.exp(0.311 * v) + 1.0),
        0.0,
    )
    bj = where(
        vlo,
        0.02424 * torch.exp(0.12728 * v) / (1.0 * torch.exp(0.1378 * v) + 0.00396086833990426),
        0.6 * torch.exp(0.157 * v) / (1.0 * torch.exp(0.1 * v) + 0.0407622039783662),
    )
    th = 1.0 / (ah + bh)
    tj = 1.0 / (aj + bj)
    tjp = 1.46 * tj
    INa = (
        s["m"] * s["m"] * s["m"]
        * p["GNa"]
        * (v - ENa)
        * (s["j"] * s["h"] * (1.0 - f_phos) + s["jp"] * s["hp"] * f_phos)
    )

    # ---- INaL ----------------------------------------------------------
    mLss = 1.0 / (torch.exp(-(v + 42.85) / 5.264) + 1.0)
    tmL = tm
    hLss = 1.0 / (torch.exp((v + 87.61) / 7.488) + 1.0)
    hLssp = 1.0 / (torch.exp((v + 93.81) / 7.488) + 1.0)
    thLp = 3.0 * p["thL"]
    GNaL = where(is_epi, 0.6 * p["GNaL_b"], p["GNaL_b"])
    INaL = s["mL"] * GNaL * (v - ENa) * (s["hL"] * (1.0 - f_phos) + s["hLp"] * f_phos)

    # ---- Ito -----------------------------------------------------------
    EKshift = p["EKshift"]
    vk = EKshift + v
    ass_ = 1.0 / (torch.exp(-(vk - 14.34) / 14.82) + 1.0)
    assp = 1.0 / (torch.exp(-(vk - 24.34) / 14.82) + 1.0)
    ta = 1.0515 / (
        1.0 / (1.2089 * (torch.exp(-(vk - 18.4099) / 29.3814) + 1.0))
        + 3.5 / (torch.exp((vk + 100.0) / 29.3814) + 1.0)
    )
    iss = 1.0 / (torch.exp((vk + 43.94) / 5.711) + 1.0)
    delta_epi = where(is_epi, 1.0 - 0.95 / (torch.exp((vk + 70.0) / 5.0) + 1.0), 1.0)
    tiF_b = 4.562 + 1.0 / (
        0.3933 * torch.exp(-(vk + 100.0) / 100.0) + 0.08004 * torch.exp((vk + 50.0) / 16.59)
    )
    tiS_b = 23.62 + 1.0 / (
        0.001416 * torch.exp(-(vk + 96.52) / 59.05) + 1.78e-8 * torch.exp((vk + 114.1) / 8.079)
    )
    tiF = delta_epi * tiF_b
    tiS = delta_epi * tiS_b
    dti_develop = 1.354 + 0.0001 / (
        torch.exp(-(vk - 12.23) / 0.2154) + torch.exp((vk - 167.4) / 15.89)
    )
    dti_recover = 1.0 - 0.5 / (torch.exp((vk + 70.0) / 20.0) + 1.0)
    tiFp = tiF * dti_develop * dti_recover
    tiSp = tiS * dti_develop * dti_recover
    AiF = 1.0 / (torch.exp((vk - 213.6) / 151.2) + 1.0)
    AiS = 1.0 - AiF
    i_gate = AiF * s["iF"] + AiS * s["iS"]
    ip_gate = AiF * s["iFp"] + AiS * s["iSp"]
    Gto = where(is_epi | is_mid, 2.0 * p["Gto_b"], p["Gto_b"])
    Ito = Gto * (v - EK) * (i_gate * s["a"] * (1.0 - f_phos) + ip_gate * s["ap"] * f_phos)

    # ---- ICaL (GHK with ionic-strength activity coefficients) ----------
    dss = where(v >= 31.4978, 1.0, 1.0763 * torch.exp(-1.007 * torch.exp(-0.0829 * v)))
    td = (p["offset"] + 0.6) + 1.0 / (
        torch.exp(-0.05 * (v + p["vShift"] + 6.0)) + torch.exp(0.09 * (v + p["vShift"] + 14.0))
    )
    fss = 1.0 / (torch.exp((v + 19.58) / 3.696) + 1.0)
    tff = 7.0 + 1.0 / (0.0045 * torch.exp(-(v + 20.0) / 10.0) + 0.0045 * torch.exp((v + 20.0) / 10.0))
    tfs = 1000.0 + 1.0 / (3.5e-5 * torch.exp(-(v + 5.0) / 4.0) + 3.5e-5 * torch.exp((v + 5.0) / 6.0))
    tffp = 2.5 * tff
    Aff = p["Aff"]
    Afs = 1.0 - Aff
    f_gate = Aff * s["ff"] + Afs * s["fs"]
    fp_gate = Aff * s["ffp"] + Afs * s["fs"]
    fcass = fss
    tfcaf = 7.0 + 1.0 / (0.04 * torch.exp(-(v - 4.0) / 7.0) + 0.04 * torch.exp((v - 4.0) / 7.0))
    tfcas = 100.0 + 1.0 / (0.00012 * torch.exp(-v / 3.0) + 0.00012 * torch.exp(v / 7.0))
    tfcafp = 2.5 * tfcaf
    Afcaf = 0.3 + 0.6 / (torch.exp((v - 10.0) / 10.0) + 1.0)
    Afcas = 1.0 - Afcaf
    fca = Afcaf * s["fcaf"] + Afcas * s["fcas"]
    fcap = Afcaf * s["fcafp"] + Afcas * s["fcas"]
    jcass = 1.0 / (torch.exp((v + 18.08) / 2.7916) + 1.0)
    km2n = s["jca"] * 1.0
    ni = p["Kmn"] / s["cai"] + 1.0
    nss = p["Kmn"] / s["cass"] + 1.0
    anca_i = 1.0 / (p["k2n"] / km2n + (ni * ni) * (ni * ni))
    anca_ss = 1.0 / (p["k2n"] / km2n + (nss * nss) * (nss * nss))

    # activity coefficients (extended Debye-Huckel)
    Ii = 0.5 * (4.0 * s["cai"] + s["cli"] + s["ki"] + s["nai"]) / 1000.0
    Io = 0.5 * (4.0 * p["cao"] + p["clo"] + p["ko"] + p["nao"]) / 1000.0
    Iss = 0.5 * (4.0 * s["cass"] + s["clss"] + s["kss"] + s["nass"]) / 1000.0
    constA = 1820000.0 / (T * p["dielConstant"]) ** 1.5

    def gamma(z2, Istr):
        return exp(-constA * z2 * (sqrt(Istr) / (sqrt(Istr) + 1.0) - 0.3 * Istr))

    g_cai, g_cao, g_cass = gamma(4.0, Ii), gamma(4.0, Io), gamma(4.0, Iss)
    g_ki, g_ko, g_kss = gamma(1.0, Ii), gamma(1.0, Io), gamma(1.0, Iss)
    g_nai, g_nao, g_nass = gamma(1.0, Ii), gamma(1.0, Io), gamma(1.0, Iss)

    PhiCaL_i = _ghk(2.0, s["cai"] * g_cai, p["cao"] * g_cao, vfrt, F)
    PhiCaL_ss = _ghk(2.0, s["cass"] * g_cass, p["cao"] * g_cao, vfrt, F)
    PhiCaNa_i = _ghk(1.0, s["nai"] * g_nai, p["nao"] * g_nao, vfrt, F)
    PhiCaNa_ss = _ghk(1.0, s["nass"] * g_nass, p["nao"] * g_nao, vfrt, F)
    PhiCaK_i = _ghk(1.0, s["ki"] * g_ki, p["ko"] * g_ko, vfrt, F)
    PhiCaK_ss = _ghk(1.0, s["kss"] * g_kss, p["ko"] * g_ko, vfrt, F)

    PCa = where(is_epi, 1.2 * p["PCa_b"], where(is_mid, 2.0 * p["PCa_b"], p["PCa_b"]))
    PCap = 1.1 * PCa
    PCaNa = 0.00125 * PCa
    PCaK = 0.0003574 * PCa
    PCaNap = 0.00125 * PCap
    PCaKp = 0.0003574 * PCap
    frac_ss = p["ICaL_fractionSS"]

    def ical_pair(Phi_np, Phi_p, P_np, P_p, nca):
        mode_np = f_gate * (1.0 - nca) + nca * fca * s["jca"]
        mode_p = fp_gate * (1.0 - nca) + nca * fcap * s["jca"]
        return s["d"] * (
            Phi_np * P_np * (1.0 - f_phos) * mode_np + Phi_p * P_p * f_phos * mode_p
        )

    ICaL_i = (1.0 - frac_ss) * ical_pair(PhiCaL_i, PhiCaL_i, PCa, PCap, s["nca_i"])
    ICaL_ss = frac_ss * ical_pair(PhiCaL_ss, PhiCaL_ss, PCa, PCap, s["nca_ss"])
    ICaNa_i = (1.0 - frac_ss) * ical_pair(PhiCaNa_i, PhiCaNa_i, PCaNa, PCaNap, s["nca_i"])
    ICaNa_ss = frac_ss * ical_pair(PhiCaNa_ss, PhiCaNa_ss, PCaNa, PCaNap, s["nca_ss"])
    ICaK_i = (1.0 - frac_ss) * ical_pair(PhiCaK_i, PhiCaK_i, PCaK, PCaKp, s["nca_i"])
    ICaK_ss = frac_ss * ical_pair(PhiCaK_ss, PhiCaK_ss, PCaK, PCaKp, s["nca_ss"])
    ICaL = ICaL_i + ICaL_ss
    ICaNa = ICaNa_i + ICaNa_ss
    ICaK = ICaK_i + ICaK_ss

    # ---- IKr (5-state Markov chain) -------------------------------------
    alpha = 0.1161 * torch.exp(0.299 * vfrt)
    beta_ = 0.2442 * torch.exp(-1.604 * vfrt)
    alpha_2 = 0.0578 * torch.exp(0.971 * vfrt)
    beta_2 = 0.000349 * torch.exp(-1.062 * vfrt)
    alpha_i = 0.2533 * torch.exp(0.5953 * vfrt)
    beta_i = 0.06525 * torch.exp(-0.8209 * vfrt)
    alpha_C2ToI = 5.2e-5 * torch.exp(1.525 * vfrt)
    beta_ItoC2 = (alpha_C2ToI * beta_2 * beta_i) / (alpha_2 * alpha_i)
    GKr = where(is_epi, 1.3 * p["GKr_b"], where(is_mid, 0.8 * p["GKr_b"], p["GKr_b"]))
    IKr = s["O"] * GKr * sqrt(p["ko"] / 5.0) * (v - EK)

    # ---- IKs -------------------------------------------------------------
    xs1ss = 1.0 / (torch.exp(-(v + 11.6) / 8.932) + 1.0)
    txs1 = 817.3 + 1.0 / (
        0.0002326 * torch.exp((v + 48.28) / 17.8) + 0.001292 * torch.exp(-(v + 210.0) / 230.0)
    )
    xs2ss = xs1ss
    txs2 = 1.0 / (0.01 * torch.exp((v - 50.0) / 20.0) + 0.0193 * torch.exp(-(v + 66.54) / 31.0))
    KsCa = 1.0 + 0.6 / ((3.8e-5 / s["cai"]) ** 1.4 + 1.0)
    GKs = where(is_epi, 1.4 * p["GKs_b"], p["GKs_b"])
    IKs = s["xs1"] * s["xs2"] * GKs * KsCa * (v - EKs)

    # ---- IK1 ---------------------------------------------------------------
    aK1 = 4.094 / (torch.exp(0.1217 * (v - EK - 49.934)) + 1.0)
    bK1 = (
        15.72 * torch.exp(0.0674 * (v - EK - 3.257)) + torch.exp(0.0618 * (v - EK - 594.31))
    ) / (torch.exp(-0.1629 * (v - EK + 14.207)) + 1.0)
    K1ss = aK1 / (aK1 + bK1)
    GK1 = where(is_epi, 1.2 * p["GK1_b"], where(is_mid, 1.3 * p["GK1_b"], p["GK1_b"]))
    IK1 = K1ss * GK1 * sqrt(p["ko"] / 5.0) * (v - EK)

    # ---- INaCa -------------------------------------------------------------
    Gncx = where(is_epi, 1.1 * p["Gncx_b"], where(is_mid, 1.4 * p["Gncx_b"], p["Gncx_b"]))
    INaCa_i = _inaca(
        v, s["cai"], s["nai"], p, vfrt, Gncx * (1.0 - p["INaCa_fractionSS"]), s["cai"]
    )
    INaCa_ss = _inaca(
        v, s["cass"], s["nass"], p, vfrt, Gncx * p["INaCa_fractionSS"], s["cass"]
    )

    # ---- INaK (Smith-Crampin 4-state cycle) ---------------------------------
    Knai = p["Knai0"] * torch.exp(p["delta"] * vfrt / 3.0)
    Knao = p["Knao0"] * torch.exp((1.0 - p["delta"]) * vfrt / 3.0)
    P_ = p["eP"] / (
        (p["H"] / p["Khp"] + 1.0) + s["nai"] / p["Knap"] + s["ki"] / p["Kxkur"]
    )
    nK = s["nai"] / Knai
    kK = 1.0 + s["ki"] / p["Kki"]
    nKp = 1.0 + s["nai"] / Knai
    oK = 1.0 + p["ko"] / p["Kko"]
    nO = 1.0 + p["nao"] / Knao
    a1 = (p["k1p"] * (nK * nK * nK)) / ((kK * kK + nKp * nKp * nKp) - 1.0)
    b1 = p["MgADP"] * p["k1m"]
    a2 = p["k2p"]
    nao_K = p["nao"] / Knao
    b2 = (p["k2m"] * (nao_K * nao_K * nao_K)) / ((oK * oK + nO * nO * nO) - 1.0)
    ko_K = p["ko"] / p["Kko"]
    a3 = (p["k3p"] * (ko_K * ko_K)) / ((oK * oK + nO * nO * nO) - 1.0)
    b3 = (p["H"] * P_ * p["k3m"]) / (1.0 + p["MgATP"] / p["Kmgatp"])
    a4 = ((p["MgATP"] * p["k4p"]) / p["Kmgatp"]) / (1.0 + p["MgATP"] / p["Kmgatp"])
    ki_K = s["ki"] / p["Kki"]
    b4 = (p["k4m"] * (ki_K * ki_K)) / ((kK * kK + nKp * nKp * nKp) - 1.0)
    x1 = a2 * a1 * b3 + b3 * a2 * b4 + a2 * a1 * a4 + b3 * b2 * b4
    x2 = b4 * a2 * a3 + b4 * a3 * b1 + a3 * a1 * a2 + b4 * b1 * b2
    x3 = b1 * a3 * a4 + a4 * b1 * b2 + a4 * a2 * a3 + b1 * b2 * b3
    x4 = a1 * b2 * b3 + a1 * a4 * b2 + a1 * a3 * a4 + b2 * b3 * b4
    sx = x1 + x2 + x3 + x4
    E1, E2, E3, E4 = x1 / sx, x2 / sx, x3 / sx, x4 / sx
    JnakNa = 3.0 * (E1 * a3 - E2 * b3)
    JnakK = 2.0 * (-E3 * a1 + E4 * b1)
    Pnak = where(is_epi, 0.9 * p["Pnak_b"], where(is_mid, 0.7 * p["Pnak_b"], p["Pnak_b"]))
    INaK = Pnak * (JnakNa + JnakK)

    # ---- minor currents -----------------------------------------------------
    xkb = 1.0 / (torch.exp(-(v - 10.8968) / 23.9871) + 1.0)
    GKb = where(is_epi, 0.6 * p["GKb_b"], p["GKb_b"])
    IKb = GKb * xkb * (v - EK)
    INab = p["PNab"] * _ghk(1.0, s["nai"], p["nao"], vfrt, F)
    ICab = p["PCab"] * _ghk(2.0, s["cai"] * g_cai, p["cao"] * g_cao, vfrt, F)
    IpCa = p["GpCa"] * s["cai"] / (p["KmCap"] + s["cai"])
    IClCa_junc = (p["Fjunc"] * p["GClCa"] / (p["KdClCa"] / s["cass"] + 1.0)) * (v - EClss)
    IClCa_sl = ((1.0 - p["Fjunc"]) * p["GClCa"] / (p["KdClCa"] / s["cai"] + 1.0)) * (v - ECl)
    IClCa = IClCa_junc + IClCa_sl
    IClb = p["GClb"] * (v - ECl)
    akik = (p["ko"] / p["K_o_n"]) ** 0.24
    r_atp = p["A_atp"] / p["K_atp"]
    bkik = 1.0 / (r_atp * r_atp + 1.0)
    I_katp = p["fkatp"] * p["gkatp"] * akik * bkik * (v - EK)

    # ---- SR fluxes ----------------------------------------------------------
    upScale = where(is_epi, 1.3, 1.0)
    Jupnp = (s["cai"] * upScale * 0.005425) / (s["cai"] + 0.00092)
    Jupp = (s["cai"] * upScale * 2.75 * 0.005425) / (s["cai"] + 0.00092 - 0.00017)
    Jleak = 0.0048825 * s["cansr"] / 15.0
    Jup = p["Jup_b"] * (Jupnp * (1.0 - f_phos) + Jupp * f_phos - Jleak)
    Jtr = (s["cansr"] - s["cajsr"]) / 60.0

    # ryr release
    a_rel = 0.5 * p["bt"]
    btp = 1.25 * p["bt"]
    a_relp = 0.5 * btp
    rel_scale = where(is_mid, 1.7, 1.0)
    h8 = p["cajsr_half"] / s["cajsr"]
    h8 = h8 * h8
    h8 = h8 * h8
    rel_gain = 1.0 / (h8 * h8 + 1.0)
    Jrel_inf = rel_scale * (-a_rel * ICaL_ss) * rel_gain
    Jrel_infp = rel_scale * (-a_relp * ICaL_ss) * rel_gain
    tau_rel = maximum(p["bt"] / (1.0 + 0.0123 / s["cajsr"]), 0.001)
    tau_relp = maximum(btp / (1.0 + 0.0123 / s["cajsr"]), 0.001)
    Jrel = p["Jrel_b"] * (s["Jrel_np"] * (1.0 - f_phos) + s["Jrel_p"] * f_phos)

    # diffusion fluxes (note: the published dynCl spec uses tauNa for Cl)
    Jdiff = (s["cass"] - s["cai"]) / p["tauCa"]
    JdiffNa = (s["nass"] - s["nai"]) / p["tauNa"]
    JdiffK = (s["kss"] - s["ki"]) / p["tauK"]
    JdiffCl = (s["clss"] - s["cli"]) / p["tauNa"]

    # buffers
    cmdnmax = where(is_epi, 1.3 * p["cmdnmax_b"], p["cmdnmax_b"])
    b_trpn = s["cai"] + p["kmtrpn"]
    b_cmdn = s["cai"] + p["kmcmdn"]
    Bcai = 1.0 / (
        (p["kmtrpn"] * p["trpnmax"]) / (b_trpn * b_trpn)
        + (cmdnmax * p["kmcmdn"]) / (b_cmdn * b_cmdn)
        + 1.0
    )
    b_bsl = p["KmBSL"] + s["cass"]
    b_bsr = p["KmBSR"] + s["cass"]
    Bcass = 1.0 / (
        (p["BSLmax"] * p["KmBSL"]) / (b_bsl * b_bsl)
        + (p["BSRmax"] * p["KmBSR"]) / (b_bsr * b_bsr)
        + 1.0
    )
    b_csqn = s["cajsr"] + p["kmcsqn"]
    Bcajsr = 1.0 / ((p["csqnmax"] * p["kmcsqn"]) / (b_csqn * b_csqn) + 1.0)

    # ---- pacing stimulus (0-D mode) ------------------------------------------
    t_rel = t - p["i_Stim_Start"]
    t_in_period = t_rel - floor(t_rel / p["i_Stim_Period"]) * p["i_Stim_Period"]
    Istim = where(
        (t_rel >= 0.0) & (t_in_period <= p["i_Stim_PulseDuration"]) & (t <= p["i_Stim_End"]),
        p["i_Stim_Amplitude"],
        0.0,
    )

    # ---- membrane and concentration derivatives -------------------------------
    I_total = (
        INa
        + INaL
        + Ito
        + ICaL
        + ICaNa
        + ICaK
        + IKr
        + IKs
        + IK1
        + INaCa_i
        + INaCa_ss
        + INaK
        + INab
        + IKb
        + IpCa
        + ICab
        + IClCa
        + IClb
        + I_katp
        + Istim
    )
    dv = -I_total

    CF = Acap / F
    dnai = (-(INab + 3.0 * INaK + ICaNa_i + 3.0 * INaCa_i + INaL + INa)) * CF / vmyo + (
        JdiffNa * vss
    ) / vmyo
    dnass = -JdiffNa + (-(ICaNa_ss + 3.0 * INaCa_ss)) * CF / vss
    dki = (
        -(ICaK_i + (-2.0 * INaK) + Istim + I_katp + IKb + IK1 + IKs + IKr + Ito)
    ) * CF / vmyo + (JdiffK * vss) / vmyo
    dkss = -JdiffK + (-ICaK_ss) * CF / vss
    dcli = (IClCa_sl + IClb) * CF / vmyo + (JdiffCl * vss) / vmyo
    dclss = -JdiffCl + IClCa_junc * CF / vss
    dcai = Bcai * (
        (-(-2.0 * INaCa_i + ICab + ICaL_i + IpCa)) * CF / (2.0 * vmyo)
        - Jup * vnsr / vmyo
        + (Jdiff * vss) / vmyo
    )
    dcass = Bcass * (
        -Jdiff + (-(ICaL_ss - 2.0 * INaCa_ss)) * CF / (2.0 * vss) + (Jrel * vjsr) / vss
    )
    dcansr = Jup - Jtr * vjsr / vnsr
    dcajsr = Bcajsr * (Jtr - Jrel)

    gates = {
        "m": (mss, tm),
        "h": (hss, th),
        "hp": (hssp, th),
        "j": (jss, tj),
        "jp": (jss, tjp),
        "mL": (mLss, tmL),
        "hL": (hLss, p["thL"]),
        "hLp": (hLssp, thLp),
        "a": (ass_, ta),
        "ap": (assp, ta),
        "iF": (iss, tiF),
        "iS": (iss, tiS),
        "iFp": (iss, tiFp),
        "iSp": (iss, tiSp),
        "d": (dss, td),
        "ff": (fss, tff),
        "fs": (fss, tfs),
        "fcaf": (fcass, tfcaf),
        "fcas": (fcass, tfcas),
        "jca": (jcass, p["tjca"]),
        "ffp": (fss, tffp),
        "fcafp": (fcass, tfcafp),
        "xs1": (xs1ss, txs1),
        "xs2": (xs2ss, txs2),
        "Jrel_np": (Jrel_inf, tau_rel),
        "Jrel_p": (Jrel_infp, tau_relp),
    }

    # linear states: dx/dt = b - a*x  -> (x_inf = b/a, rate a)
    linear = {
        "nca_i": (anca_i * p["k2n"] / km2n, km2n),
        "nca_ss": (anca_ss * p["k2n"] / km2n, km2n),
    }
    # IKr Markov chain, diagonally linearized
    A_C1 = alpha_C2ToI + alpha_2 + p["beta_1"]
    B_C1 = s["I"] * beta_ItoC2 + s["C2"] * p["alpha_1"] + s["O"] * beta_2
    A_C2 = p["alpha_1"] + beta_
    B_C2 = s["C1"] * p["beta_1"] + s["C3"] * alpha
    A_C3 = alpha
    B_C3 = s["C2"] * beta_
    A_I = beta_ItoC2 + beta_i
    B_I = s["C1"] * alpha_C2ToI + s["O"] * alpha_i
    A_O = alpha_i + beta_2
    B_O = s["C1"] * alpha_2 + s["I"] * beta_i
    linear.update(
        {
            "C1": (B_C1 / A_C1, A_C1),
            "C2": (B_C2 / A_C2, A_C2),
            "C3": (B_C3 / A_C3, A_C3),
            "I": (B_I / A_I, A_I),
            "O": (B_O / A_O, A_O),
        }
    )

    explicit = {
        "v": dv,
        "CaMKt": dCaMKt,
        "cai": dcai,
        "cass": dcass,
        "cansr": dcansr,
        "cajsr": dcajsr,
        "cli": dcli,
        "clss": dclss,
        "ki": dki,
        "kss": dkss,
        "nai": dnai,
        "nass": dnass,
    }
    # auxiliary currents/fluxes needed by coupled variants (e.g. Land)
    aux = {
        "IpCa": IpCa,
        "ICab": ICab,
        "INaCa_i": INaCa_i,
        "Jup": Jup,
        "Jdiff": Jdiff,
        "Acap": Acap,
        "vmyo": vmyo,
        "vnsr": vnsr,
        "vss": vss,
        "cmdnmax": cmdnmax,
    }
    return gates, linear, explicit, aux


def rhs(states: torch.Tensor, t, parameters) -> torch.Tensor:
    """Full right-hand side d(states)/dt, shape (45, n)."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    gates, linear, explicit, _aux = _compute(states, t, p)
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
    """Generalized Rush-Larsen step (the scheme the reference requests from
    gotranx for this model): exact exponential update for the 26
    Hodgkin-Huxley gates and the diagonally-linear states (IKr Markov
    chain, nca modes), explicit update for V and concentrations.  ``t``
    and ``dt`` are Python floats."""
    p = unpack_params(parameters, states, _PARAM_NAMES)
    gates, linear, explicit, _aux = _compute(states, t, p)
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
