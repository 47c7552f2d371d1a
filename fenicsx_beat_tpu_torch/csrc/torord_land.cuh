// ToR-ORd dynCl coupled to the Land (2017) contraction model: one
// generalized Rush-Larsen step of one node, shared by B1
// (torord_land_grl.cu), its per-node-parameter form
// (torord_land_grl_node.cu) and B7 (torord_land_grl_multi.cu).
//
// The ionic part is torord.cuh's torord_grl_node<true>, the one copy of
// ToR-ORd's formulas, whose Land switch replaces the troponin term of Bcai
// by the CaTrpn ODE's flux J_TRPN in dcai.  Land's 7 mechanics states (all
// diagonally linear, the exponential update toward (x_inf, rate)) are
// stepped by torord_land_mechanics below, from the cytosolic Ca before the
// step.  The formulas are those of
// fenicsx_beat_tpu/models/torord_dyncl_land.py:_mechanics and _compute,
// term for term, in float32, in the operation order of the port's torch
// model (models/torord_dyncl_land.py, the kernels' plain twin): powf for
// the Hill terms (catn, Trpn50^ntm, CaTrpn^(-+ntm/2)), CaTrpn clamped at 0
// before them, CaTrpn^(-ntm/2) clamped at 100 (powf(0, -1.2) is +inf).
#pragma once

#include "torord.cuh"

// B7's blocks an SM over every block (torord.cuh: TORORD_MULTI_MIN_BLOCKS)
#ifndef TORORD_LAND_MULTI_MIN_BLOCKS
#define TORORD_LAND_MULTI_MIN_BLOCKS 2
#endif

// Land's states follow ToR-ORd's 45, in the order of _STATE_NAMES (the CPU
// tests parse this table).
enum TorordLandState {
    TL_XS = 45,
    TL_XW = 46,
    TL_CaTrpn = 47,
    TL_TmB = 48,
    TL_Zetas = 49,
    TL_Zetaw = 50,
    TL_Cd = 51,
    TORORD_LAND_NUM_STATES = 52
};

// Parameters: ToR-ORd's 108, then Land's 28, in the order of _PARAM_NAMES
// (the CPU tests parse this table).
struct TorordLandParams {
    TorordParams torord;
    float emcoupling;
    float lmbda;
    float dLambda;
    float mode;
    float isacs;
    float calib;
    float ktrpn;
    float ntrpn;
    float Trpn50;
    float rw;
    float rs;
    float gammas;
    float gammaw;
    float phi;
    float Tot_A;
    float Beta0;
    float Beta1;
    float cat50_ref;
    float Tref;
    float kuw;
    float kws;
    float ku;
    float ntm;
    float p_a;
    float p_b;
    float p_k;
    float etal;
    float etas;
};
constexpr int kTorordLandNumParams = 136;
static_assert(sizeof(TorordLandParams) == kTorordLandNumParams * sizeof(float), "parameter table");

namespace fbt {

// The 7 mechanics states of one node, in three sections that each read
// their old rows and write them before the next begins (the node body calls
// this first, so only J_TRPN stays live through its currents): the
// cross-bridges (XS and XW read each other's old values, TmB both and
// CaTrpn's), CaTrpn and the flux J_TRPN into dcai, the distortions.  Every
// expression keeps its own operation order, so the result is that of
// computing everything first, bit for bit.
template <class Src>
__device__ __forceinline__ float torord_land_mechanics(float* row, long long ld, float cai, float dt,
                                                       const Src& prm) {
#define LP(name) prm(offsetof(TorordLandParams, name) / sizeof(float))
#define ST(name) row[TL_##name * ld]
    {  // XS, XW, TmB
        const float kuw = LP(kuw), kws = LP(kws), rw = LP(rw), rs = LP(rs);
        const float XS = ST(XS), XW = ST(XW), TmB = ST(TmB);
        // distortion-dependent detachment: Zetas above 0 or below -1
        const float Zetas = ST(Zetas);
        const float zs_pos = Zetas > 0.0f ? Zetas : 0.0f;
        const float zs_neg = Zetas < -1.0f ? -Zetas - 1.0f : 0.0f;
        const float gammasu = LP(gammas) * fmaxf(zs_pos, zs_neg);
        const float ksu = kws * rw * (1.0f / rs - 1.0f);
        const float a_xs = ksu + gammasu;
        const float XS_new = gate_rate(XS, kws * XW / a_xs, a_xs, dt);
        const float gammawu = LP(gammaw) * fabsf(ST(Zetaw));
        const float kwu = kuw * (1.0f / rw - 1.0f) - kws;
        const float a_xw = kuw + kwu + kws + gammawu;
        const float XW_new = gate_rate(XW, kuw * (1.0f - TmB - XS) / a_xw, a_xw, dt);
        const float ku = LP(ku), ntm = LP(ntm);
        const float kb = ku * powf(LP(Trpn50), ntm) / (1.0f - rs - (1.0f - rs) * rw);
        const float CaTrpn_pos = fmaxf(ST(CaTrpn), 0.0f);
        const float unbind = fminf(powf(CaTrpn_pos, -ntm / 2.0f), 100.0f);
        const float bind = powf(CaTrpn_pos, ntm / 2.0f);
        const float a_tmb = kb * unbind + ku * bind;
        ST(TmB) = gate_rate(TmB, kb * unbind * (1.0f - XS - XW) / a_tmb, a_tmb, dt);
        ST(XS) = XS_new;
        ST(XW) = XW_new;
    }
    const float lam = fminf(LP(lmbda), 1.2f);
    float J_TRPN;
    {  // CaTrpn, and the flux it takes from dcai
        const float cat50 = LP(cat50_ref) + LP(Beta1) * (lam - 1.0f);
        const float catn = powf(cai * 1000.0f / cat50, LP(ntrpn));
        const float ktrpn = LP(ktrpn);
        const float CaTrpn = ST(CaTrpn);
        ST(CaTrpn) = gate_rate(CaTrpn, catn / (catn + 1.0f), ktrpn * (catn + 1.0f), dt);
        const float dCaTrpn = ktrpn * (catn * (1.0f - CaTrpn) - CaTrpn);
        J_TRPN = dCaTrpn * prm(offsetof(TorordParams, trpnmax) / sizeof(float));
    }
    {  // Zetas, Zetaw
        const float kuw = LP(kuw), kws = LP(kws), rw = LP(rw), rs = LP(rs);
        const float Aw = LP(Tot_A) * rs / ((1.0f - rs) * rw + rs);
        const float As = Aw;
        const float cs = LP(phi) * kws * ((1.0f - rs) * rw) / rs;
        ST(Zetas) = gate_rate(ST(Zetas), As * LP(dLambda) / cs, cs, dt);
        const float cw = LP(phi) * kuw * ((1.0f - rs) * (1.0f - rw)) / ((1.0f - rs) * rw);
        ST(Zetaw) = gate_rate(ST(Zetaw), Aw * LP(dLambda) / cw, cw, dt);
    }
    {  // Cd relaxes toward C = lam - 1 with a state-dependent viscosity
        const float C = lam - 1.0f;
        const float Cd = ST(Cd);
        const float eta = C - Cd < 0.0f ? LP(etas) : LP(etal);
        ST(Cd) = gate_rate(Cd, C, LP(p_k) / eta, dt);
    }
    return J_TRPN;
#undef ST
#undef LP
}

}  // namespace fbt
