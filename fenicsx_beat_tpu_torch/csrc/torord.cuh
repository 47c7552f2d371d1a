// The ToR-ORd dynCl ionic model's generalized Rush-Larsen step for one
// node, shared by the single-model kernel (B1, torord_grl.cu), its
// per-node-parameter form (torord_grl_node.cu) and the multi-marker kernel
// (B7, torord_grl_multi.cu), so all three run one copy of the formulas.
// ToR-ORd dynCl + Land's three kernels (torord_land_grl*.cu) run the same
// copy, switched to Land's dcai at compile time (torord_land.cuh).
//
// The formulas are those of
// fenicsx_beat_tpu/models/torord_dyncl.py:_compute and
// generalized_rush_larsen, term for term, in float32, in the operation
// order of the port's torch model (models/torord_dyncl.py, the kernels'
// plain twin): the GHK driving force x/(exp(x)-1) with its |x| < 1e-5
// series branch (not expm1f), the same splits on v (v <= -40 for the INa
// rates, v >= 31.4978 for d_inf), the same celltype scalings (a runtime
// branch on the parameter, as the JAX model's where), the same pacing
// window.  expf/logf/sqrtf/powf throughout (no fast-math intrinsics), and
// x ** 2 written x * x.  Sums and products round as the float32 twin's
// (-fmad=false); divisions use the card's approximate full-range division
// (-prec-div=false: at most 2 ulp), which the one-step and one-beat checks
// hold to the twin.
//
// The 26 Hodgkin-Huxley gates take the exact exponential update toward
// (x_inf, tau), the 7 diagonally linear states (IKr Markov chain, nca
// modes) the exponential update toward (x_inf, rate), V and the 12
// concentrations the explicit update.  A node holds 45 states and about
// 110 transcendental results: the step runs in two phases (torord_grl_node)
// so that few of them are live at once.
#pragma once

#include <cstddef>

#include "common.cuh"
#ifdef __CUDACC__
#include "staged.cuh"
#endif

// Launch shape of the ToR-ORd kernels and of ToR-ORd dynCl + Land's.  B1
// and its per-node form are staged (staged.cuh): TORORD_BLOCK threads a
// block and at least TORORD_MIN_BLOCKS blocks an SM, which caps the
// registers a thread (__launch_bounds__; two stage buffers of 128 nodes
// leave room for 4 blocks an SM).  B7 keeps fbt::kThreads, the unit of its
// block lists: over every block one node a thread, at least
// TORORD_MULTI_MIN_BLOCKS blocks an SM (ToR-ORd dynCl + Land:
// TORORD_LAND_MULTI_MIN_BLOCKS, torord_land.cuh); over a block list staged,
// 2 blocks an SM.  benchmarks/b1_designs.py builds other values, and the
// designs not kept (every form unstaged, B7 staged over every block too,
// B7's parameter table in shared memory) from benchmarks/b1_designs/.
#ifndef TORORD_BLOCK
#define TORORD_BLOCK 128
#endif
#ifndef TORORD_MIN_BLOCKS
#define TORORD_MIN_BLOCKS 4
#endif
#ifndef TORORD_MULTI_MIN_BLOCKS
#define TORORD_MULTI_MIN_BLOCKS 3
#endif

// State rows, in the order of _STATE_NAMES (the CPU tests parse this table).
enum TorordState {
    TR_v = 0,
    TR_CaMKt = 1,
    TR_cai = 2,
    TR_cass = 3,
    TR_cansr = 4,
    TR_cajsr = 5,
    TR_cli = 6,
    TR_clss = 7,
    TR_ki = 8,
    TR_kss = 9,
    TR_nai = 10,
    TR_nass = 11,
    TR_m = 12,
    TR_h = 13,
    TR_hp = 14,
    TR_j = 15,
    TR_jp = 16,
    TR_mL = 17,
    TR_hL = 18,
    TR_hLp = 19,
    TR_a = 20,
    TR_ap = 21,
    TR_iF = 22,
    TR_iS = 23,
    TR_iFp = 24,
    TR_iSp = 25,
    TR_d = 26,
    TR_ff = 27,
    TR_fs = 28,
    TR_fcaf = 29,
    TR_fcas = 30,
    TR_jca = 31,
    TR_ffp = 32,
    TR_fcafp = 33,
    TR_nca_ss = 34,
    TR_nca_i = 35,
    TR_C1 = 36,
    TR_C2 = 37,
    TR_C3 = 38,
    TR_O = 39,
    TR_I = 40,
    TR_xs1 = 41,
    TR_xs2 = 42,
    TR_Jrel_np = 43,
    TR_Jrel_p = 44,
    TORORD_NUM_STATES = 45
};

// Parameters, in the order of _PARAM_NAMES (the CPU tests parse this table).
struct TorordParams {
    float F;
    float R;
    float T;
    float cao;
    float clo;
    float ko;
    float nao;
    float L;
    float rad;
    float CaMKo;
    float KmCaM;
    float KmCaMK;
    float aCaMK;
    float bCaMK;
    float BSLmax;
    float BSRmax;
    float KmBSL;
    float KmBSR;
    float cmdnmax_b;
    float csqnmax;
    float kmcmdn;
    float kmcsqn;
    float kmtrpn;
    float trpnmax;
    float GNa;
    float GNaL_b;
    float thL;
    float EKshift;
    float Gto_b;
    float Aff;
    float ICaL_fractionSS;
    float Kmn;
    float PCa_b;
    float dielConstant;
    float k2n;
    float offset;
    float tjca;
    float vShift;
    float GKr_b;
    float alpha_1;
    float beta_1;
    float GKs_b;
    float GK1_b;
    float Gncx_b;
    float INaCa_fractionSS;
    float KmCaAct;
    float kasymm;
    float kcaoff;
    float kcaon;
    float kna1;
    float kna2;
    float kna3;
    float qca;
    float qna;
    float wca;
    float wna;
    float wnaca;
    float H;
    float Khp;
    float Kki;
    float Kko;
    float Kmgatp;
    float Knai0;
    float Knao0;
    float Knap;
    float Kxkur;
    float MgADP;
    float MgATP;
    float Pnak_b;
    float delta;
    float eP;
    float k1m;
    float k1p;
    float k2m;
    float k2p;
    float k3m;
    float k3p;
    float k4m;
    float k4p;
    float GKb_b;
    float PNab;
    float PCab;
    float GpCa;
    float KmCap;
    float Fjunc;
    float GClCa;
    float GClb;
    float KdClCa;
    float A_atp;
    float K_atp;
    float K_o_n;
    float fkatp;
    float gkatp;
    float Jrel_b;
    float bt;
    float cajsr_half;
    float Jup_b;
    float tauCa;
    float tauCl;
    float tauK;
    float tauNa;
    float PKNa;
    float celltype;
    float i_Stim_Amplitude;
    float i_Stim_Start;
    float i_Stim_End;
    float i_Stim_Period;
    float i_Stim_PulseDuration;
};
constexpr int kTorordNumParams = 108;
static_assert(sizeof(TorordParams) == kTorordNumParams * sizeof(float), "parameter table");

namespace fbt {

#ifdef __CUDACC__
// Runs `step(row, ld, v, i, mi)` (staged_steps' contract, staged.cuh) over
// the nodes of n in tiles of kTile: staged (kStaged), or one node a thread
// of tile_of(blockIdx.x)'s, stepped in place in the states.
template <int kS, int kTile, bool kIndex, bool kStaged, class TileOf, class Step>
__device__ __forceinline__ void torord_steps(float* states, const float* vin, const int* model, int n, int ntiles,
                                             TileOf tile_of, Step step) {
    if constexpr (kStaged) {
        staged_steps<kS, kTile, kIndex>(states, vin, model, n, ntiles, tile_of, step);
    } else {
        const int i = tile_of(static_cast<int>(blockIdx.x)) * kTile + static_cast<int>(threadIdx.x);
        if (i >= n) return;
        const int mi = kIndex ? model[i] : 0;
        const float v = vin[i];
        if (step(states + i, static_cast<long long>(n), v, i, mi) == 1) states[i] = v;  // V injected alone
    }
}

// Grid and dynamic shared memory of a ToR-ORd kernel over ntiles tiles of
// `block` nodes (kS states; kIndex: B7's model index): a block a tile, or
// staged as many blocks as the card holds, each with its two stage buffers
// (staged_grid; `cap` its cache).
struct TorordLaunch {
    int grid;
    int smem;
};
template <int kS, bool kIndex, class Kernel>
inline TorordLaunch torord_launch(Kernel kernel, bool staged, int block, long long ntiles, int& cap) {
    if (!staged) return {static_cast<int>(ntiles), 0};
    const int bytes = staged_bytes(kS, block, kIndex);
    return {staged_grid(kernel, block, bytes, ntiles, cap), bytes};
}

// B7's blocks an SM: over a block list staged, 2 (what two stage buffers
// of 256 nodes leave room for); over every block `min_blocks`.
__host__ __device__ constexpr int torord_b7_min_blocks(bool blocks, int min_blocks) {
    return blocks ? 2 : min_blocks;
}
#endif

// Exact exponential update toward x_inf with time constant tau (a gate) or
// with rate `rate` (a diagonally linear state).
__device__ __forceinline__ float gate_tau(float x, float x_inf, float tau, float dt) {
    return x_inf + (x - x_inf) * expf(-dt / tau);
}
__device__ __forceinline__ float gate_rate(float x, float x_inf, float rate, float dt) {
    return x_inf + (x - x_inf) * expf(-dt * rate);
}

// GHK driving force z*F*(x/(e^x - 1))*(ci*g_i*e^x - co*g_o), x = z*vfrt,
// with ex = expf(x) given; the series 1 - x/2 + x^2/12 where |x| < 1e-5.
__device__ __forceinline__ float torord_ghk(float z, float ci_gamma, float co_gamma, float vfrt,
                                            float F, float ex) {
    const float x = z * vfrt;
    const float ratio = fabsf(x) < 1e-5f ? 1.0f - 0.5f * x + x * x / 12.0f : x / (ex - 1.0f);
    return z * F * ratio * (ci_gamma * ex - co_gamma);
}

// The Na/Ca exchanger flux of one compartment (i or ss) [A/F]: `ca`, `na`
// its concentrations, `gncx_frac` the conductance scaled by the
// compartment's share, `allo_cap` the Ca that sets the allosteric factor;
// hca = exp(qca vfrt), hna = exp(qna vfrt).
template <class Src>
__device__ __forceinline__ float torord_inaca(float ca, float na, float gncx_frac, float allo_cap,
                                              float hca, float hna, const Src& prm) {
#define P(name) prm(offsetof(TorordParams, name) / sizeof(float))
    const float kna1 = P(kna1), kna2 = P(kna2), kna3 = P(kna3), nao = P(nao);
    const float h1 = (na / kna3) * (hna + 1.0f) + 1.0f;
    const float h2 = (hna * na) / (h1 * kna3);
    const float h3 = 1.0f / h1;
    const float h4 = (na / kna1) * (1.0f + na / kna2) + 1.0f;
    const float h5 = (na * na) / (kna2 * h4 * kna1);
    const float h6 = 1.0f / h4;
    const float h7 = (nao / kna3) * (1.0f + 1.0f / hna) + 1.0f;
    const float h8 = nao / (h7 * hna * kna3);
    const float h9 = 1.0f / h7;
    const float h10 = (nao / kna1) * (1.0f + nao / kna2) + (P(kasymm) + 1.0f);
    const float h11 = (nao * nao) / (kna2 * h10 * kna1);
    const float h12 = 1.0f / h10;
    const float k1 = P(kcaon) * P(cao) * h12;
    const float k2 = P(kcaoff);
    const float k3p = h9 * P(wca);
    const float k3pp = h8 * P(wnaca);
    const float k3 = k3p + k3pp;
    const float k4p = (h3 * P(wca)) / hca;
    const float k4pp = h2 * P(wnaca);
    const float k4 = k4p + k4pp;
    const float k5 = P(kcaoff);
    const float k6 = P(kcaon) * ca * h6;
    const float k7 = P(wna) * h2 * h5;
    const float k8 = P(wna) * h11 * h8;
    const float x1 = (k2 * k4) * (k6 + k7) + (k5 * k7) * (k2 + k3);
    const float x2 = (k1 * k7) * (k4 + k5) + (k4 * k6) * (k1 + k8);
    const float x3 = (k1 * k3) * (k6 + k7) + (k6 * k8) * (k2 + k3);
    const float x4 = (k2 * k8) * (k4 + k5) + (k3 * k5) * (k1 + k8);
    const float s = x1 + x2 + x3 + x4;
    const float E1 = x1 / s, E2 = x2 / s, E3 = x3 / s, E4 = x4 / s;
    const float r = P(KmCaAct) / allo_cap;
    const float allo = 1.0f / (r * r + 1.0f);
    const float JncxNa = -E2 * k3pp + (E3 * k4pp + 3.0f * (-E1 * k8 + E4 * k7));
    const float JncxCa = -E1 * k1 + E2 * k2;
    return (allo * gncx_frac) * (2.0f * JncxCa + 1.0f * JncxNa);
#undef P
}

// Land's contraction states (torord_land.cuh): one GRL step of the 7
// mechanics states of one node, in place, from the cytosolic Ca `cai`;
// returns the troponin flux J_TRPN that enters Land's dcai.
template <class Src>
__device__ __forceinline__ float torord_land_mechanics(float* row, long long ld, float cai, float dt,
                                                       const Src& prm);

// One GRL step of one node, in place: `row` points at the node's entry of
// state row 0 and consecutive state rows lie `ld` floats apart; `v` is the
// voltage to step from (the injected PDE voltage, not row v's content);
// `prm` is where the parameters come from (fbt::ParamSet or
// fbt::StridedParams, common.cuh).  kLand selects ToR-ORd dynCl + Land
// (torord_land.cuh): the 7 mechanics states are stepped too, and the CaTrpn
// ODE's flux J_TRPN replaces the troponin term of Bcai in dcai (the Land
// variant's published form).  The parameters then follow TorordLandParams,
// whose first 108 are TorordParams.
//
// The step runs in two phases, so that few values are live at once.  First
// the old states give every current and flux, which set V, the 12
// concentrations and CaMKt (the explicit update), and the linear states
// whose rates read the old concentrations (the nca modes, Jrel, Land's
// mechanics, stepped first so that only J_TRPN stays live).  Then the
// states that depend on v alone, one group at a time (the gates that share
// a steady state or a time constant, the IKr Markov chain): each reads its
// old rows, forms its rates and writes its rows before the next begins.
// Every state row is read before it is written, the currents use the old
// gate values, and every expression keeps its own operation order, so the
// result is that of computing everything first, bit for bit (with the IEEE
// division too: benchmarks/b1_designs.py).  Parameters are read where they
// are used.
template <bool kLand = false, class Src>
__device__ __forceinline__ void torord_grl_node(float* row, long long ld, float v, float t,
                                                float dt, const Src& prm) {
#define P(name) prm(offsetof(TorordParams, name) / sizeof(float))
#define ST(name) row[TR_##name * ld]
    const float ct = P(celltype);
    const bool is_epi = ct == 1.0f;
    const bool is_mid = ct == 2.0f;
    const float vfrt = P(F) * v / (P(R) * P(T));

    // ==== phase 1: currents, fluxes and the explicit updates, from the old states ====
    {
        const float cai = ST(cai);
        // Land's mechanics (their own rows) read the old cai and give J_TRPN
        float J_TRPN = 0.0f;
        if constexpr (kLand) J_TRPN = torord_land_mechanics(row, ld, cai, dt, prm);

        const float cass = ST(cass), cansr = ST(cansr), cajsr = ST(cajsr);
        const float cli = ST(cli), clss = ST(clss), ki = ST(ki), kss = ST(kss);
        const float nai = ST(nai), nass = ST(nass);

        // CaMK
        float f_phos;
        {
            const float CaMKt = ST(CaMKt);
            const float CaMKb = (P(CaMKo) * (1.0f - CaMKt)) / (P(KmCaM) / cass + 1.0f);
            const float CaMKa = CaMKb + CaMKt;
            ST(CaMKt) = CaMKt + dt * (-CaMKt * P(bCaMK) + (CaMKb * P(aCaMK)) * (CaMKb + CaMKt));
            f_phos = 1.0f / (1.0f + P(KmCaMK) / CaMKa);
        }

        // reversal potentials
        const float RTF = P(R) * P(T) / P(F);
        const float ENa = RTF * logf(P(nao) / nai);
        const float EK = RTF * logf(P(ko) / ki);

        // INa, INaL: their gates' old values
        float INa, INaL;
        {
            const float m = ST(m);
            INa = m * m * m * P(GNa) * (v - ENa) * (ST(j) * ST(h) * (1.0f - f_phos) + ST(jp) * ST(hp) * f_phos);
            const float GNaL = is_epi ? 0.6f * P(GNaL_b) : P(GNaL_b);
            INaL = ST(mL) * GNaL * (v - ENa) * (ST(hL) * (1.0f - f_phos) + ST(hLp) * f_phos);
        }

        // Ito
        float Ito;
        {
            const float vk = P(EKshift) + v;
            const float AiF = 1.0f / (expf((vk - 213.6f) / 151.2f) + 1.0f);
            const float AiS = 1.0f - AiF;
            const float i_gate = AiF * ST(iF) + AiS * ST(iS);
            const float ip_gate = AiF * ST(iFp) + AiS * ST(iSp);
            const float Gto = (is_epi || is_mid) ? 2.0f * P(Gto_b) : P(Gto_b);
            Ito = Gto * (v - EK) * (i_gate * ST(a) * (1.0f - f_phos) + ip_gate * ST(ap) * f_phos);
        }

        // ICaL (GHK with ionic-strength activity coefficients), the nca
        // modes (linear states, rate km2n = jca), INab and ICab
        float ICaL_i, ICaL_ss, ICaNa_i, ICaNa_ss, ICaK_i, ICaK_ss, INab, ICab;
        {
            // activity coefficients (extended Debye-Huckel)
            const float Ii = 0.5f * (4.0f * cai + cli + ki + nai) / 1000.0f;
            const float Io = 0.5f * (4.0f * P(cao) + P(clo) + P(ko) + P(nao)) / 1000.0f;
            const float Iss = 0.5f * (4.0f * cass + clss + kss + nass) / 1000.0f;
            const float TD = P(T) * P(dielConstant);
            const float constA = 1820000.0f / (TD * sqrtf(TD));
            const float dh_i = sqrtf(Ii) / (sqrtf(Ii) + 1.0f) - 0.3f * Ii;
            const float dh_o = sqrtf(Io) / (sqrtf(Io) + 1.0f) - 0.3f * Io;
            const float dh_ss = sqrtf(Iss) / (sqrtf(Iss) + 1.0f) - 0.3f * Iss;
            const float g_cai = expf(-constA * 4.0f * dh_i), g_cao = expf(-constA * 4.0f * dh_o);
            const float g_cass = expf(-constA * 4.0f * dh_ss);
            const float g1_i = expf(-constA * 1.0f * dh_i), g1_o = expf(-constA * 1.0f * dh_o);
            const float g1_ss = expf(-constA * 1.0f * dh_ss);  // K and Na share z^2 = 1

            const float F = P(F);
            const float e1 = expf(1.0f * vfrt), e2 = expf(2.0f * vfrt);
            const float PhiCaL_i = torord_ghk(2.0f, cai * g_cai, P(cao) * g_cao, vfrt, F, e2);
            const float PhiCaL_ss = torord_ghk(2.0f, cass * g_cass, P(cao) * g_cao, vfrt, F, e2);
            const float PhiCaNa_i = torord_ghk(1.0f, nai * g1_i, P(nao) * g1_o, vfrt, F, e1);
            const float PhiCaNa_ss = torord_ghk(1.0f, nass * g1_ss, P(nao) * g1_o, vfrt, F, e1);
            const float PhiCaK_i = torord_ghk(1.0f, ki * g1_i, P(ko) * g1_o, vfrt, F, e1);
            const float PhiCaK_ss = torord_ghk(1.0f, kss * g1_ss, P(ko) * g1_o, vfrt, F, e1);
            INab = P(PNab) * torord_ghk(1.0f, nai, P(nao), vfrt, F, e1);
            ICab = P(PCab) * PhiCaL_i;  // the GHK of ICaL_i, the same arguments

            const float Aff = P(Aff);
            const float Afs = 1.0f - Aff;
            const float fs = ST(fs);
            const float f_gate = Aff * ST(ff) + Afs * fs;
            const float fp_gate = Aff * ST(ffp) + Afs * fs;
            const float Afcaf = 0.3f + 0.6f / (expf((v - 10.0f) / 10.0f) + 1.0f);
            const float Afcas = 1.0f - Afcaf;
            const float fcas = ST(fcas);
            const float fca = Afcaf * ST(fcaf) + Afcas * fcas;
            const float fcap = Afcaf * ST(fcafp) + Afcas * fcas;
            const float jca = ST(jca);

            const float km2n = jca * 1.0f;
            const float k2n = P(k2n);
            const float ni = P(Kmn) / cai + 1.0f;
            const float nss = P(Kmn) / cass + 1.0f;
            const float anca_i = 1.0f / (k2n / km2n + (ni * ni) * (ni * ni));
            const float anca_ss = 1.0f / (k2n / km2n + (nss * nss) * (nss * nss));
            const float nca_i = ST(nca_i), nca_ss = ST(nca_ss);
            ST(nca_i) = gate_rate(nca_i, anca_i * k2n / km2n, km2n, dt);
            ST(nca_ss) = gate_rate(nca_ss, anca_ss * k2n / km2n, km2n, dt);

            const float PCa_b = P(PCa_b);
            const float PCa = is_epi ? 1.2f * PCa_b : (is_mid ? 2.0f * PCa_b : PCa_b);
            const float PCap = 1.1f * PCa;
            const float PCaNa = 0.00125f * PCa;
            const float PCaK = 0.0003574f * PCa;
            const float PCaNap = 0.00125f * PCap;
            const float PCaKp = 0.0003574f * PCap;
            const float frac_ss = P(ICaL_fractionSS);
            const float frac_i = 1.0f - frac_ss;
            // d * (Phi P_np (1 - f_phos) mode_np + Phi P_p f_phos mode_p) per mode
            const float np_i = f_gate * (1.0f - nca_i) + nca_i * fca * jca;
            const float p_i = fp_gate * (1.0f - nca_i) + nca_i * fcap * jca;
            const float np_ss = f_gate * (1.0f - nca_ss) + nca_ss * fca * jca;
            const float p_ss = fp_gate * (1.0f - nca_ss) + nca_ss * fcap * jca;
            const float d = ST(d);
#define ICAL_PAIR(Phi, Pnp, Pp, mnp, mp) \
    (d * ((Phi) * (Pnp) * (1.0f - f_phos) * (mnp) + (Phi) * (Pp) * f_phos * (mp)))
            ICaL_i = frac_i * ICAL_PAIR(PhiCaL_i, PCa, PCap, np_i, p_i);
            ICaL_ss = frac_ss * ICAL_PAIR(PhiCaL_ss, PCa, PCap, np_ss, p_ss);
            ICaNa_i = frac_i * ICAL_PAIR(PhiCaNa_i, PCaNa, PCaNap, np_i, p_i);
            ICaNa_ss = frac_ss * ICAL_PAIR(PhiCaNa_ss, PCaNa, PCaNap, np_ss, p_ss);
            ICaK_i = frac_i * ICAL_PAIR(PhiCaK_i, PCaK, PCaKp, np_i, p_i);
            ICaK_ss = frac_ss * ICAL_PAIR(PhiCaK_ss, PCaK, PCaKp, np_ss, p_ss);
#undef ICAL_PAIR
        }
        const float ICaL = ICaL_i + ICaL_ss;
        const float ICaNa = ICaNa_i + ICaNa_ss;
        const float ICaK = ICaK_i + ICaK_ss;

        const float sqrt_ko = sqrtf(P(ko) / 5.0f);

        // IKr: the open state of its Markov chain (stepped in phase 2)
        const float GKr_b = P(GKr_b);
        const float GKr = is_epi ? 1.3f * GKr_b : (is_mid ? 0.8f * GKr_b : GKr_b);
        const float IKr = ST(O) * GKr * sqrt_ko * (v - EK);

        // IKs
        float IKs;
        {
            const float EKs = RTF * logf((P(PKNa) * P(nao) + P(ko)) / (P(PKNa) * nai + ki));
            const float KsCa = 1.0f + 0.6f / (powf(3.8e-5f / cai, 1.4f) + 1.0f);
            const float GKs = is_epi ? 1.4f * P(GKs_b) : P(GKs_b);
            IKs = ST(xs1) * ST(xs2) * GKs * KsCa * (v - EKs);
        }

        // IK1
        float IK1;
        {
            const float aK1 = 4.094f / (expf(0.1217f * (v - EK - 49.934f)) + 1.0f);
            const float bK1 = (15.72f * expf(0.0674f * (v - EK - 3.257f)) + expf(0.0618f * (v - EK - 594.31f))) /
                              (expf(-0.1629f * (v - EK + 14.207f)) + 1.0f);
            const float K1ss = aK1 / (aK1 + bK1);
            const float GK1_b = P(GK1_b);
            const float GK1 = is_epi ? 1.2f * GK1_b : (is_mid ? 1.3f * GK1_b : GK1_b);
            IK1 = K1ss * GK1 * sqrt_ko * (v - EK);
        }

        // INaCa
        float INaCa_i, INaCa_ss;
        {
            const float Gncx_b = P(Gncx_b);
            const float Gncx = is_epi ? 1.1f * Gncx_b : (is_mid ? 1.4f * Gncx_b : Gncx_b);
            const float hca = expf(P(qca) * vfrt), hna = expf(P(qna) * vfrt);
            INaCa_i = torord_inaca(cai, nai, Gncx * (1.0f - P(INaCa_fractionSS)), cai, hca, hna, prm);
            INaCa_ss = torord_inaca(cass, nass, Gncx * P(INaCa_fractionSS), cass, hca, hna, prm);
        }

        // INaK (Smith-Crampin 4-state cycle)
        float INaK;
        {
            const float Knai = P(Knai0) * expf(P(delta) * vfrt / 3.0f);
            const float Knao = P(Knao0) * expf((1.0f - P(delta)) * vfrt / 3.0f);
            const float P_ = P(eP) / ((P(H) / P(Khp) + 1.0f) + nai / P(Knap) + ki / P(Kxkur));
            const float nK = nai / Knai;
            const float kK = 1.0f + ki / P(Kki);
            const float nKp = 1.0f + nai / Knai;
            const float oK = 1.0f + P(ko) / P(Kko);
            const float nO = 1.0f + P(nao) / Knao;
            const float a1 = (P(k1p) * (nK * nK * nK)) / ((kK * kK + nKp * nKp * nKp) - 1.0f);
            const float b1 = P(MgADP) * P(k1m);
            const float a2 = P(k2p);
            const float nao_K = P(nao) / Knao;
            const float b2 = (P(k2m) * (nao_K * nao_K * nao_K)) / ((oK * oK + nO * nO * nO) - 1.0f);
            const float ko_K = P(ko) / P(Kko);
            const float a3 = (P(k3p) * (ko_K * ko_K)) / ((oK * oK + nO * nO * nO) - 1.0f);
            const float b3 = (P(H) * P_ * P(k3m)) / (1.0f + P(MgATP) / P(Kmgatp));
            const float a4 = ((P(MgATP) * P(k4p)) / P(Kmgatp)) / (1.0f + P(MgATP) / P(Kmgatp));
            const float ki_K = ki / P(Kki);
            const float b4 = (P(k4m) * (ki_K * ki_K)) / ((kK * kK + nKp * nKp * nKp) - 1.0f);
            const float x1 = a2 * a1 * b3 + b3 * a2 * b4 + a2 * a1 * a4 + b3 * b2 * b4;
            const float x2 = b4 * a2 * a3 + b4 * a3 * b1 + a3 * a1 * a2 + b4 * b1 * b2;
            const float x3 = b1 * a3 * a4 + a4 * b1 * b2 + a4 * a2 * a3 + b1 * b2 * b3;
            const float x4 = a1 * b2 * b3 + a1 * a4 * b2 + a1 * a3 * a4 + b2 * b3 * b4;
            const float sx = x1 + x2 + x3 + x4;
            const float E1 = x1 / sx, E2 = x2 / sx, E3 = x3 / sx, E4 = x4 / sx;
            const float JnakNa = 3.0f * (E1 * a3 - E2 * b3);
            const float JnakK = 2.0f * (-E3 * a1 + E4 * b1);
            const float Pnak_b = P(Pnak_b);
            const float Pnak = is_epi ? 0.9f * Pnak_b : (is_mid ? 0.7f * Pnak_b : Pnak_b);
            INaK = Pnak * (JnakNa + JnakK);
        }

        // minor currents
        const float xkb = 1.0f / (expf(-(v - 10.8968f) / 23.9871f) + 1.0f);
        const float GKb = is_epi ? 0.6f * P(GKb_b) : P(GKb_b);
        const float IKb = GKb * xkb * (v - EK);
        const float IpCa = P(GpCa) * cai / (P(KmCap) + cai);
        const float ECl = -RTF * logf(P(clo) / cli);
        const float EClss = -RTF * logf(P(clo) / clss);
        const float IClCa_junc = (P(Fjunc) * P(GClCa) / (P(KdClCa) / cass + 1.0f)) * (v - EClss);
        const float IClCa_sl = ((1.0f - P(Fjunc)) * P(GClCa) / (P(KdClCa) / cai + 1.0f)) * (v - ECl);
        const float IClCa = IClCa_junc + IClCa_sl;
        const float IClb = P(GClb) * (v - ECl);
        float I_katp;
        {
            const float akik = powf(P(ko) / P(K_o_n), 0.24f);
            const float r_atp = P(A_atp) / P(K_atp);
            const float bkik = 1.0f / (r_atp * r_atp + 1.0f);
            I_katp = P(fkatp) * P(gkatp) * akik * bkik * (v - EK);
        }

        // SR uptake and transfer
        const float upScale = is_epi ? 1.3f : 1.0f;
        const float Jupnp = (cai * upScale * 0.005425f) / (cai + 0.00092f);
        const float Jupp = (cai * upScale * 2.75f * 0.005425f) / (cai + 0.00092f - 0.00017f);
        const float Jleak = 0.0048825f * cansr / 15.0f;
        const float Jup = P(Jup_b) * (Jupnp * (1.0f - f_phos) + Jupp * f_phos - Jleak);
        const float Jtr = (cansr - cajsr) / 60.0f;

        // ryr release (linear states toward rates of ICaL_ss and cajsr)
        float Jrel;
        {
            const float bt = P(bt);
            const float a_rel = 0.5f * bt;
            const float btp = 1.25f * bt;
            const float a_relp = 0.5f * btp;
            const float rel_scale = is_mid ? 1.7f : 1.0f;
            float h8 = P(cajsr_half) / cajsr;
            h8 = h8 * h8;
            h8 = h8 * h8;
            const float rel_gain = 1.0f / (h8 * h8 + 1.0f);
            const float Jrel_inf = rel_scale * (-a_rel * ICaL_ss) * rel_gain;
            const float Jrel_infp = rel_scale * (-a_relp * ICaL_ss) * rel_gain;
            const float tau_rel = fmaxf(bt / (1.0f + 0.0123f / cajsr), 0.001f);
            const float tau_relp = fmaxf(btp / (1.0f + 0.0123f / cajsr), 0.001f);
            const float Jrel_np = ST(Jrel_np), Jrel_p = ST(Jrel_p);
            Jrel = P(Jrel_b) * (Jrel_np * (1.0f - f_phos) + Jrel_p * f_phos);
            ST(Jrel_np) = gate_tau(Jrel_np, Jrel_inf, tau_rel, dt);
            ST(Jrel_p) = gate_tau(Jrel_p, Jrel_infp, tau_relp, dt);
        }

        // pacing stimulus (0-D mode)
        float Istim;
        {
            const float t_rel = t - P(i_Stim_Start);
            const float period = P(i_Stim_Period);
            const float t_in_period = t_rel - floorf(t_rel / period) * period;
            Istim = (t_rel >= 0.0f && t_in_period <= P(i_Stim_PulseDuration) && t <= P(i_Stim_End))
                        ? P(i_Stim_Amplitude)
                        : 0.0f;
        }

        // membrane and concentration derivatives, explicit update
        const float I_total = INa + INaL + Ito + ICaL + ICaNa + ICaK + IKr + IKs + IK1 + INaCa_i +
                              INaCa_ss + INaK + INab + IKb + IpCa + ICab + IClCa + IClb + I_katp + Istim;
        ST(v) = v + dt * -I_total;

        // cell geometry
        const float L = P(L), rad = P(rad);
        const float pi = 3.14f;
        const float Ageo = L * (2.0f * pi * rad) + rad * (2.0f * pi * rad);
        const float Acap = 2.0f * Ageo;
        const float vcell = 1000.0f * pi * rad * rad * L;
        const float vmyo = 0.68f * vcell;
        const float vnsr = 0.0552f * vcell;
        const float vjsr = 0.0048f * vcell;
        const float vss = 0.02f * vcell;

        // diffusion fluxes (the published dynCl spec uses tauNa for Cl)
        const float CF = Acap / P(F);
        {
            const float JdiffNa = (nass - nai) / P(tauNa);
            ST(nai) = nai + dt * ((-(INab + 3.0f * INaK + ICaNa_i + 3.0f * INaCa_i + INaL + INa)) * CF / vmyo +
                                  (JdiffNa * vss) / vmyo);
            ST(nass) = nass + dt * (-JdiffNa + (-(ICaNa_ss + 3.0f * INaCa_ss)) * CF / vss);
        }
        {
            const float JdiffK = (kss - ki) / P(tauK);
            ST(ki) = ki + dt * ((-(ICaK_i + (-2.0f * INaK) + Istim + I_katp + IKb + IK1 + IKs + IKr + Ito)) *
                                    CF / vmyo +
                                (JdiffK * vss) / vmyo);
            ST(kss) = kss + dt * (-JdiffK + (-ICaK_ss) * CF / vss);
        }
        {
            const float JdiffCl = (clss - cli) / P(tauNa);
            ST(cli) = cli + dt * ((IClCa_sl + IClb) * CF / vmyo + (JdiffCl * vss) / vmyo);
            ST(clss) = clss + dt * (-JdiffCl + IClCa_junc * CF / vss);
        }
        // buffers
        const float Jdiff = (cass - cai) / P(tauCa);
        const float cmdnmax = is_epi ? 1.3f * P(cmdnmax_b) : P(cmdnmax_b);
        const float b_cmdn = cai + P(kmcmdn);
        if constexpr (kLand) {
            // troponin buffering through the CaTrpn ODE, INaCa_i / 3, no ICaL_i
            const float Bcai_land = 1.0f / (1.0f + cmdnmax * P(kmcmdn) / (b_cmdn * b_cmdn));
            ST(cai) = cai + dt * (Bcai_land * (-(IpCa + ICab - 2.0f * INaCa_i / 3.0f) * Acap / (2.0f * P(F) * vmyo) -
                                               Jup * vnsr / vmyo + Jdiff * vss / vmyo - J_TRPN));
        } else {
            const float b_trpn = cai + P(kmtrpn);
            const float Bcai = 1.0f / ((P(kmtrpn) * P(trpnmax)) / (b_trpn * b_trpn) +
                                       (cmdnmax * P(kmcmdn)) / (b_cmdn * b_cmdn) + 1.0f);
            ST(cai) = cai + dt * (Bcai * ((-(-2.0f * INaCa_i + ICab + ICaL_i + IpCa)) * CF / (2.0f * vmyo) -
                                          Jup * vnsr / vmyo + (Jdiff * vss) / vmyo));
        }
        {
            const float b_bsl = P(KmBSL) + cass;
            const float b_bsr = P(KmBSR) + cass;
            const float Bcass = 1.0f / ((P(BSLmax) * P(KmBSL)) / (b_bsl * b_bsl) +
                                        (P(BSRmax) * P(KmBSR)) / (b_bsr * b_bsr) + 1.0f);
            ST(cass) = cass + dt * (Bcass * (-Jdiff + (-(ICaL_ss - 2.0f * INaCa_ss)) * CF / (2.0f * vss) +
                                             (Jrel * vjsr) / vss));
        }
        ST(cansr) = cansr + dt * (Jup - Jtr * vjsr / vnsr);
        const float b_csqn = cajsr + P(kmcsqn);
        const float Bcajsr = 1.0f / ((P(csqnmax) * P(kmcsqn)) / (b_csqn * b_csqn) + 1.0f);
        ST(cajsr) = cajsr + dt * (Bcajsr * (Jtr - Jrel));
    }

    // ==== phase 2: the states that depend on v alone, a group at a time ====
    // Each reads its own rows, which phase 1 did not write: the old values.
    {  // INa's m and INaL's mL share tm
        const float em = expf(-(v + 56.86f) / 9.03f) + 1.0f;
        const float mss = 1.0f / (em * em);
        const float q1 = (v - 4.823f) / 51.12f, q2 = (v + 45.79f) / 15.54f;
        const float tm = 0.06487f * expf(-(q1 * q1)) + 0.1292f * expf(-(q2 * q2));
        ST(m) = gate_tau(ST(m), mss, tm, dt);
        const float mLss = 1.0f / (expf(-(v + 42.85f) / 5.264f) + 1.0f);
        ST(mL) = gate_tau(ST(mL), mLss, tm, dt);
    }
    {  // INa's h, hp, j, jp
        const float eh = expf((v + 71.55f) / 7.43f) + 1.0f;
        const float hss = 1.0f / (eh * eh);
        const bool vlo = v <= -40.0f;
        {
            const float ah = vlo ? 4.43126792958051e-7f * expf(-0.147058823529412f * v) : 0.0f;
            const float bh = vlo ? 2.7f * expf(0.079f * v) + 310000.0f * expf(0.3485f * v)
                                 : 0.77f * expf(0.0900900900900901f * v) /
                                       (0.13f * expf(0.0900900900900901f * v) + 0.0497581410839387f);
            const float th = 1.0f / (ah + bh);
            ST(h) = gate_tau(ST(h), hss, th, dt);
            const float ehp = expf((v + 77.55f) / 7.43f) + 1.0f;
            const float hssp = 1.0f / (ehp * ehp);
            ST(hp) = gate_tau(ST(hp), hssp, th, dt);
        }
        const float aj = vlo ? -(v + 37.78f) * (25428.0f * expf(0.28831f * v) + 6.948e-6f) *
                                   expf(-0.04391f * v) / (50262745825.954f * expf(0.311f * v) + 1.0f)
                             : 0.0f;
        const float bj = vlo ? 0.02424f * expf(0.12728f * v) / (1.0f * expf(0.1378f * v) + 0.00396086833990426f)
                             : 0.6f * expf(0.157f * v) / (1.0f * expf(0.1f * v) + 0.0407622039783662f);
        const float tj = 1.0f / (aj + bj);
        ST(j) = gate_tau(ST(j), hss, tj, dt);
        const float tjp = 1.46f * tj;
        ST(jp) = gate_tau(ST(jp), hss, tjp, dt);
    }
    {  // INaL's hL, hLp
        const float hLss = 1.0f / (expf((v + 87.61f) / 7.488f) + 1.0f);
        const float thL = P(thL);
        ST(hL) = gate_tau(ST(hL), hLss, thL, dt);
        const float hLssp = 1.0f / (expf((v + 93.81f) / 7.488f) + 1.0f);
        const float thLp = 3.0f * thL;
        ST(hLp) = gate_tau(ST(hLp), hLssp, thLp, dt);
    }
    {  // Ito's a, ap, iF, iS, iFp, iSp
        const float vk = P(EKshift) + v;
        const float ta = 1.0515f / (1.0f / (1.2089f * (expf(-(vk - 18.4099f) / 29.3814f) + 1.0f)) +
                                    3.5f / (expf((vk + 100.0f) / 29.3814f) + 1.0f));
        const float ass = 1.0f / (expf(-(vk - 14.34f) / 14.82f) + 1.0f);
        ST(a) = gate_tau(ST(a), ass, ta, dt);
        const float assp = 1.0f / (expf(-(vk - 24.34f) / 14.82f) + 1.0f);
        ST(ap) = gate_tau(ST(ap), assp, ta, dt);
        const float iss = 1.0f / (expf((vk + 43.94f) / 5.711f) + 1.0f);
        const float delta_epi = is_epi ? 1.0f - 0.95f / (expf((vk + 70.0f) / 5.0f) + 1.0f) : 1.0f;
        const float tiF_b =
            4.562f + 1.0f / (0.3933f * expf(-(vk + 100.0f) / 100.0f) + 0.08004f * expf((vk + 50.0f) / 16.59f));
        const float tiS_b = 23.62f + 1.0f / (0.001416f * expf(-(vk + 96.52f) / 59.05f) +
                                             1.78e-8f * expf((vk + 114.1f) / 8.079f));
        const float tiF = delta_epi * tiF_b;
        const float tiS = delta_epi * tiS_b;
        ST(iF) = gate_tau(ST(iF), iss, tiF, dt);
        ST(iS) = gate_tau(ST(iS), iss, tiS, dt);
        const float dti_develop =
            1.354f + 0.0001f / (expf(-(vk - 12.23f) / 0.2154f) + expf((vk - 167.4f) / 15.89f));
        const float dti_recover = 1.0f - 0.5f / (expf((vk + 70.0f) / 20.0f) + 1.0f);
        const float tiFp = tiF * dti_develop * dti_recover;
        ST(iFp) = gate_tau(ST(iFp), iss, tiFp, dt);
        const float tiSp = tiS * dti_develop * dti_recover;
        ST(iSp) = gate_tau(ST(iSp), iss, tiSp, dt);
    }
    {  // ICaL's ff, fs, ffp, fcaf, fcas, fcafp (fcass = fss)
        const float fss = 1.0f / (expf((v + 19.58f) / 3.696f) + 1.0f);
        const float tff = 7.0f + 1.0f / (0.0045f * expf(-(v + 20.0f) / 10.0f) + 0.0045f * expf((v + 20.0f) / 10.0f));
        ST(ff) = gate_tau(ST(ff), fss, tff, dt);
        const float tffp = 2.5f * tff;
        ST(ffp) = gate_tau(ST(ffp), fss, tffp, dt);
        const float tfs = 1000.0f + 1.0f / (3.5e-5f * expf(-(v + 5.0f) / 4.0f) + 3.5e-5f * expf((v + 5.0f) / 6.0f));
        ST(fs) = gate_tau(ST(fs), fss, tfs, dt);
        const float tfcaf = 7.0f + 1.0f / (0.04f * expf(-(v - 4.0f) / 7.0f) + 0.04f * expf((v - 4.0f) / 7.0f));
        ST(fcaf) = gate_tau(ST(fcaf), fss, tfcaf, dt);
        const float tfcafp = 2.5f * tfcaf;
        ST(fcafp) = gate_tau(ST(fcafp), fss, tfcafp, dt);
        const float tfcas = 100.0f + 1.0f / (0.00012f * expf(-v / 3.0f) + 0.00012f * expf(v / 7.0f));
        ST(fcas) = gate_tau(ST(fcas), fss, tfcas, dt);
    }
    {  // ICaL's jca and d
        const float jcass = 1.0f / (expf((v + 18.08f) / 2.7916f) + 1.0f);
        ST(jca) = gate_tau(ST(jca), jcass, P(tjca), dt);
        const float dss = v >= 31.4978f ? 1.0f : 1.0763f * expf(-1.007f * expf(-0.0829f * v));
        const float td = (P(offset) + 0.6f) + 1.0f / (expf(-0.05f * (v + P(vShift) + 6.0f)) +
                                                     expf(0.09f * (v + P(vShift) + 14.0f)));
        ST(d) = gate_tau(ST(d), dss, td, dt);
    }
    {  // IKs's xs1, xs2 (xs2ss = xs1ss)
        const float xs1ss = 1.0f / (expf(-(v + 11.6f) / 8.932f) + 1.0f);
        const float txs1 =
            817.3f + 1.0f / (0.0002326f * expf((v + 48.28f) / 17.8f) + 0.001292f * expf(-(v + 210.0f) / 230.0f));
        ST(xs1) = gate_tau(ST(xs1), xs1ss, txs1, dt);
        const float txs2 = 1.0f / (0.01f * expf((v - 50.0f) / 20.0f) + 0.0193f * expf(-(v + 66.54f) / 31.0f));
        ST(xs2) = gate_tau(ST(xs2), xs1ss, txs2, dt);
    }
    {  // IKr's 5-state Markov chain, diagonally linearized: all five old states first
        const float alpha = 0.1161f * expf(0.299f * vfrt);
        const float beta_ = 0.2442f * expf(-1.604f * vfrt);
        const float alpha_2 = 0.0578f * expf(0.971f * vfrt);
        const float beta_2 = 0.000349f * expf(-1.062f * vfrt);
        const float alpha_i = 0.2533f * expf(0.5953f * vfrt);
        const float beta_i = 0.06525f * expf(-0.8209f * vfrt);
        const float alpha_C2ToI = 5.2e-5f * expf(1.525f * vfrt);
        const float beta_ItoC2 = (alpha_C2ToI * beta_2 * beta_i) / (alpha_2 * alpha_i);
        const float C1 = ST(C1), C2 = ST(C2), C3 = ST(C3), O = ST(O), I = ST(I);
        const float alpha_1 = P(alpha_1), beta_1 = P(beta_1);
        const float A_C1 = alpha_C2ToI + alpha_2 + beta_1;
        const float B_C1 = I * beta_ItoC2 + C2 * alpha_1 + O * beta_2;
        ST(C1) = gate_rate(C1, B_C1 / A_C1, A_C1, dt);
        const float A_C2 = alpha_1 + beta_;
        const float B_C2 = C1 * beta_1 + C3 * alpha;
        ST(C2) = gate_rate(C2, B_C2 / A_C2, A_C2, dt);
        const float A_C3 = alpha;
        const float B_C3 = C2 * beta_;
        ST(C3) = gate_rate(C3, B_C3 / A_C3, A_C3, dt);
        const float A_O = alpha_i + beta_2;
        const float B_O = C1 * alpha_2 + I * beta_i;
        ST(O) = gate_rate(O, B_O / A_O, A_O, dt);
        const float A_I = beta_ItoC2 + beta_i;
        const float B_I = C1 * alpha_C2ToI + O * alpha_i;
        ST(I) = gate_rate(I, B_I / A_I, A_I, dt);
    }
#undef ST
#undef P
}

}  // namespace fbt
