// The ten Tusscher-Panfilov 2006 ionic model's generalized Rush-Larsen step
// for one node, shared by the single-model kernel (B1, tp06_grl.cu) and the
// multi-marker kernel (B7, tp06_grl_multi.cu), so both run one copy of the
// formulas.
//
// The formulas are those of
// fenicsx_beat_tpu/models/tentusscher_panfilov_2006.py:generalized_rush_larsen,
// term for term, in float32: the same guarded L-type Ca driving force
// x/(exp(x)-1) with its |x| < 1e-7 series branch (not expm1f), the same
// celltype switches (a runtime branch on the parameter, as the JAX model's
// where: endo changes g_to, s_inf and tau_s, mid changes g_Ks), the same
// exact exponential update for the 12 gates and for R_prime.  Sums and
// products round as the float32 twin's (-fmad=false); divisions use the
// card's approximate full-range division (-prec-div=false: at most 2 ulp),
// which the one-step and one-beat checks hold to the twin.
#pragma once

#include "common.cuh"

// Launch shape of the TP06 kernels: threads a block of B1 and its per-node
// form (B7 keeps fbt::kThreads, the unit of its block lists), and the blocks
// an SM must hold at once, which caps the registers a thread
// (__launch_bounds__).  benchmarks/b1_designs.py builds other values.
#ifndef TP06_BLOCK
#define TP06_BLOCK 128
#endif
#ifndef TP06_MIN_BLOCKS
#define TP06_MIN_BLOCKS 6
#endif

// State rows, in the order of _STATE_NAMES (the CPU tests parse this table).
enum Tp06State {
    S_V = 0,
    S_Xr1 = 1,
    S_Xr2 = 2,
    S_Xs = 3,
    S_m = 4,
    S_h = 5,
    S_j = 6,
    S_d = 7,
    S_f = 8,
    S_f2 = 9,
    S_fCass = 10,
    S_s = 11,
    S_r = 12,
    S_Ca_i = 13,
    S_R_prime = 14,
    S_Ca_SR = 15,
    S_Ca_ss = 16,
    S_Na_i = 17,
    S_K_i = 18,
    TP06_NUM_STATES = 19
};

// Parameters, in the order of _PARAM_NAMES (the CPU tests parse this table).
struct Tp06Params {
    float P_kna;
    float g_K1;
    float g_Kr;
    float g_Ks;
    float g_Na;
    float g_bna;
    float g_CaL;
    float g_bca;
    float g_to;
    float P_NaK;
    float K_mk;
    float K_mNa;
    float K_NaCa;
    float K_sat;
    float alpha;
    float gamma;
    float Km_Ca;
    float Km_Nai;
    float g_pCa;
    float K_pCa;
    float g_pK;
    float Ca_o;
    float k1_prime;
    float k2_prime;
    float k3;
    float k4;
    float EC;
    float max_sr;
    float min_sr;
    float V_rel;
    float V_xfer;
    float K_up;
    float V_leak;
    float Vmax_up;
    float Buf_c;
    float K_buf_c;
    float Buf_sr;
    float K_buf_sr;
    float Buf_ss;
    float K_buf_ss;
    float V_sr;
    float V_ss;
    float Na_o;
    float R;
    float T;
    float F;
    float Cm;
    float V_c;
    float stim_start;
    float stim_period;
    float stim_duration;
    float stim_amplitude;
    float K_o;
    float celltype;
};
constexpr int kTp06NumParams = 54;
static_assert(sizeof(Tp06Params) == kTp06NumParams * sizeof(float), "parameter table");

namespace fbt {

__device__ __forceinline__ float sq(float x) { return x * x; }

// Rush-Larsen gate update toward x_inf with time constant tau.
__device__ __forceinline__ float rl(float x, float x_inf, float tau, float dt) {
    return x_inf + (x - x_inf) * expf(-dt / tau);
}

// One GRL step of one node, in place: `row` points at the node's entry of
// state row 0 and consecutive state rows lie `ld` floats apart; `V` is the
// voltage to step from (the injected PDE voltage, not row V's content);
// `prm` is where the parameters come from (fbt::ParamSet or
// fbt::StridedParams, common.cuh).
//
// The step runs in two phases, so that few values are live at once (the
// registers, not the bytes, bound the kernels that run it).  First the old
// states give every current and the non-gate derivatives, which are
// written at once with fCass's gate (it reads the old Ca_ss).  Then the
// other eleven gates, which depend on V alone, one at a time: each reads
// its old row, forms its (x_inf, tau) and writes its row before the next
// begins.  Every state row is read before it is written, the currents use
// the old gate values, and every expression keeps its own operation order,
// so the result is that of computing everything first, bit for bit (with
// the IEEE division too: benchmarks/b1_designs.py).
template <class Src>
__device__ __forceinline__ void tp06_grl_node(float* row, long long ld, float V, float t, float dt,
                                              const Src& prm) {
#define TP(name) prm(offsetof(Tp06Params, name) / sizeof(float))
    const bool is_endo = TP(celltype) == 0.0f;
    const bool is_mid = TP(celltype) == 2.0f;
    {
        // ---- phase 1: currents and non-gate states, from the old states ----
        const float Xr1 = row[S_Xr1 * ld], Xr2 = row[S_Xr2 * ld], Xs = row[S_Xs * ld];
        const float m = row[S_m * ld], h = row[S_h * ld], j = row[S_j * ld];
        const float d = row[S_d * ld], f = row[S_f * ld], f2 = row[S_f2 * ld];
        const float fCass = row[S_fCass * ld], s = row[S_s * ld], r = row[S_r * ld];
        const float Ca_i = row[S_Ca_i * ld], R_prime = row[S_R_prime * ld];
        const float Ca_SR = row[S_Ca_SR * ld], Ca_ss = row[S_Ca_ss * ld];
        const float Na_i = row[S_Na_i * ld], K_i = row[S_K_i * ld];

        // V-only current factors
        const float RTF = TP(R) * TP(T) / TP(F);
        const float VFRT = V / RTF;
        const float x = 2.0f * (V - 15.0f) * (1.0f / RTF);
        const float ex = expf(x);
        const float ex1 = ex - 1.0f;
        const float xg = fabsf(x) < 1e-7f ? 1.0f - 0.5f * x : x / (fabsf(ex1) < 1e-30f ? 1.0f : ex1);
        const float caL1 = TP(g_CaL) * 2.0f * TP(F) * 0.25f * ex * xg;
        const float caL2 = TP(g_CaL) * 2.0f * TP(F) * TP(Ca_o) * xg;
        const float naK = TP(P_NaK) * TP(K_o) / (TP(K_o) + TP(K_mk)) /
                          (1.0f + 0.1245f * expf(-0.1f * VFRT) + 0.0353f * expf(-VFRT));
        const float denom = (TP(Km_Nai) * TP(Km_Nai) * TP(Km_Nai) + TP(Na_o) * TP(Na_o) * TP(Na_o)) *
                            (TP(Km_Ca) + TP(Ca_o));
        const float e2 = expf((TP(gamma) - 1.0f) * VFRT);
        const float sat = 1.0f + TP(K_sat) * e2;
        const float naCa1 = TP(K_NaCa) * TP(Ca_o) * expf(TP(gamma) * VFRT) / (denom * sat);
        const float naCa2 = TP(K_NaCa) * (TP(Na_o) * TP(Na_o) * TP(Na_o)) * TP(alpha) * e2 / (denom * sat);
        const float pK = 1.0f / (1.0f + expf((25.0f - V) / 5.98f));

        // currents, on the old gate values
        const float g_Ks = is_mid ? 0.098f : TP(g_Ks);
        const float g_to = is_endo ? 0.073f : TP(g_to);

        const float E_Na = RTF * logf(TP(Na_o) / Na_i);
        const float E_K = RTF * logf(TP(K_o) / K_i);
        const float E_Ks = RTF * logf((TP(K_o) + TP(P_kna) * TP(Na_o)) / (K_i + TP(P_kna) * Na_i));
        const float E_Ca = 0.5f * RTF * logf(TP(Ca_o) / Ca_i);

        const float u = V - E_K;
        const float a_K1 = 0.1f / (1.0f + expf(0.06f * (u - 200.0f)));
        const float b_K1 = (3.0f * expf(0.0002f * (u + 100.0f)) + expf(0.1f * (u - 10.0f))) /
                           (1.0f + expf(-0.5f * u));
        const float xK1 = a_K1 / (a_K1 + b_K1);
        const float sqrt_ko = sqrtf(TP(K_o) / 5.4f);

        const float i_K1 = TP(g_K1) * xK1 * sqrt_ko * (V - E_K);
        const float i_Kr = TP(g_Kr) * sqrt_ko * Xr1 * Xr2 * (V - E_K);
        const float i_Ks = g_Ks * sq(Xs) * (V - E_Ks);
        const float i_Na = TP(g_Na) * (m * m * m) * h * j * (V - E_Na);
        const float i_b_Na = TP(g_bna) * (V - E_Na);
        const float i_CaL = d * f * f2 * fCass * (Ca_ss * caL1 - caL2);
        const float i_b_Ca = TP(g_bca) * (V - E_Ca);
        const float i_to = g_to * r * s * (V - E_K);
        const float i_NaK = naK * Na_i / (Na_i + TP(K_mNa));
        const float i_NaCa = naCa1 * (Na_i * Na_i * Na_i) - naCa2 * Ca_i;
        const float i_p_Ca = TP(g_pCa) * Ca_i / (Ca_i + TP(K_pCa));
        const float i_p_K = TP(g_pK) * (V - E_K) * pK;

        const float i_up = TP(Vmax_up) / (1.0f + sq(TP(K_up)) / sq(Ca_i));
        const float i_leak = TP(V_leak) * (Ca_SR - Ca_i);
        const float i_xfer = TP(V_xfer) * (Ca_ss - Ca_i);
        const float kcasr = TP(max_sr) - (TP(max_sr) - TP(min_sr)) / (1.0f + sq(TP(EC) / Ca_SR));
        const float k1 = TP(k1_prime) / kcasr;
        const float k2 = TP(k2_prime) * kcasr;
        const float O = k1 * sq(Ca_ss) * R_prime / (TP(k3) + k1 * sq(Ca_ss));
        const float i_rel = TP(V_rel) * O * (Ca_SR - Ca_ss);

        // periodic pacing stimulus (amplitude 0 in tissue mode)
        const float t_in_period = t - floorf(t / TP(stim_period)) * TP(stim_period);
        const float i_Stim =
            (t_in_period >= TP(stim_start) && t_in_period <= TP(stim_start) + TP(stim_duration))
                ? TP(stim_amplitude)
                : 0.0f;

        // non-gate derivatives
        const float CmF = TP(Cm) / (TP(V_c) * TP(F));
        const float f_free_i = 1.0f / (1.0f + TP(Buf_c) * TP(K_buf_c) / sq(Ca_i + TP(K_buf_c)));
        const float f_free_sr = 1.0f / (1.0f + TP(Buf_sr) * TP(K_buf_sr) / sq(Ca_SR + TP(K_buf_sr)));
        const float f_free_ss = 1.0f / (1.0f + TP(Buf_ss) * TP(K_buf_ss) / sq(Ca_ss + TP(K_buf_ss)));

        const float dCa_i = (-(i_b_Ca + i_p_Ca - 2.0f * i_NaCa) * CmF / 2.0f +
                             (i_leak - i_up) * TP(V_sr) / TP(V_c) + i_xfer) *
                            f_free_i;
        const float dCa_SR = (i_up - (i_rel + i_leak)) * f_free_sr;
        const float dCa_ss = (-i_CaL * TP(Cm) / (2.0f * TP(V_ss) * TP(F)) + i_rel * TP(V_sr) / TP(V_ss) -
                              i_xfer * TP(V_c) / TP(V_ss)) *
                             f_free_ss;
        const float dNa_i = -(i_Na + i_b_Na + 3.0f * i_NaK + 3.0f * i_NaCa) * CmF;
        const float dV = -(i_K1 + i_to + i_Kr + i_Ks + i_CaL + i_NaK + i_Na + i_b_Na + i_NaCa +
                           i_b_Ca + i_p_K + i_p_Ca + i_Stim);
        const float dK_i = -(i_K1 + i_to + i_Kr + i_Ks + i_p_K + i_Stim - 2.0f * i_NaK) * CmF;

        const float rp_rate = k2 * Ca_ss + TP(k4);
        const float rp_inf = TP(k4) / rp_rate;

        // fCass gates on the old Ca_ss
        const float y = 1.0f / (1.0f + sq(Ca_ss / 0.05f));
        const float fCass_inf = 0.6f * y + 0.4f;
        const float tau_fCass = 80.0f * y + 2.0f;

        row[S_V * ld] = V + dt * dV;
        row[S_fCass * ld] = rl(fCass, fCass_inf, tau_fCass, dt);
        row[S_Ca_i * ld] = Ca_i + dt * dCa_i;
        row[S_R_prime * ld] = rp_inf + (R_prime - rp_inf) * expf(-dt * rp_rate);
        row[S_Ca_SR * ld] = Ca_SR + dt * dCa_SR;
        row[S_Ca_ss * ld] = Ca_ss + dt * dCa_ss;
        row[S_Na_i * ld] = Na_i + dt * dNa_i;
        row[S_K_i * ld] = K_i + dt * dK_i;
    }

    // ---- phase 2: the V-only gates, one at a time ---------------------------
    // Each reads its own row, which phase 1 did not write: the old value.
#define GATE(S, x_inf, tau)                                  \
    do {                                                     \
        const float inf_ = (x_inf);                          \
        const float tau_ = (tau);                            \
        row[(S) * ld] = rl(row[(S) * ld], inf_, tau_, dt);   \
    } while (0)
    GATE(S_Xr1, 1.0f / (1.0f + expf((-26.0f - V) / 7.0f)),
         (450.0f / (1.0f + expf((-45.0f - V) / 10.0f))) * (6.0f / (1.0f + expf((V + 30.0f) / 11.5f))));
    GATE(S_Xr2, 1.0f / (1.0f + expf((V + 88.0f) / 24.0f)),
         (3.0f / (1.0f + expf((-60.0f - V) / 20.0f))) * (1.12f / (1.0f + expf((V - 60.0f) / 20.0f))));
    GATE(S_Xs, 1.0f / (1.0f + expf((-5.0f - V) / 14.0f)),
         (1400.0f / sqrtf(1.0f + expf((5.0f - V) / 6.0f))) * (1.0f / (1.0f + expf((V - 35.0f) / 15.0f))) +
             80.0f);
    GATE(S_m, 1.0f / sq(1.0f + expf((-56.86f - V) / 9.03f)),
         (1.0f / (1.0f + expf((-60.0f - V) / 5.0f))) *
             (0.1f / (1.0f + expf((V + 35.0f) / 5.0f)) + 0.1f / (1.0f + expf((V - 50.0f) / 200.0f))));
    const bool lo = V < -40.0f;
    const float h_inf = 1.0f / sq(1.0f + expf((V + 71.55f) / 7.43f));  // j_inf too
    {
        const float a_h = lo ? 0.057f * expf(-(V + 80.0f) / 6.8f) : 0.0f;
        const float b_h = lo ? 2.7f * expf(0.079f * V) + 310000.0f * expf(0.3485f * V)
                             : 0.77f / (0.13f * (1.0f + expf((V + 10.66f) / -11.1f)));
        GATE(S_h, h_inf, 1.0f / (a_h + b_h));
    }
    {
        const float a_j = lo ? (-25428.0f * expf(0.2444f * V) - 6.948e-6f * expf(-0.04391f * V)) *
                                   (V + 37.78f) / (1.0f + expf(0.311f * (V + 79.23f)))
                             : 0.0f;
        const float b_j = lo ? 0.02424f * expf(-0.01052f * V) / (1.0f + expf(-0.1378f * (V + 40.14f)))
                             : 0.6f * expf(0.057f * V) / (1.0f + expf(-0.1f * (V + 32.0f)));
        GATE(S_j, h_inf, 1.0f / (a_j + b_j));
    }
    GATE(S_d, 1.0f / (1.0f + expf((-8.0f - V) / 7.5f)),
         (1.4f / (1.0f + expf((-35.0f - V) / 13.0f)) + 0.25f) * (1.4f / (1.0f + expf((V + 5.0f) / 5.0f))) +
             1.0f / (1.0f + expf((50.0f - V) / 20.0f)));
    GATE(S_f, 1.0f / (1.0f + expf((V + 20.0f) / 7.0f)),
         1102.5f * expf(-sq(V + 27.0f) / 225.0f) + 200.0f / (1.0f + expf((13.0f - V) / 10.0f)) +
             180.0f / (1.0f + expf((V + 30.0f) / 10.0f)) + 20.0f);
    GATE(S_f2, 0.67f / (1.0f + expf((V + 35.0f) / 7.0f)) + 0.33f,
         562.0f * expf(-sq(V + 27.0f) / 240.0f) + 31.0f / (1.0f + expf((25.0f - V) / 10.0f)) +
             80.0f / (1.0f + expf((V + 30.0f) / 10.0f)));
    GATE(S_s,
         is_endo ? 1.0f / (1.0f + expf((V + 28.0f) / 5.0f)) : 1.0f / (1.0f + expf((V + 20.0f) / 5.0f)),
         is_endo ? 1000.0f * expf(-sq(V + 67.0f) / 1000.0f) + 8.0f
                 : 85.0f * expf(-sq(V + 45.0f) / 320.0f) + 5.0f / (1.0f + expf((V - 20.0f) / 5.0f)) + 3.0f);
    GATE(S_r, 1.0f / (1.0f + expf((20.0f - V) / 6.0f)), 9.5f * expf(-sq(V + 40.0f) / 1800.0f) + 0.8f);
#undef GATE
#undef TP
}

}  // namespace fbt
