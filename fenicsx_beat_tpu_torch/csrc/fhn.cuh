// The modified FitzHugh-Nagumo model's forward-Euler step (its generalized
// Rush-Larsen step: FHN has no gates) for one node, shared by B1
// (fhn_step.cu), B1's per-node parameter form (fhn_node.cu) and the
// multi-marker kernel B7 (fhn_multi.cu), so all three run one copy of the
// formulas.
//
// The formulas are those of
// fenicsx_beat_tpu/models/fitzhughnagumo.py:rhs and forward_euler, term for
// term and in their order, in float32: the same strict stimulus window
// start < t < start + duration, compared in float32 as the JAX model traces
// it in the working dtype.
#pragma once

#include "common.cuh"

// State rows, in the order of _STATE_NAMES (the CPU tests parse this table).
enum FhnState {
    FHN_s = 0,
    FHN_v = 1,
    FHN_NUM_STATES = 2
};

// Parameters, in the order of _PARAM_NAMES (the CPU tests parse this table).
struct FhnParams {
    float c_1;
    float c_2;
    float c_3;
    float a;
    float b;
    float v_amp;
    float v_rest;
    float v_peak;
    float stim_amplitude;
    float stim_duration;
    float stim_start;
};
constexpr int kFhnNumParams = 11;
static_assert(sizeof(FhnParams) == kFhnNumParams * sizeof(float), "parameter table");

namespace fbt {

// One forward-Euler step of one node, in place: `row` points at the node's
// entry of state row 0 and consecutive state rows lie `ld` floats apart; s
// is read from row `s_row` and v written to row `v_row` (the model's own
// layout is s_row 0, v_row 1; the multi-marker storage swaps them); `V` is
// the voltage to step from (the injected PDE voltage); `prm` is where the
// parameters come from (fbt::ParamSet or fbt::StridedParams, common.cuh).
template <class Src>
__device__ __forceinline__ void fhn_node(float* row, long long ld, int s_row, int v_row, float V,
                                         float t, float dt, const Src& prm) {
#define FP(name) prm(offsetof(FhnParams, name) / sizeof(float))
    const float s = row[s_row * ld];
    const float v_amp = FP(v_amp), v_rest = FP(v_rest);
    const float i_app =
        (t > FP(stim_start) && t < FP(stim_start) + FP(stim_duration)) ? FP(stim_amplitude) : 0.0f;
    const float v_th = v_amp * FP(a) + v_rest;
    const float I = -s * (FP(c_2) / v_amp) * (V - v_rest) +
                    ((FP(c_1) / (v_amp * v_amp)) * (V - v_rest)) * (V - v_th) * (-V + FP(v_peak));
    const float ds_dt = FP(b) * (-FP(c_3) * s + (V - v_rest));
    const float dv_dt = I + i_app;
    row[s_row * ld] = s + dt * ds_dt;
    row[v_row * ld] = V + dt * dv_dt;
#undef FP
}

}  // namespace fbt
