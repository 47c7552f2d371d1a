// B1 for ToR-ORd dynCl + Land: one generalized Rush-Larsen step with the
// PDE voltage injected into row v first, one parameter set for every node.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// v_index form, traced over
// fenicsx_beat_tpu/models/torord_dyncl_land.py:generalized_rush_larsen
// (single-cell pre-pacing of the Land LV's layers, and the one-step and
// beat checks).  The formulas live in torord.cuh (the ionic part, with
// Land's dcai) and torord_land.cuh (the 7 mechanics states), shared with
// the node-parameter form and B7.
//
// What bounds it on the H100: device memory by design.  A step reads 51
// state rows and v (row v is overwritten, never read) and writes 52 rows
// back, 416 B a node in f32 (184 MB at the Niederer slab's n = 442,401:
// 55 us at the H100 SXM data sheet's 3.35 TB/s).  As ToR-ORd's B1, its
// instructions set its time, and it takes that kernel's design
// (torord_grl.cu): the 136 parameters (544 B) by value in the launch,
// staged, the approximate division.
#include "torord_land.cuh"

namespace {

__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_land_grl_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                  int n, float t, float dt, TorordLandParams p) {
    fbt::staged_steps<TORORD_LAND_NUM_STATES, TORORD_BLOCK, false>(
        states, vin, nullptr, n, (n + TORORD_BLOCK - 1) / TORORD_BLOCK, [](int k) { return k; },
        [&](float* row, long long ld, float v, int i, int) {
            fbt::torord_grl_node<true>(row, ld, v, t, dt, fbt::ParamSet<TorordLandParams>{p});
            return static_cast<int>(TORORD_LAND_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One GRL step over the (52, n) states, in place, with v replacing row v
// first (v may alias that row).  `params` points to the 136 parameters on
// the host, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int torord_land_grl_step_v(float* states, const float* v, long long n, float t, float dt,
                           const float* params, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    TorordLandParams p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kTorordLandNumParams; ++k) dst[k] = params[k];
    static int cap = 0;
    const long long ntiles = fbt::num_blocks(n, TORORD_BLOCK);
    const auto kernel = &torord_land_grl_step_v_kernel;
    const auto launch =
        fbt::torord_launch<TORORD_LAND_NUM_STATES, false>(kernel, true, TORORD_BLOCK, ntiles, cap);
    kernel<<<launch.grid, TORORD_BLOCK, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, static_cast<int>(n), t, dt, p);
    return cudaGetLastError();
}

}  // extern "C"
