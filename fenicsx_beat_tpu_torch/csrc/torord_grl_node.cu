// B1's per-node parameter form for the ToR-ORd dynCl model: one generalized
// Rush-Larsen step in which node i reads its parameter k from a
// node-aligned [108, n] field, params[k * n + i], the PDE voltage injected
// into row v first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// node_params form (the [NP, m, 128] parameter block streamed beside the
// states, pallas_ode.py:252-275, 311-320), which the JAX fused solver takes
// for 2-D `parameters` (fenicsx_beat_tpu/fused.py:213-217, 294-341).  The
// formulas are torord.cuh's, the one copy B1 and B7 run; only where the
// parameters come from differs (fbt::StridedParams, common.cuh).
//
// What bounds it on the H100: device memory.  Beside B1's 44 state rows
// and v read and 45 rows written, each node reads its 108 parameters once,
// coalesced (neighbouring threads on neighbouring addresses of each
// parameter row): 792 B a node against B1's 360.  It takes B1's design
// (torord_grl.cu): staged, 128 registers a thread; the staging overlaps the
// state loads with the step, 116 us unstaged against 94 us at the LV's
// n = 243,518 (H100 80GB HBM3, 700 W, benchmarks/b1_designs.py).
//
// torord_fe_node.cu builds this source again in forward Euler (FBT_FORWARD_EULER,
// common.cuh): the entry point FBT_ENTRY names, the node body's kFE.
#include "torord.cuh"

namespace {

__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_grl_node_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                  const float* __restrict__ params, int n, float t, float dt) {
    fbt::staged_steps<TORORD_NUM_STATES, TORORD_BLOCK, false>(
        states, vin, nullptr, n, (n + TORORD_BLOCK - 1) / TORORD_BLOCK, [](int k) { return k; },
        [&](float* row, long long ld, float v, int i, int) {
            fbt::torord_grl_node<false, fbt::kForwardEuler>(row, ld, v, t, dt, fbt::StridedParams{params + i, n});
            return static_cast<int>(TORORD_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One GRL step over the (45, n) states, in place, with v replacing row v
// first (v may alias that row); `params` is the [108, n] parameter field
// on the device, in _PARAM_NAMES order.  Returns the cudaError_t of the
// launch.
int FBT_ENTRY(torord, node_step_v)(float* states, const float* v, const float* params, long long n,
                                   float t, float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    static int cap = 0;
    const long long ntiles = fbt::num_blocks(n, TORORD_BLOCK);
    const auto kernel = &torord_grl_node_step_v_kernel;
    const auto launch =
        fbt::torord_launch<TORORD_NUM_STATES, false>(kernel, true, TORORD_BLOCK, ntiles, cap);
    kernel<<<launch.grid, TORORD_BLOCK, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, params, static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // extern "C"
