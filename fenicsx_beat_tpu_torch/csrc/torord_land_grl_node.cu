// B1's per-node parameter form for ToR-ORd dynCl + Land: one generalized
// Rush-Larsen step in which node i reads its parameter k from a
// node-aligned [136, n] field, params[k * n + i], the PDE voltage injected
// into row v first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// node_params form (pallas_ode.py:252-275, 311-320), which the JAX fused
// solver takes for 2-D `parameters`.  The formulas are torord.cuh's and
// torord_land.cuh's, the one copy B1 and B7 run; only where the parameters
// come from differs (fbt::StridedParams, common.cuh).
//
// What bounds it on the H100: device memory.  Beside B1's 51 state rows
// and v read and 52 rows written, each node reads its 136 parameters once,
// coalesced: 960 B a node against B1's 416.  B1's design: staged, 128
// registers a thread (265 us unstaged against 222 us at n = 442,401 on an
// H100 80GB HBM3 at 700 W, benchmarks/b1_designs.py).
//
// torord_land_fe_node.cu builds this source again in forward Euler (FBT_FORWARD_EULER,
// common.cuh): the entry point FBT_ENTRY names, the node body's kFE.
#include "torord_land.cuh"

namespace {

__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_land_grl_node_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                       const float* __restrict__ params, int n, float t, float dt) {
    fbt::staged_steps<TORORD_LAND_NUM_STATES, TORORD_BLOCK, false>(
        states, vin, nullptr, n, (n + TORORD_BLOCK - 1) / TORORD_BLOCK, [](int k) { return k; },
        [&](float* row, long long ld, float v, int i, int) {
            fbt::torord_grl_node<true, fbt::kForwardEuler>(row, ld, v, t, dt, fbt::StridedParams{params + i, n});
            return static_cast<int>(TORORD_LAND_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One GRL step over the (52, n) states, in place, with v replacing row v
// first (v may alias that row); `params` is the [136, n] parameter field
// on the device, in _PARAM_NAMES order.  Returns the cudaError_t of the
// launch.
int FBT_ENTRY(torord_land, node_step_v)(float* states, const float* v, const float* params, long long n,
                                        float t, float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    static int cap = 0;
    const long long ntiles = fbt::num_blocks(n, TORORD_BLOCK);
    const auto kernel = &torord_land_grl_node_step_v_kernel;
    const auto launch =
        fbt::torord_launch<TORORD_LAND_NUM_STATES, false>(kernel, true, TORORD_BLOCK, ntiles, cap);
    kernel<<<launch.grid, TORORD_BLOCK, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, params, static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // extern "C"
