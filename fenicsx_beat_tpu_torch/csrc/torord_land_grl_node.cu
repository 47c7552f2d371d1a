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
// coalesced: 960 B a node against B1's 416.
#include "torord_land.cuh"

namespace {

__global__ void __launch_bounds__(fbt::kThreads)
    torord_land_grl_node_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                       const float* __restrict__ params, int n, float t, float dt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::torord_grl_node<true>(states + i, n, vin[i], t, dt, fbt::StridedParams{params + i, n});
}

}  // namespace

extern "C" {

// One GRL step over the (52, n) states, in place, with v replacing row v
// first (v may alias that row); `params` is the [136, n] parameter field
// on the device, in _PARAM_NAMES order.  Returns the cudaError_t of the
// launch.
int torord_land_grl_node_step_v(float* states, const float* v, const float* params, long long n,
                                float t, float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    torord_land_grl_node_step_v_kernel<<<fbt::num_blocks(n), fbt::kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        states, v, params, static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // extern "C"
