// B1's per-node parameter form for the modified FitzHugh-Nagumo model: one
// forward-Euler step in which node i reads its parameter k from a
// node-aligned [11, n] field, params[k * n + i], the PDE voltage injected
// into row v (row 1) first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// node_params form, which the JAX solvers take for 2-D `parameters`.  The
// formulas are fhn.cuh's; only where the parameters come from differs
// (fbt::StridedParams, common.cuh).
//
// What bounds it on the H100: device memory.  Beside B1's s and injected v
// read and both rows written, each node reads its 11 parameters once,
// coalesced (neighbouring threads on neighbouring addresses of each
// parameter row): 60 B a node against B1's 16.
#include "fhn.cuh"

namespace {

__global__ void __launch_bounds__(fbt::kThreads)
    fhn_node_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                           const float* __restrict__ params, int n, float t, float dt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::fhn_node(states + i, n, FHN_s, FHN_v, vin[i], t, dt, fbt::StridedParams{params + i, n});
}

}  // namespace

extern "C" {

// One forward-Euler step over the (2, n) states, in place, with v replacing
// row v first (v may alias row v); `params` is the [11, n] parameter field
// on the device, in _PARAM_NAMES order.  Returns the cudaError_t of the
// launch.
int fhn_node_step_v(float* states, const float* v, const float* params, long long n, float t,
                    float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    fhn_node_step_v_kernel<<<fbt::num_blocks(n), fbt::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(states, v, params,
                                                                  static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // extern "C"
