// B1's per-node parameter form for the ten Tusscher-Panfilov 2006 model:
// one generalized Rush-Larsen step in which node i reads its parameter k
// from a node-aligned [54, n] field, params[k * n + i], the PDE voltage
// injected into row V first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// node_params form (the [NP, m, 128] parameter block streamed beside the
// states, pallas_ode.py:252-275, 311-320), which the JAX fused solver takes
// for 2-D `parameters` (fenicsx_beat_tpu/fused.py:213-217, 294-341).  The
// formulas are tp06.cuh's, the one copy B1 and B7 run; only where the
// parameters come from differs (fbt::StridedParams, common.cuh).
//
// What bounds it on the H100: device memory.  Beside B1's 18 state rows and
// v read and 19 rows written, each node reads its 54 parameters once,
// coalesced (neighbouring threads on neighbouring addresses of each
// parameter row): 368 B a node against B1's 152.  It takes B1's design
// (tp06_grl.cu): the two-phase body, the register cap and the approximate
// division.
//
// tp06_fe_node.cu builds this source again in forward Euler (FBT_FORWARD_EULER,
// common.cuh): the entry point FBT_ENTRY names, the node body's kFE.
#include "tp06.cuh"

namespace {

__global__ void __launch_bounds__(TP06_BLOCK, fbt::kForwardEuler ? TP06_FE_NODE_MIN_BLOCKS : TP06_MIN_BLOCKS)
    tp06_grl_node_step_v_kernel(float* states, const float* vin,  // vin may alias row V
                                const float* __restrict__ params, int n, float t, float dt) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::tp06_grl_node<fbt::kForwardEuler>(states + i, n, vin[i], t, dt, fbt::StridedParams{params + i, n});
}

}  // namespace

extern "C" {

// One GRL step over the (19, n) states, in place, with v replacing row V
// first (v may alias row V); `params` is the [54, n] parameter field on the
// device, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int FBT_ENTRY(tp06, node_step_v)(float* states, const float* v, const float* params, long long n,
                                 float t, float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    tp06_grl_node_step_v_kernel<<<fbt::num_blocks(n, TP06_BLOCK), TP06_BLOCK, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        states, v, params, static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // extern "C"
