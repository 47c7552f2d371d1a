// B1: one forward-Euler step of the modified FitzHugh-Nagumo model, with
// the PDE voltage injected into row v (row 1) first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// v_index form, traced over
// fenicsx_beat_tpu/models/fitzhughnagumo.py:forward_euler (the bidomain
// demo's ionic step, demos/bidomain_ue.py:64).  The formulas live in
// fhn.cuh, shared with the per-node form and B7.
//
// What bounds it on the H100: device memory.  A node reads s and the
// injected v and writes s and v: 16 B (row v is overwritten, never read);
// 28 float operations, far below the float32 rate's share of those bytes.
// The design is one thread per node, both states in registers, each row
// read and written once, coalesced, in place; the 11 parameters arrive by
// value in the launch (constant bank).
#include "fhn.cuh"

namespace {

__global__ void __launch_bounds__(fbt::kThreads)
    fhn_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                      int n, float t, float dt, FhnParams p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::fhn_node(states + i, n, FHN_s, FHN_v, vin[i], t, dt, fbt::ParamSet<FhnParams>{p});
}

}  // namespace

extern "C" {

// One forward-Euler step over the (2, n) states, in place, with v replacing
// row v first (v may alias row v).  `params` points to the 11 parameters on
// the host, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int fhn_step_v(float* states, const float* v, long long n, float t, float dt, const float* params,
               void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    FhnParams p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kFhnNumParams; ++k) dst[k] = params[k];
    fhn_step_v_kernel<<<fbt::num_blocks(n), fbt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        states, v, static_cast<int>(n), t, dt, p);
    return cudaGetLastError();
}

}  // extern "C"
