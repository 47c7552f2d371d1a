// B1 for the ToR-ORd dynCl model: one generalized Rush-Larsen step with the
// PDE voltage injected into row v first, one parameter set for every node.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// v_index form, traced over
// fenicsx_beat_tpu/models/torord_dyncl.py:generalized_rush_larsen (the
// slab demo's ionic step, demos/slab.py:73-84, and single-cell pacing).
// The formulas live in torord.cuh, shared with the node-parameter form and
// the multi-marker kernel (B7).
//
// What bounds it on the H100: device memory by design.  A step reads 44
// state rows and v (row v is overwritten, never read) and writes 45 rows
// back, 360 B a node in f32 (87.7 MB at the LV's n = 243,518: 26.2 us at
// the H100 SXM data sheet's 3.35 TB/s), against about 1,000 float operations a node (3.6 us at
// 67 TFLOP/s).  The design is TP06's (tp06_grl.cu): one thread per node,
// the node's states in registers, each state row read once and written
// once, coalesced, in place; the 108 parameters (432 B) arrive by value
// in the launch (constant bank).  45 states and about 110 transcendental
// results press against the 255-register limit: torord.cuh stores each
// gate as soon as its new value is known.
#include "torord.cuh"

namespace {

__global__ void __launch_bounds__(fbt::kThreads)
    torord_grl_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                             int n, float t, float dt, TorordParams p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::torord_grl_node(states + i, n, vin[i], t, dt, fbt::ParamSet<TorordParams>{p});
}

}  // namespace

extern "C" {

// One GRL step over the (45, n) states, in place, with v replacing row v
// first (v may alias that row).  `params` points to the 108 parameters on
// the host, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int torord_grl_step_v(float* states, const float* v, long long n, float t, float dt,
                      const float* params, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    TorordParams p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kTorordNumParams; ++k) dst[k] = params[k];
    torord_grl_step_v_kernel<<<fbt::num_blocks(n), fbt::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(states, v, static_cast<int>(n),
                                                                    t, dt, p);
    return cudaGetLastError();
}

}  // extern "C"
