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
// What bounds it on the H100: by its bytes, device memory.  A step reads 44
// state rows and v (row v is overwritten, never read) and writes 45 rows
// back, 360 B a node in f32 (87.7 MB at the LV's n = 243,518: 26.2 us at
// the H100 SXM data sheet's 3.35 TB/s), against about 1,700 float
// operations a node (6.2 us at 67 TFLOP/s).  In practice its instructions
// set its time: with the IEEE division 6,800 SASS instructions a node (208
// FCHK and 256 CALL of the division's checks and slow path) and 83 us on an
// H100 80GB HBM3 at 700 W; with the card's approximate division
// (-prec-div=false, _build.py) 4,500 and 58 us (benchmarks/b1_designs.py).
// The design: one thread per node, the 108 parameters by value in the
// launch (constant bank), the body in two phases so few values are live
// (torord.cuh), and the nodes staged (staged.cuh): persistent blocks of
// TORORD_BLOCK threads that load the next tile's states into shared memory
// while they step the current one, coalesced, in place.
//
// torord_fe.cu builds this source again in forward Euler (FBT_FORWARD_EULER,
// common.cuh): the entry point FBT_ENTRY names, the node body's kFE.
#include "torord.cuh"

namespace {

__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_grl_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                             int n, float t, float dt, TorordParams p) {
    fbt::staged_steps<TORORD_NUM_STATES, TORORD_BLOCK, false>(
        states, vin, nullptr, n, (n + TORORD_BLOCK - 1) / TORORD_BLOCK, [](int k) { return k; },
        [&](float* row, long long ld, float v, int i, int) {
            fbt::torord_grl_node<false, fbt::kForwardEuler>(row, ld, v, t, dt, fbt::ParamSet<TorordParams>{p});
            return static_cast<int>(TORORD_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One GRL step over the (45, n) states, in place, with v replacing row v
// first (v may alias that row).  `params` points to the 108 parameters on
// the host, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int FBT_ENTRY(torord, step_v)(float* states, const float* v, long long n, float t, float dt,
                              const float* params, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    TorordParams p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kTorordNumParams; ++k) dst[k] = params[k];
    static int cap = 0;
    const long long ntiles = fbt::num_blocks(n, TORORD_BLOCK);
    const auto kernel = &torord_grl_step_v_kernel;
    const auto launch =
        fbt::torord_launch<TORORD_NUM_STATES, false>(kernel, true, TORORD_BLOCK, ntiles, cap);
    kernel<<<launch.grid, TORORD_BLOCK, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, static_cast<int>(n), t, dt, p);
    return cudaGetLastError();
}

}  // extern "C"
