// B1: one generalized Rush-Larsen step of the ten Tusscher-Panfilov 2006
// ionic model, with the PDE voltage injected into row V first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_ode_step in its
// v_index form, traced over
// fenicsx_beat_tpu/models/tentusscher_panfilov_2006.py:generalized_rush_larsen.
// The formulas live in tp06.cuh, shared with the multi-marker kernel (B7).
//
// What bounds it on the H100: by its bytes, device memory.  At n = 442,401
// in f32 a step reads 18 state rows and v (row V is overwritten, never
// read) and writes 19 rows back: about 67 MB (counted from the shapes),
// whose floor at the H100 SXM data sheet's 3.35 TB/s is about 20 us.  In
// practice the instructions bound it: about 60 expf, 6 logf and 120
// divisions a node; with the IEEE division and the body in one phase the
// kernel's SASS lists 3,584 instructions, about a third of them the
// division's sequences, checks, slow-path calls and convergence barriers.
// The design is one thread per node, coalesced on the row-major (19, n)
// layout, in place, the 54 parameters by value in the launch (constant
// bank); the body runs in two phases so few values are
// live at once (tp06.cuh), at least TP06_MIN_BLOCKS blocks an SM, and the
// card's approximate division (-prec-div=false, _build.py).  On an H100
// 80GB HBM3 at 700 W (benchmarks/b1_designs.py): 116 registers and 60 us
// of device time with the body in one phase and the IEEE division, 70
// registers and 51 us in two phases, 59 registers and 30 us as built.
#include "tp06.cuh"

namespace {

__global__ void __launch_bounds__(TP06_BLOCK, TP06_MIN_BLOCKS)
    tp06_grl_step_v_kernel(float* states, const float* vin,  // vin may alias row V
                           int n, float t, float dt, Tp06Params p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fbt::tp06_grl_node(states + i, n, vin[i], t, dt, fbt::ParamSet<Tp06Params>{p});
}

}  // namespace

extern "C" {

// One GRL step over the (19, n) states, in place, with v replacing row V
// first (v may alias row V).  `params` points to the 54 parameters on the
// host, in _PARAM_NAMES order.  Returns the cudaError_t of the launch.
int tp06_grl_step_v(float* states, const float* v, long long n, float t, float dt,
                    const float* params, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    Tp06Params p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kTp06NumParams; ++k) dst[k] = params[k];
    tp06_grl_step_v_kernel<<<fbt::num_blocks(n, TP06_BLOCK), TP06_BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(states, v, static_cast<int>(n),
                                                                  t, dt, p);
    return cudaGetLastError();
}

}  // extern "C"
