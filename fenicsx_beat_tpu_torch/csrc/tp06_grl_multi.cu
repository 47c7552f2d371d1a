// B7: the multi-marker ionic step -- one TP06 generalized Rush-Larsen step
// per node with that node's own parameter set (endo / mid / epi layers),
// the PDE voltage injected into row V of every node first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_multi_ode_step.
// Semantics kept from it (pallas_ode.py:389-416): the voltage v is written
// into row V of every node; a node of model i gets model i's step over its
// states; a node in no mask (model index outside [0, nm)) keeps its states,
// with V injected; states are updated in place.
//
// The TPU kernel gates each model per grid block with a host table
// active[model, block] and overlays each model's result through its mask,
// so a block that holds two layers pays for two models.  Here one thread
// per node reads its model index (int32, built on the host from the masks)
// and runs its own model alone: the same result, with no table.  A warp
// that straddles a layer boundary diverges on the celltype branches only
// (the formulas are one copy, tp06.cuh).  The parameter table [nm, 54] is
// read from device memory by reference; every thread of a warp reads the
// same few rows, which L1 broadcasts.
//
// The mixed-model form (markers that run different models, the JAX
// kernel's `swaps` and `active` table): the union states are [S_max, n],
// each model's launch steps its own nodes on its own S rows (row stride
// n), over only the blocks that list holds (common.cuh: multi_grid), and
// leaves a node of another model (index fbt::kOtherModel) untouched.
//
// What bounds it on the H100: device memory, as for B1.  At the LV of
// psize 0.1 (n = 243,518, f32) a step reads 18 state rows (row V is
// overwritten, never read), v and the model index and writes 19 rows:
// about 38 MB, a floor of about 11 us at the H100 SXM data sheet's
// 3.35 TB/s.  As for B1, its instructions set its time in practice, and it
// takes B1's design (tp06_grl.cu): the two-phase body, the register cap
// and the approximate division.
#include "tp06.cuh"

namespace {

template <bool kBlocks>
__global__ void __launch_bounds__(fbt::kThreads, TP06_MIN_BLOCKS * TP06_BLOCK / fbt::kThreads)
    tp06_grl_multi_step_v_kernel(float* states, const float* vin,  // vin may alias row V
                                 const int* __restrict__ model, int n, float t, float dt,
                                 const Tp06Params* __restrict__ table, int nm,
                                 const int* __restrict__ blocks) {
    const int i = fbt::multi_node<kBlocks>(blocks);
    if (i >= n) return;
    const int mi = model[i];
    if (kBlocks && mi == fbt::kOtherModel) return;  // another model's node (the mixed form)
    const float V = vin[i];
    if (mi < 0 || mi >= nm) {
        states[i] = V;  // row V (S_V = 0); the other rows stay
        return;
    }
    const float* row = reinterpret_cast<const float*>(table + mi);
    fbt::tp06_grl_node(states + i, n, V, t, dt, fbt::StridedParams{row, 1});
}

}  // namespace

extern "C" {

// One multi-marker GRL step over the (19, n) states (the first 19 rows of
// a union array with row stride n), in place, with v replacing row V
// first (v may alias row V).  `model` holds n int32 model indices; `table`
// points to nm parameter sets of 54 floats each, on the device, in
// _PARAM_NAMES order; `blocks` lists the nblocks blocks to launch, or is
// null for all of them.  Returns the cudaError_t of the launch.
int tp06_grl_multi_step_v(float* states, const float* v, const int* model, long long n, float t,
                          float dt, const float* table, int nm, const int* blocks, int nblocks,
                          void* stream) {
    if (!fbt::multi_args_ok(n, nm, blocks, nblocks)) return cudaErrorInvalidValue;
    static_assert(S_V == 0, "row V is row 0");
    const auto kernel = blocks ? &tp06_grl_multi_step_v_kernel<true> : &tp06_grl_multi_step_v_kernel<false>;
    kernel<<<fbt::multi_grid(n, blocks, nblocks), fbt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        states, v, model, static_cast<int>(n), t, dt, reinterpret_cast<const Tp06Params*>(table), nm, blocks);
    return cudaGetLastError();
}

}  // extern "C"
