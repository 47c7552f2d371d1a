// B7: the multi-marker ionic step for the modified FitzHugh-Nagumo model --
// one forward-Euler step per node with that node's own parameter set, the
// PDE voltage injected first.  Its mixed-model form (a block list, nodes
// of other models left untouched) is tp06_grl_multi.cu's.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_multi_ode_step.
// The states are in make_multi_ode's storage layout, where every model's
// voltage is row 0: FHN keeps v in its row 1, so its storage swaps the two
// rows (v in row 0, s in row 1), as the JAX kernel's per-model `swaps`
// permute them (pallas_ode.py:407-412).  Semantics kept from it: v is
// written into row 0 of every node; a node of model i gets model i's step;
// a node in no mask (model index outside [0, nm)) keeps its states, with v
// injected; states are updated in place.  One thread per node reads its
// model index and runs its own parameter set (tp06_grl_multi.cu explains
// why no per-block `active` table is needed).
//
// What bounds it on the H100: device memory.  A node reads v, s and its
// model index and writes both rows: 20 B; the [nm, 11] table is read
// through the read-only path, every thread of a warp on the same few rows.
#include "fhn.cuh"

namespace {

constexpr int kStorageV = 0;  // make_multi_ode stores every model's voltage in row 0
constexpr int kStorageS = 1;  // and FHN's s in the voltage's own row

template <bool kBlocks>
__global__ void __launch_bounds__(fbt::kThreads)
    fhn_multi_step_v_kernel(float* states, const float* vin,  // vin may alias row 0
                            const int* __restrict__ model, int n, float t, float dt,
                            const FhnParams* __restrict__ table, int nm, const int* __restrict__ blocks) {
    const int i = fbt::multi_node<kBlocks>(blocks);
    if (i >= n) return;
    const int mi = model[i];
    if (kBlocks && mi == fbt::kOtherModel) return;  // another model's node (the mixed form)
    const float V = vin[i];
    if (mi < 0 || mi >= nm) {
        states[kStorageV * static_cast<long long>(n) + i] = V;  // s stays
        return;
    }
    const float* row = reinterpret_cast<const float*>(table + mi);
    fbt::fhn_node(states + i, n, kStorageS, kStorageV, V, t, dt, fbt::StridedParams{row, 1});
}

}  // namespace

extern "C" {

// One multi-marker forward-Euler step over the (2, n) states in
// make_multi_ode's storage layout (v in row 0, s in row 1; the first two
// rows of a union array with row stride n), in place, with v replacing row
// 0 first (v may alias row 0).  `model` holds n int32 model indices;
// `table` points to nm parameter sets of 11 floats each, on the device, in
// _PARAM_NAMES order; `blocks` lists the nblocks blocks to launch, or is
// null for all of them.  Returns the cudaError_t of the launch.
int fhn_multi_step_v(float* states, const float* v, const int* model, long long n, float t,
                     float dt, const float* table, int nm, const int* blocks, int nblocks, void* stream) {
    if (!fbt::multi_args_ok(n, nm, blocks, nblocks)) return cudaErrorInvalidValue;
    const auto kernel = blocks ? &fhn_multi_step_v_kernel<true> : &fhn_multi_step_v_kernel<false>;
    kernel<<<fbt::multi_grid(n, blocks, nblocks), fbt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        states, v, model, static_cast<int>(n), t, dt, reinterpret_cast<const FhnParams*>(table), nm, blocks);
    return cudaGetLastError();
}

}  // extern "C"
