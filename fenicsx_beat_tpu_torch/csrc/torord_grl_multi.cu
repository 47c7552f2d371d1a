// B7 for the ToR-ORd dynCl model: the multi-marker ionic step -- one
// generalized Rush-Larsen step per node with that node's own parameter set
// (the LV demo's endo / mid / epi layers, demos/lv_endocardial.py:69-116),
// the PDE voltage injected into row v of every node first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_multi_ode_step
// over ToR-ORd layers, with the semantics of tp06_grl_multi.cu: v is
// written into row v of every node; a node of model i steps with row i of
// the [nm, 108] parameter table; a node in no mask (model index outside
// [0, nm)) keeps its states, with v injected; states are updated in place.
// The formulas are torord.cuh's, the one copy B1 runs.  The table is read
// by reference through the read-only path: the nodes of a warp almost
// always share a layer, so their reads of a row broadcast.  The
// mixed-model form (a block list, nodes of other models left untouched)
// is tp06_grl_multi.cu's.
//
// What bounds it on the H100: device memory, as for B1.  A step reads 44
// state rows (row v is overwritten, never read), v and the int32 model
// index and writes 45 rows: 364 B a node, 88.6 MB at the LV of psize 0.1
// (n = 243,518), a floor of 26.5 us at the H100 SXM data sheet's
// 3.35 TB/s.  As for B1, its instructions set its time.  Over every block it
// runs one node a thread, at least TORORD_MULTI_MIN_BLOCKS blocks an SM (80
// registers); over a block list staged (staged.cuh), where the staging
// measured faster and over every block slower (benchmarks/b1_designs.py).
#include "torord.cuh"

namespace {

template <bool kBlocks>
__global__ void __launch_bounds__(fbt::kThreads, fbt::torord_b7_min_blocks(kBlocks, TORORD_MULTI_MIN_BLOCKS))
    torord_grl_multi_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                   const int* __restrict__ model, int n, float t, float dt,
                                   const TorordParams* __restrict__ table, int nm,
                                   const int* __restrict__ blocks, int ntiles) {
    fbt::torord_steps<TORORD_NUM_STATES, fbt::kThreads, true, kBlocks>(
        states, vin, model, n, ntiles, [&](int k) { return kBlocks ? __ldg(blocks + k) : k; },
        [&](float* row, long long ld, float v, int, int mi) {
            if (kBlocks && mi == fbt::kOtherModel) return 0;  // another model's node (the mixed form)
            if (mi < 0 || mi >= nm) return 1;  // in no layer: V injected, the other rows stay
            const float* prow = reinterpret_cast<const float*>(table + mi);
            fbt::torord_grl_node(row, ld, v, t, dt, fbt::StridedParams{prow, 1});
            return static_cast<int>(TORORD_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One multi-marker GRL step over the (45, n) states (the first 45 rows of
// a union array with row stride n), in place, with v replacing row v first
// (v may alias that row).  `model` holds n int32 model indices; `table`
// points to nm parameter sets of 108 floats each, on the device, in
// _PARAM_NAMES order; `blocks` lists the nblocks blocks to launch, or is
// null for all of them.  Returns the cudaError_t of the launch.
int torord_grl_multi_step_v(float* states, const float* v, const int* model, long long n, float t,
                            float dt, const float* table, int nm, const int* blocks, int nblocks,
                            void* stream) {
    if (!fbt::multi_args_ok(n, nm, blocks, nblocks)) return cudaErrorInvalidValue;
    static_assert(TR_v == 0, "row v is row 0");
    static int caps[2] = {0, 0};
    const auto kernel = blocks ? &torord_grl_multi_step_v_kernel<true> : &torord_grl_multi_step_v_kernel<false>;
    const long long ntiles = fbt::multi_grid(n, blocks, nblocks);
    const auto launch = fbt::torord_launch<TORORD_NUM_STATES, true>(
        kernel, blocks != nullptr, fbt::kThreads, ntiles, caps[blocks != nullptr]);
    kernel<<<launch.grid, fbt::kThreads, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, model, static_cast<int>(n), t, dt, reinterpret_cast<const TorordParams*>(table), nm, blocks,
        static_cast<int>(ntiles));
    return cudaGetLastError();
}

}  // extern "C"
