// B7 for ToR-ORd dynCl + Land: the multi-marker ionic step -- one
// generalized Rush-Larsen step per node with that node's own parameter
// set (the LV's endo / mid / epi layers), the PDE voltage injected into
// row v of every node first.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ode.py:build_pallas_multi_ode_step
// over Land layers, with the semantics of tp06_grl_multi.cu: v is written
// into row v of every node; a node of model i steps with row i of the
// [nm, 136] parameter table; a node in no mask (model index outside
// [0, nm)) keeps its states, with v injected; states are updated in place.
// Its mixed-model form, where Land shares the union [S_max, n] states
// with other models (Land's 52 rows are S_max beside TP06's 19), launches
// over a list of blocks and leaves the nodes of other models (index
// fbt::kOtherModel) untouched (common.cuh: multi_grid).  The formulas are
// torord.cuh's and torord_land.cuh's, the one copy B1 runs.
//
// What bounds it on the H100: device memory, as for B1.  A step reads 51
// state rows (row v is overwritten, never read), v and the int32 model
// index and writes 52 rows: 420 B a node, 102 MB at the LV of psize 0.1
// (n = 243,518), a floor of 30.5 us at the H100 SXM data sheet's
// 3.35 TB/s.  As for B1, its instructions set its time.  ToR-ORd's B7
// design (torord_grl_multi.cu): over every block one node a thread, at
// least TORORD_LAND_MULTI_MIN_BLOCKS blocks an SM (the most that spill no
// register); over a block list staged.
//
// torord_land_fe_multi.cu builds this source again in forward Euler (FBT_FORWARD_EULER,
// common.cuh): the entry point FBT_ENTRY names, the node body's kFE.
#include "torord_land.cuh"

namespace {

template <bool kBlocks>
__global__ void __launch_bounds__(fbt::kThreads, fbt::torord_b7_min_blocks(kBlocks, TORORD_LAND_MULTI_MIN_BLOCKS))
    torord_land_grl_multi_step_v_kernel(float* states, const float* vin,  // vin may alias row v
                                        const int* __restrict__ model, int n, float t, float dt,
                                        const TorordLandParams* __restrict__ table, int nm,
                                        const int* __restrict__ blocks, int ntiles) {
    fbt::torord_steps<TORORD_LAND_NUM_STATES, fbt::kThreads, true, kBlocks>(
        states, vin, model, n, ntiles, [&](int k) { return kBlocks ? __ldg(blocks + k) : k; },
        [&](float* row, long long ld, float v, int, int mi) {
            if (kBlocks && mi == fbt::kOtherModel) return 0;  // another model's node (the mixed form)
            if (mi < 0 || mi >= nm) return 1;  // in no layer: V injected, the other rows stay
            const float* prow = reinterpret_cast<const float*>(table + mi);
            fbt::torord_grl_node<true, fbt::kForwardEuler>(row, ld, v, t, dt, fbt::StridedParams{prow, 1});
            return static_cast<int>(TORORD_LAND_NUM_STATES);
        });
}

}  // namespace

extern "C" {

// One multi-marker GRL step over the (52, n) states (the first 52 rows of
// a union array with row stride n), in place, with v replacing row v first
// (v may alias that row).  `model` holds n int32 model indices; `table`
// points to nm parameter sets of 136 floats each, on the device, in
// _PARAM_NAMES order; `blocks` lists the nblocks blocks to launch, or is
// null for all of them.  Returns the cudaError_t of the launch.
int FBT_ENTRY(torord_land, multi_step_v)(float* states, const float* v, const int* model, long long n, float t,
                                         float dt, const float* table, int nm, const int* blocks, int nblocks,
                                         void* stream) {
    if (!fbt::multi_args_ok(n, nm, blocks, nblocks)) return cudaErrorInvalidValue;
    static_assert(TR_v == 0, "row v is row 0");
    static int caps[2] = {0, 0};
    const auto kernel =
        blocks ? &torord_land_grl_multi_step_v_kernel<true> : &torord_land_grl_multi_step_v_kernel<false>;
    const long long ntiles = fbt::multi_grid(n, blocks, nblocks);
    const auto launch = fbt::torord_launch<TORORD_LAND_NUM_STATES, true>(
        kernel, blocks != nullptr, fbt::kThreads, ntiles, caps[blocks != nullptr]);
    kernel<<<launch.grid, fbt::kThreads, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, model, static_cast<int>(n), t, dt, reinterpret_cast<const TorordLandParams*>(table), nm, blocks,
        static_cast<int>(ntiles));
    return cudaGetLastError();
}

}  // extern "C"
