// What the designs of ToR-ORd dynCl's and ToR-ORd dynCl + Land's ionic
// kernels that were measured on the card and not kept share
// (benchmarks/b1_designs.py builds them beside the kept kernels of
// csrc/torord_grl*.cu and csrc/torord_land_grl*.cu; PERF.md has the
// times): each model's sizes, and B7 over every block or a block list,
// staged or one node a thread, its parameter table read through the
// read-only path or copied into shared memory once a block.  The node body
// is the library's (csrc/torord.cuh, csrc/torord_land.cuh), so every design
// computes the kept kernels' function in the same arithmetic: only the
// launch and where the states and parameters are read from differ.
#pragma once

#include "torord_land.cuh"

namespace design {

template <bool kLand>
struct Model;
template <>
struct Model<false> {
    using Params = TorordParams;
    static constexpr int kS = TORORD_NUM_STATES;
    static constexpr int kNP = kTorordNumParams;
    static constexpr int kMultiMinBlocks = TORORD_MULTI_MIN_BLOCKS;
};
template <>
struct Model<true> {
    using Params = TorordLandParams;
    static constexpr int kS = TORORD_LAND_NUM_STATES;
    static constexpr int kNP = kTorordLandNumParams;
    static constexpr int kMultiMinBlocks = TORORD_LAND_MULTI_MIN_BLOCKS;
};

// A row of B7's parameter table in shared memory.
struct SharedParams {
    const float* base;  // this node's parameter 0
    __device__ __forceinline__ float operator()(int k) const { return base[k]; }
};

// B7's step (csrc/torord_grl_multi.cu's semantics) over every block or the
// block list `blocks` (kBlocks), staged (kStaged) or one node a thread, the
// [nm, NP] table read through the read-only path or from shared memory
// (kSmemTable, copied there once a block; one node a thread only).
template <bool kLand, bool kBlocks, bool kStaged, bool kSmemTable>
__device__ __forceinline__ void b7(float* states, const float* vin, const int* __restrict__ model, int n,
                                   float t, float dt, const float* __restrict__ table, int nm,
                                   const int* __restrict__ blocks, int ntiles) {
    static_assert(!(kStaged && kSmemTable), "the table in shared memory runs unstaged");
    using M = Model<kLand>;
    extern __shared__ __align__(16) float table_s[];
    if constexpr (kSmemTable) {
        for (int k = threadIdx.x; k < nm * M::kNP; k += fbt::kThreads) table_s[k] = __ldg(table + k);
        __syncthreads();
    }
    fbt::torord_steps<M::kS, fbt::kThreads, true, kStaged>(
        states, vin, model, n, ntiles, [&](int k) { return kBlocks ? __ldg(blocks + k) : k; },
        [&](float* row, long long ld, float v, int, int mi) {
            if (kBlocks && mi == fbt::kOtherModel) return 0;  // another model's node (the mixed form)
            if (mi < 0 || mi >= nm) return 1;  // in no layer: V injected, the other rows stay
            if constexpr (kSmemTable) {
                fbt::torord_grl_node<kLand>(row, ld, v, t, dt, SharedParams{table_s + mi * M::kNP});
            } else {
                fbt::torord_grl_node<kLand>(row, ld, v, t, dt, fbt::StridedParams{table + mi * M::kNP, 1});
            }
            return M::kS;
        });
}

// B7's launch: `every` over every block, `listed` over a block list.
template <bool kLand, bool kStaged, bool kSmemTable, class Kernel>
inline int b7_launch(Kernel every, Kernel listed, float* states, const float* v, const int* model, long long n,
                     float t, float dt, const float* table, int nm, const int* blocks, int nblocks, void* stream) {
    using M = Model<kLand>;
    if (!fbt::multi_args_ok(n, nm, blocks, nblocks)) return cudaErrorInvalidValue;
    static int caps[2] = {0, 0};
    const auto kernel = blocks ? listed : every;
    const long long ntiles = fbt::multi_grid(n, blocks, nblocks);
    auto launch = fbt::torord_launch<M::kS, true>(kernel, kStaged, fbt::kThreads, ntiles, caps[blocks != nullptr]);
    if (kSmemTable) {
        launch.smem = nm * M::kNP * static_cast<int>(sizeof(float));
        if (launch.smem > 48 * 1024) return cudaErrorInvalidValue;
    }
    kernel<<<launch.grid, fbt::kThreads, launch.smem, static_cast<cudaStream_t>(stream)>>>(
        states, v, model, static_cast<int>(n), t, dt, table, nm, blocks, static_cast<int>(ntiles));
    return cudaGetLastError();
}

}  // namespace design

// B7's kernels and entry points of both models in one design: kStaged,
// kSmemTable as in design::b7, and at least MIN_BLOCKS(kLand) blocks an SM.
#define TORORD_DESIGN_B7(kStaged, kSmemTable, MIN_BLOCKS)                                                      \
    namespace {                                                                                                \
    template <bool kBlocks>                                                                                    \
    __global__ void __launch_bounds__(fbt::kThreads, MIN_BLOCKS(false))                                        \
        torord_grl_multi_step_v_kernel(float* states, const float* vin, const int* model, int n, float t,     \
                                       float dt, const float* table, int nm, const int* blocks, int ntiles) { \
        design::b7<false, kBlocks, kStaged, kSmemTable>(states, vin, model, n, t, dt, table, nm, blocks,      \
                                                        ntiles);                                               \
    }                                                                                                          \
    template <bool kBlocks>                                                                                    \
    __global__ void __launch_bounds__(fbt::kThreads, MIN_BLOCKS(true))                                         \
        torord_land_grl_multi_step_v_kernel(float* states, const float* vin, const int* model, int n,         \
                                            float t, float dt, const float* table, int nm, const int* blocks, \
                                            int ntiles) {                                                      \
        design::b7<true, kBlocks, kStaged, kSmemTable>(states, vin, model, n, t, dt, table, nm, blocks,       \
                                                       ntiles);                                                \
    }                                                                                                          \
    }                                                                                                          \
    extern "C" int torord_grl_multi_step_v(float* states, const float* v, const int* model, long long n,      \
                                           float t, float dt, const float* table, int nm, const int* blocks,  \
                                           int nblocks, void* stream) {                                        \
        return design::b7_launch<false, kStaged, kSmemTable>(                                                 \
            &torord_grl_multi_step_v_kernel<false>, &torord_grl_multi_step_v_kernel<true>, states, v, model, \
            n, t, dt, table, nm, blocks, nblocks, stream);                                                     \
    }                                                                                                          \
    extern "C" int torord_land_grl_multi_step_v(float* states, const float* v, const int* model, long long n, \
                                                float t, float dt, const float* table, int nm,                 \
                                                const int* blocks, int nblocks, void* stream) {                \
        return design::b7_launch<true, kStaged, kSmemTable>(                                                  \
            &torord_land_grl_multi_step_v_kernel<false>, &torord_land_grl_multi_step_v_kernel<true>, states,  \
            v, model, n, t, dt, table, nm, blocks, nblocks, stream);                                           \
    }
