// Shared pieces of the port's kernels: launch shape and the deterministic
// reductions across blocks.
//
// On the TPU the Pallas kernels summed their dot products in SMEM across
// a grid that runs in order on one core.  On the H100 blocks run in
// parallel and in no order, so each block writes its partial sum (f64) to
// its own slot, and the slots are added in a fixed order by one of two
// means: a second one-block kernel (finalize_sums: B3, B5, B6), or, in the
// same launch, the last block to finish (B2 and B2·B4,
// last_block_sum.cuh), which learns that it is last from
// an unsigned int counter (an integer fetch_add of release-acquire order)
// and sets the counter back to 0.
// No float atomics: a kernel and its plain PyTorch twin can then be
// compared run after run without the sum order changing under them.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace fbt {

constexpr int kThreads = 256;          // threads per block of every kernel
constexpr int kFinalizeThreads = 1024;

inline int num_blocks(long long n, int block = kThreads) {
    return static_cast<int>((n + block - 1) / block);
}

// B7's grid.  A launch covers every block of n nodes, or, in the
// mixed-model form, only the blocks listed in `blocks`: B7's mixed form
// launches each model over the blocks that hold its nodes, the JAX
// kernel's active[model, block] table (pallas_ode.py:375-383) turned into
// a compacted grid.  In that form a node whose model index is kOtherModel
// belongs to another model's launch and is left exactly as it is (no V
// injected).  Each B7 kernel is a template on the form (kBlocks), so the
// form over every block keeps its own code and registers.
constexpr int kOtherModel = -2;

inline int multi_grid(long long n, const int* blocks, int nblocks) {
    return blocks ? nblocks : num_blocks(n);
}

// The node of this thread in a B7 launch (see multi_grid); n < 2^31.
template <bool kBlocks>
__device__ __forceinline__ int multi_node(const int* __restrict__ blocks) {
    const int b = kBlocks ? __ldg(blocks + blockIdx.x) : static_cast<int>(blockIdx.x);
    return b * kThreads + static_cast<int>(threadIdx.x);
}

// B7's host checks: n nodes, nm parameter sets, a block list (or none)
inline bool multi_args_ok(long long n, int nm, const int* blocks, int nblocks) {
    return n >= 1 && n <= 0x7fffffffLL && nm >= 1 && (blocks == nullptr || nblocks >= 1);
}

// Where an ionic model's node update reads its parameters, so that each
// model's formulas exist once (tp06.cuh, torord.cuh) and serve every form
// of its step.  Both sources take a parameter's index in the model's
// parameter struct, a constant once the node function is inlined.
//
// One parameter set by value: B1's launch argument, in the constant bank.
template <class Params>
struct ParamSet {
    const Params& p;
    __device__ __forceinline__ float operator()(int k) const {
        return reinterpret_cast<const float*>(&p)[k];
    }
};

// Parameters in device memory, parameter k at base[k * ld], read through
// the read-only path: a row of B7's [nm, NP] table (ld = 1; the nodes of a
// warp almost always share a row, so their reads broadcast), or this
// node's column of B1's node-aligned [NP, n] field (ld = n; neighbouring
// threads on neighbouring addresses, so each parameter row is read
// coalesced).
struct StridedParams {
    const float* __restrict__ base;  // this node's parameter 0
    long long ld;                    // the distance between parameters
    __device__ __forceinline__ float operator()(int k) const { return __ldg(base + k * ld); }
};

// Sum of one value per thread over the block, in a fixed order (warp
// shuffles, then the warp sums in lane order).  Every thread of the block
// must call it; the result is valid in thread 0.
template <int kBlock>
__device__ __forceinline__ double block_sum(double v) {
    static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block must be whole warps");
    __shared__ double warp_sums[kBlock / 32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    double s = 0.0;
    if (warp == 0) {
        s = lane < kBlock / 32 ? warp_sums[lane] : 0.0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    }
    __syncthreads();  // warp_sums may be reused by a second call
    return s;
}

// Second pass: block b adds partials[b * nparts : (b+1) * nparts] in a
// fixed order and writes the float result to out[b].
static __global__ void finalize_sums(const double* __restrict__ partials, int nparts,
                                     float* __restrict__ out) {
    const double* p = partials + static_cast<long long>(blockIdx.x) * nparts;
    double acc = 0.0;
    for (int i = threadIdx.x; i < nparts; i += kFinalizeThreads) acc += p[i];
    acc = block_sum<kFinalizeThreads>(acc);
    if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(acc);
}

}  // namespace fbt
