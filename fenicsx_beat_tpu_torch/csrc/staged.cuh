// Staged ionic steps: a persistent block walks its tiles of nodes, and while
// it steps one tile from shared memory the next tile's states are already
// on their way there (cp.async, double-buffered), so the step's arithmetic
// overlaps the loads of the states it steps next.
//
// One thread per node of a tile.  A thread copies its own node's state rows
// (and the PDE voltage, into row 0's slot; in B7 also its model index) into
// its own column of a [S, kTile] buffer, runs the node body on that column
// (`row` in shared memory, rows kTile floats apart), then writes the
// column's rows back to the states.  No thread reads another's column, so
// the block never synchronizes: each thread waits for its own copies only
// (cp.async.wait_group).  The body's arithmetic is what it is on the states
// in place, so the results are the unstaged kernel's bit for bit.
#pragma once

#include "common.cuh"

namespace fbt {

// cp.async and the launch on the card; a host build of staged_steps
// (FBT_HOST_STAGED: tests/test_torch_torord_body.py) brings its own copies
// of the three copy functions.
#ifndef FBT_HOST_STAGED
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most kPending of this thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
#endif

// Bytes of shared memory of staged_steps<kS, kTile, kIndex>: two buffers
// of kS rows of kTile floats, and in B7 kTile model indices each.
constexpr int staged_bytes(int s, int tile, bool index) {
    return 2 * (s * tile + (index ? tile : 0)) * static_cast<int>(sizeof(float));
}

// Steps every node of n: the block's tiles are tile_of(blockIdx.x),
// tile_of(blockIdx.x + gridDim.x), ... while the argument is under ntiles;
// each node by `step(row, ld, v, i, mi)` (row, ld: the node's staged column;
// v its injected voltage; i the node; mi its model index in B7, kIndex,
// else 0), which returns how many of its rows, from row 0, go back to the
// states: kS when it stepped the node, 1 for V injected alone, 0 to leave
// the node as it was.
template <int kS, int kTile, bool kIndex, class TileOf, class Step>
__device__ __forceinline__ void staged_steps(float* states, const float* vin, const int* model, int n,
                                             int ntiles, TileOf tile_of, Step step) {
    extern __shared__ __align__(16) float stage[];
    constexpr int kBuf = kS * kTile + (kIndex ? kTile : 0);
    const int tid = static_cast<int>(threadIdx.x);
    auto fetch = [&](int k, float* buf) {
        if (k < ntiles) {
            const int i = tile_of(k) * kTile + tid;
            if (i < n) {
                cp_async4(buf + tid, vin + i);  // row 0: the injected voltage
#pragma unroll
                for (int r = 1; r < kS; ++r)
                    cp_async4(buf + r * kTile + tid, states + static_cast<long long>(r) * n + i);
                if constexpr (kIndex) cp_async4(buf + kS * kTile + tid, model + i);
            }
        }
        cp_async_commit();
    };
    int k = static_cast<int>(blockIdx.x);
    fetch(k, stage);
    for (int b = 0; k < ntiles; k += static_cast<int>(gridDim.x), b ^= 1) {
        float* cur = stage + b * kBuf;
        fetch(k + static_cast<int>(gridDim.x), stage + (b ^ 1) * kBuf);
        cp_async_wait<1>();  // this thread's copies into `cur` have landed
        const int i = tile_of(k) * kTile + tid;
        if (i >= n) continue;
        float* row = cur + tid;
        const int mi = kIndex ? reinterpret_cast<const int*>(cur + kS * kTile)[tid] : 0;
        const int rows = step(row, static_cast<long long>(kTile), row[0], i, mi);
#pragma unroll
        for (int r = 0; r < kS; ++r)
            if (r < rows) states[static_cast<long long>(r) * n + i] = row[r * kTile];
    }
    cp_async_wait<0>();  // no copy outlives the block
}

// The grid of a staged kernel: as many blocks of `block` threads and `smem`
// bytes as the card holds at once, at most ntiles; `cap` caches that count
// (and the shared-memory opt-in) for the kernel after its first launch.
#ifndef FBT_HOST_STAGED
template <class Kernel>
inline int staged_grid(Kernel kernel, int block, int smem, long long ntiles, int& cap) {
    if (cap == 0) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
        cap = sms * per_sm;
    }
    return static_cast<int>(cap < ntiles ? cap : ntiles);
}
#endif

}  // namespace fbt
