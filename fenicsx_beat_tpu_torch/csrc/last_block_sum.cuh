// The reduction across the blocks of one launch, done by its last block:
// the dot products of B2 and B2·B4 (stencil_spmv_sym.cu) in one launch,
// with no second pass and no float atomics (common.cuh).
//
// Apart from common.cuh because of <cuda/atomic>: the node bodies that
// include common.cuh are also built by the host's g++ in the tests, which
// has no such header.
#pragma once

#include "common.cuh"

#include <cuda/atomic>

namespace fbt {

// One launch's reduction across blocks, done by its last block: block b
// stores its sum `v` (valid in thread 0, as block_sum leaves it) to
// partials[b] and counts itself on *counter with an integer fetch_add of
// release-acquire order (the slot is visible before the count, as a
// __threadfence() before the add would make it; measured faster than the
// fence and a plain atomicAdd).  The block whose add returns gridDim.x - 1
// adds partials[0 .. gridDim.x) in a fixed order (thread t takes slots t,
// t + kBlock, ... in that order, their loads in flight 8 at a time, then
// block_sum), so the total does not depend on which block finished last,
// and resets *counter to 0 for the next launch.  Every thread of every
// block must call it; returns true in thread 0 of the last block, with the
// total in `total`.
template <int kBlock>
__device__ __forceinline__ bool last_block_sum(double v, double* __restrict__ partials,
                                               unsigned int* __restrict__ counter, double& total) {
    __shared__ bool is_last;
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = v;
        cuda::atomic_ref<unsigned int, cuda::thread_scope_device> count(*counter);
        is_last = count.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
    __syncthreads();
    if (!is_last) return false;
    double acc = 0.0;
    for (unsigned int base = threadIdx.x; base < gridDim.x; base += 8 * kBlock) {
        double part[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const unsigned int b = base + u * kBlock;
            part[u] = b < gridDim.x ? __ldcg(partials + b) : 0.0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += part[u];
    }
    acc = fbt::block_sum<kBlock>(acc);
    if (threadIdx.x != 0) return false;
    *counter = 0u;
    total = acc;
    return true;
}

}  // namespace fbt
