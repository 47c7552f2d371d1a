// B8 design not kept: the split of csrc/csr_spmv.cu (a warp for each listed
// long row, a thread for each other row, one launch) with the warp's lanes
// striding the row (lane l sums entries l, l + 32, ...) and their partials
// meeting in a fixed __shfl_xor_sync butterfly.  As fast as the kept
// kernel on the psize 0.1 LV's operator, but it rounds the long rows
// otherwise than one thread a row did, and the float32 CG's iteration
// counts on the LV paths moved with it (PERF.md).
// benchmarks/b8_designs.py builds it beside the kept kernel; its entry
// point is csr_spmv_tree, with csr_spmv's arguments.
#include "common.cuh"

namespace {

constexpr int kWarps = fbt::kThreads / 32;  // long rows per block

__global__ void __launch_bounds__(fbt::kThreads)
    csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                    const float* __restrict__ vals, const float* __restrict__ x,
                    float* __restrict__ y, int n_rows, const int* __restrict__ long_rows,
                    int n_long, int long_len, int long_blocks) {
    if (static_cast<int>(blockIdx.x) < long_blocks) {  // a warp a long row
        const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
        if (w >= n_long) return;  // the whole warp
        const int lane = threadIdx.x & 31;
        const int r = long_rows[w];
        const int end = indptr[r + 1];
        float acc = 0.0f;
#pragma unroll 4
        for (int k = indptr[r] + lane; k < end; k += 32) acc += vals[k] * __ldg(x + cols[k]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) y[r] = acc;
        return;
    }
    const int r = (blockIdx.x - long_blocks) * blockDim.x + threadIdx.x;  // a thread a row
    if (r >= n_rows) return;
    const int beg = indptr[r];
    const int end = indptr[r + 1];
    if (end - beg > long_len) return;  // a listed row: its warp writes it
    float acc = 0.0f;
#pragma unroll 4
    for (int k = beg; k < end; ++k) acc += vals[k] * __ldg(x + cols[k]);
    y[r] = acc;
}

}  // namespace

extern "C" {

// csr_spmv's contract (csrc/csr_spmv.cu).
int csr_spmv_tree(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
                  long long n_rows, const int* long_rows, int n_long, int long_len, void* stream) {
    if (n_rows < 1 || n_rows > 0x7fffffffLL || n_long < 0 || long_len < 0 ||
        (n_long > 0 && long_rows == nullptr)) {
        return cudaErrorInvalidValue;
    }
    const int long_blocks = (n_long + kWarps - 1) / kWarps;
    csr_spmv_kernel<<<long_blocks + fbt::num_blocks(n_rows), fbt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        indptr, cols, vals, x, y, static_cast<int>(n_rows), long_rows, n_long, long_len, long_blocks);
    return cudaGetLastError();
}

}  // extern "C"
