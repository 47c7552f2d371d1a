// B8 design not kept: a sub-warp of G lanes for every row (G = 4 or 8).
//
// The lanes of a group stride their row (lane l sums entries l, l + G, ...),
// so a group's value and column loads fall in one or two sectors, and the
// group's partials meet in a fixed __shfl_xor_sync butterfly: the same
// bits run after run.  It needs no list of long rows: the LV apex's rows of
// about 300 entries take 300 / G steps.  benchmarks/b8_designs.py builds it
// beside csrc/csr_spmv.cu and times both at the psize 0.1 LV's operator.
#include "common.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(fbt::kThreads)
    csr_spmv_subwarp_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                            const float* __restrict__ vals, const float* __restrict__ x,
                            float* __restrict__ y, int n_rows) {
    static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G lanes a row, a power of two");
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int r = static_cast<int>(t / G);
    const int lane = static_cast<int>(t % G);
    float acc = 0.0f;
    if (r < n_rows) {  // every lane of the warp joins the shuffles below
        const int end = indptr[r + 1];
#pragma unroll 4
        for (int k = indptr[r] + lane; k < end; k += G) acc += vals[k] * __ldg(x + cols[k]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < n_rows && lane == 0) y[r] = acc;
}

template <int G>
int launch(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
           long long n_rows, void* stream) {
    if (n_rows < 1 || n_rows > 0x7fffffffLL / G) return cudaErrorInvalidValue;
    csr_spmv_subwarp_kernel<G><<<fbt::num_blocks(n_rows * G), fbt::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(indptr, cols, vals, x, y,
                                                                      static_cast<int>(n_rows));
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = A x with G lanes a row; returns the cudaError_t of the launch.
int csr_spmv_subwarp4(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
                      long long n_rows, void* stream) {
    return launch<4>(indptr, cols, vals, x, y, n_rows, stream);
}

int csr_spmv_subwarp8(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
                      long long n_rows, void* stream) {
    return launch<8>(indptr, cols, vals, x, y, n_rows, stream);
}

}  // extern "C"
