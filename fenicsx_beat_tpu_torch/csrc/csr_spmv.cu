// B8: general sparse y = A x for unstructured operators, in CSR.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ell.py:build_lane_gather_spmv and the
// COO tail scatter-add of LaneGatherMatrix.__matmul__ (pallas_ell.py:403-412).
// The TPU's paged lane-gather layout exists only because Mosaic has one
// fast gather (a same-shape take_along_axis); the H100 gathers from device
// memory natively, so the operator is plain CSR: row pointers, column
// indices and values, duplicates summed and the union pattern's exact
// zeros dropped at pack time (ops/cuda_ell.py).  CSR has no page cap, so
// the welded-apex rows that spill to the TPU's COO tail sit in their rows
// here, and rectangular operators (n_rows != n_cols) need nothing special.
//
// One thread per row sums its entries in column order into a float32
// accumulator: a fixed order, no atomics, so the result repeats bit for
// bit.  The few rows of very high degree (the LV apex: a few hundred
// columns at psize 0.1) serialize the warp that holds them; chip_smoke.py
// times the operator with and without those rows to show what that costs.
//
// What bounds it on the H100: device memory.  At the LV of psize 0.1
// (n = 243,518) one call reads about 3.6 million (value, column) pairs
// (29 MB), the row pointers, x and writes y: about 32 MB, a floor of about
// 10 us at the H100 SXM data sheet's 3.35 TB/s, against 2 flop per 8 bytes.
// Values and columns stream coalesced within a row and row after row
// across a warp; x (about 1 MB) is gathered through L1/L2, where it stays.
#include "common.cuh"

namespace {

__global__ void csr_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                                const float* __restrict__ vals, const float* __restrict__ x,
                                float* __restrict__ y, int n_rows) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    const int beg = indptr[r];
    const int end = indptr[r + 1];
    float acc = 0.0f;
#pragma unroll 4
    for (int k = beg; k < end; ++k) acc += vals[k] * __ldg(x + cols[k]);
    y[r] = acc;
}

}  // namespace

extern "C" {

// y = A x for the CSR operator (indptr [n_rows + 1], cols and vals [nnz]).
// Returns the cudaError_t of the launch.
int csr_spmv(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
             long long n_rows, void* stream) {
    if (n_rows < 1 || n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
    csr_spmv_kernel<<<fbt::num_blocks(n_rows), fbt::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(indptr, cols, vals, x, y,
                                                           static_cast<int>(n_rows));
    return cudaGetLastError();
}

}  // extern "C"
