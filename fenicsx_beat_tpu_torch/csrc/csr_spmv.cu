// B8: general sparse y = A x for unstructured operators, in CSR.
//
// Replaces fenicsx_beat_tpu/ops/pallas_ell.py:build_lane_gather_spmv and the
// COO tail scatter-add of LaneGatherMatrix.__matmul__ (pallas_ell.py:403-412).
// The TPU's paged lane-gather layout exists only because Mosaic has one
// fast gather (a same-shape take_along_axis); the H100 gathers from device
// memory natively, so the operator is plain CSR: row pointers, column
// indices and values, duplicates summed and the union pattern's exact
// zeros dropped at pack time (ops/cuda_ell.py).  Rectangular operators
// (n_rows != n_cols) and empty rows need nothing special.
//
// The TPU kernel caps every row at its page count and sends the overflow to
// a COO tail.  The port's form of that split: rows longer than `long_len`
// entries are listed once per operator at pack time (CSRMatrix.long_rows),
// and one launch gives each of them a warp of its own in its first blocks,
// while the remaining blocks give every other row one thread.  Without the
// split, one thread walked each of the LV apex's few rows of 300 entries
// alone, loading one entry after another, and those threads set the
// kernel's time (3.2x that of the same operator with them emptied, on an
// H100; PERF.md).  A warp loads 32 entries of its row at once, the next
// chunk's loads in flight while it sums one, and passes each chunk by
// shuffles, four entries at a time, to one chain of fused multiply-adds in
// column order: every row, long or short, is summed as
// acc = fma(a_k, x_k, acc) over its entries in order, the arithmetic of one
// thread a row.  A fixed order, no atomics: the result repeats bit for bit
// and is the one-thread-a-row kernel's, so the LV's CG iteration counts do
// not move with the split.  Designs measured and not kept
// (benchmarks/b8_designs.py, PERF.md): a butterfly over the lanes (as
// fast, but it rounds otherwise, and the float32 CG's counts followed its
// rounding), 4 or 8 lanes for every row, and a chunk staged in shared
// memory (it slowed the one-thread rows by a tenth).
//
// What bounds it on the H100: device memory.  At the LV of psize 0.1
// (n = 243,518) one call reads about 3.5 million (value, column) pairs
// (28 MB), the row pointers, x and writes y: about 31 MB, a floor of about
// 9.2 us at the H100 SXM data sheet's 3.35 TB/s, against 2 flop per 8
// bytes.  Values and columns stream coalesced within a row and row after
// row across a warp; x (about 1 MB) is gathered through L1/L2, where it
// stays.
#include "common.cuh"

namespace {

constexpr int kWarps = fbt::kThreads / 32;  // long rows per block
constexpr unsigned kAll = 0xffffffffu;      // every lane of a warp

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
        int k = indptr[r] + lane;
        float a = k < end ? vals[k] : 0.0f;
        float xk = k < end ? __ldg(x + cols[k]) : 0.0f;
        float acc = 0.0f;
        for (int chunk = indptr[r]; chunk < end; chunk += 32) {
            k += 32;  // the next chunk's loads, in flight while this one is summed
            const float a_next = k < end ? vals[k] : 0.0f;
            const float x_next = k < end ? __ldg(x + cols[k]) : 0.0f;
            if (end - chunk >= 32) {
                // four entries' shuffles issued together, then their four
                // multiply-adds: the chain waits on one shuffle's latency
                // every four entries, not on every entry
#pragma unroll
                for (int g = 0; g < 32; g += 4) {
                    const float a0 = __shfl_sync(kAll, a, g), x0 = __shfl_sync(kAll, xk, g);
                    const float a1 = __shfl_sync(kAll, a, g + 1), x1 = __shfl_sync(kAll, xk, g + 1);
                    const float a2 = __shfl_sync(kAll, a, g + 2), x2 = __shfl_sync(kAll, xk, g + 2);
                    const float a3 = __shfl_sync(kAll, a, g + 3), x3 = __shfl_sync(kAll, xk, g + 3);
                    acc = fmaf(a0, x0, acc);
                    acc = fmaf(a1, x1, acc);
                    acc = fmaf(a2, x2, acc);
                    acc = fmaf(a3, x3, acc);
                }
            } else {
                for (int j = 0; j < end - chunk; ++j) {
                    acc = fmaf(__shfl_sync(kAll, a, j), __shfl_sync(kAll, xk, j), acc);
                }
            }
            a = a_next;
            xk = x_next;
        }
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
    for (int k = beg; k < end; ++k) acc = fmaf(vals[k], __ldg(x + cols[k]), acc);
    y[r] = acc;
}

}  // namespace

extern "C" {

// y = A x for the CSR operator (indptr [n_rows + 1], cols and vals [nnz]).
// `long_rows` lists, in any order, exactly the n_long rows that hold more
// than `long_len` entries (null when n_long is 0).  Returns the
// cudaError_t of the launch.
int csr_spmv(const int* indptr, const int* cols, const float* vals, const float* x, float* y,
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
