// B2: symmetric fixed-offset stencil SpMV, y = A x, with an optional fused
// <x, A x> (the PCG's pAp).
//
// Replaces fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv_sym
// (both its pallas_calls: the plain SpMV and spmv_dot).
//
// For a symmetric operator the value column of offset -d is the column of
// +d shifted by d rows (A[r, r-d] = A[r-d, r]), so only the Kp columns with
// d >= 0 are streamed:
//   y[r] = sum_k v_k[r] x[r+d_k] + sum_{d_k>0} v_k[r-d_k] x[r-d_k]
// with every index outside [0, n) contributing 0 (the JAX kernel gets the
// same from guard zeros around x).
//
// What bounds it on the H100: device memory.  At the Niederer dx=0.1 slab
// (n = 442,401, Kp = 8, f32) one call streams 8 value columns (14 MB),
// reads x and writes y (3.5 MB): about 18 MB counted from the shapes, a
// floor of about 5 us at the H100 SXM data sheet's 3.35 TB/s, against
// about 2 flop per byte.  Measured on an H100 80GB HBM3 at a 700 W power
// limit: 9.8 us of device time per call, plus 1.8 us for the dot's second
// pass, inside the main path (torch.profiler, benchmarks/profile_main.py).
// The design streams each value column
// once, coalesced (row k of the [Kp, n] table, neighbouring threads on
// neighbouring rows), reads v_k[r-d] a second time only through L2 (the
// shifted row a block touches was read by a nearby block), and takes x
// through L2 as well (1.8 MB, resident in the 50 MB L2).  One thread per
// row; the dot product goes through the fixed-order two-pass sum of
// common.cuh.
#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 8;

struct SymOffsets {
    int d[kMaxOffsets];  // the d >= 0 offsets, d[0..kp)
    int kp;
};

__global__ void stencil_spmv_sym_kernel(const float* __restrict__ vals,
                                        const float* __restrict__ x,
                                        float* __restrict__ y, int n, SymOffsets off,
                                        double* __restrict__ partials) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    float acc = 0.0f;
    if (r < n) {
#pragma unroll
        for (int k = 0; k < kMaxOffsets; ++k) {
            if (k < off.kp) {
                const int d = off.d[k];
                const float* v = vals + static_cast<long long>(k) * n;
                if (r + d < n) acc += v[r] * x[r + d];  // super-diagonal (and d = 0)
                if (d > 0 && r - d >= 0) acc += v[r - d] * x[r - d];  // sub-diagonal
            }
        }
        y[r] = acc;
    }
    if (partials != nullptr) {
        const double xy = r < n ? static_cast<double>(x[r]) * static_cast<double>(acc) : 0.0;
        const double s = fbt::block_sum<fbt::kThreads>(xy);
        if (threadIdx.x == 0) partials[blockIdx.x] = s;
    }
}

}  // namespace

extern "C" {

// y = A x for the [kp, n] value table `vals` of the d >= 0 offsets `offsets`.
// With `dot_out` non-null, also <x, y> into dot_out[0], through `partials`
// (num_blocks(n) doubles of scratch).  Returns the cudaError_t of the launch.
int stencil_spmv_sym(const float* vals, const float* x, float* y, long long n,
                     const int* offsets, int kp, double* partials, float* dot_out,
                     void* stream) {
    if (kp < 1 || kp > kMaxOffsets || n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    SymOffsets off{};
    for (int k = 0; k < kp; ++k) off.d[k] = offsets[k];
    off.kp = kp;
    const int blocks = fbt::num_blocks(n);
    auto s = static_cast<cudaStream_t>(stream);
    const bool dot = dot_out != nullptr;
    stencil_spmv_sym_kernel<<<blocks, fbt::kThreads, 0, s>>>(
        vals, x, y, static_cast<int>(n), off, dot ? partials : nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !dot) return err;
    fbt::finalize_sums<<<1, fbt::kFinalizeThreads, 0, s>>>(partials, blocks, dot_out);
    return cudaGetLastError();
}

}  // extern "C"
