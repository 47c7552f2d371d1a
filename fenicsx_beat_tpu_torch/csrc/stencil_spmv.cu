// B5: general fixed-offset stencil SpMV, y = A x, with an optional fused
// <x, A x>.
//
// Replaces fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv
// (both its pallas_calls: the plain SpMV and spmv_dot).
//
// Row r couples to columns r + d_k with weight v_k[r], for K offsets d_k
// (any signs, up to kMaxOffsets, the assembly's max_offsets):
//   y[r] = sum_k v_k[r] x[r + d_k]
// with every column outside [0, n) contributing 0 (the JAX kernel gets the
// same from guard zeros around x).  The TPU kernel pins the whole operand
// in VMEM and realizes each shift as aligned slices, sublane and lane rolls
// and a carry select on its (rows, 128) layout; none of that has a place
// here.
//
// What bounds it on the H100: device memory.  At the dx=0.1 Niederer slab
// (n = 442,401, K = 15, f32) one call streams the [K, n] value table
// (26.5 MB), reads x and writes y (3.5 MB): 30.1 MB counted from the
// shapes, a floor of 8.98 us at the H100 SXM data sheet's 3.35 TB/s,
// against about 1 flop per byte.  The design streams each value column once,
// coalesced (row k of the [K, n] table, neighbouring threads on
// neighbouring rows), and reads x through the read-only path: the K reads
// of a warp at one offset are 32 neighbouring floats, and the x a block
// touches (its rows plus the stencil's reach) stays in L1/L2 for the
// block's other offsets.  One thread per row; the dot product goes through
// the fixed-order two-pass sum of common.cuh (no float atomics).
#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 64;

struct Offsets {
    int d[kMaxOffsets];  // d[0..k)
    int k;
};

__global__ void __launch_bounds__(fbt::kThreads)
stencil_spmv_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                    float* __restrict__ y, int n, Offsets off,
                    double* __restrict__ partials) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    float acc = 0.0f;
    if (r < n) {
        const float* v = vals + r;
#pragma unroll 4
        for (int k = 0; k < off.k; ++k) {
            const long long c = static_cast<long long>(r) + off.d[k];
            if (c >= 0 && c < n) acc += v[static_cast<long long>(k) * n] * __ldg(x + c);
        }
        y[r] = acc;
    }
    if (partials != nullptr) {
        const double xy = r < n ? static_cast<double>(__ldg(x + r)) * static_cast<double>(acc) : 0.0;
        const double s = fbt::block_sum<fbt::kThreads>(xy);
        if (threadIdx.x == 0) partials[blockIdx.x] = s;
    }
}

}  // namespace

extern "C" {

// y = A x for the [k, n] value table `vals` of the offsets `offsets[0..k)`
// (row i of the table holds offset i).  With `dot_out` non-null, also
// <x, y> into dot_out[0], through `partials` (num_blocks(n) doubles of
// scratch).  Returns the cudaError_t of the launch.
int stencil_spmv(const float* vals, const float* x, float* y, long long n,
                 const int* offsets, int k, double* partials, float* dot_out,
                 void* stream) {
    if (k < 1 || k > kMaxOffsets || n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    Offsets off{};
    for (int i = 0; i < k; ++i) off.d[i] = offsets[i];
    off.k = k;
    const int blocks = fbt::num_blocks(n);
    auto s = static_cast<cudaStream_t>(stream);
    const bool dot = dot_out != nullptr;
    stencil_spmv_kernel<<<blocks, fbt::kThreads, 0, s>>>(
        vals, x, y, static_cast<int>(n), off, dot ? partials : nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !dot) return err;
    fbt::finalize_sums<<<1, fbt::kFinalizeThreads, 0, s>>>(partials, blocks, dot_out);
    return cudaGetLastError();
}

}  // extern "C"
