// B6: general fixed-offset stencil SpMV with the operand staged on chip,
// y = A x, with an optional fused <x, A x>.
//
// Replaces fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv_streamed
// (both its pallas_calls: the plain SpMV and spmv_dot).
//
// Same function as B5 (csrc/stencil_spmv.cu): y[r] = sum_k v_k[r] x[r + d_k],
// columns outside [0, n) contributing 0.  The TPU kernel exists for
// operands over its 8 MiB VMEM budget: each grid step DMAs the window of x
// that its rows reach into VMEM and computes every term from there.  Here
// a block of kTile rows does the same in shared memory.  One contiguous
// window would be too wide: the slab's offsets span +-(P + nz + 1) with
// P = nz * ny (+-8,663 nodes at dx=0.05), but they fall into a few
// clusters ({-P-nz-1 .. -P}, {-nz-1 .. nz+1}, {P .. P+nz+1}), each at most
// 2 (nz + 1) wide.  The host groups the sorted offsets into clusters
// (ops/sparse.py:offset_clusters: a new cluster wherever neighbouring
// offsets are more than kTile apart) and the block stages one window per
// cluster, kTile + span floats each: 3 x (1024 + 124) x 4 B = 13.8 KB at
// dx=0.05.  Each window is one plain cooperative, coalesced load of x
// (cp.async/TMA and double buffering are later work); every term then
// reads shared memory, conflict-free (neighbouring threads, neighbouring
// rows).
//
// What bounds it on the H100: device memory, as B5.  At the dx=0.05 slab
// (n = 3,449,001, K = 15, f32): the [K, n] value table (207 MB), x and y
// (27.6 MB), 234.5 MB counted from the shapes, a floor of 70.0 us at the
// H100 SXM data sheet's 3.35 TB/s.  Each block reads sum(kTile + span) of
// x (about 3.4 floats per row at dx=0.05); the windows of neighbouring
// clusters overlap the windows of blocks P / kTile apart, so most of that
// comes from L2.  The values stream once, coalesced, as in B5.  The dot
// product goes through the fixed-order two-pass sum of common.cuh.
#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 64;
constexpr int kTile = 1024;  // rows per block (WINDOW_TILE in ops/cuda_stencil.py)
constexpr int kRowsPerThread = kTile / fbt::kThreads;
// dynamic shared memory a block may take on sm_90 (232,448 B), less room
// for block_sum's static buffer
constexpr int kMaxWindowBytes = 232448 - 1024;

static_assert(kTile % fbt::kThreads == 0, "a tile is whole rows of threads");

struct WindowTable {
    int wofs[kMaxOffsets];   // offset k's term for local row j is win[wofs[k] + j]
    int lo[kMaxOffsets];     // window c holds x[r0 + lo[c] + i], i in [0, width[c])
    int base[kMaxOffsets];   // at win[base[c] + i]
    int width[kMaxOffsets];  // kTile + the cluster's span
    int k;                   // offsets
    int nc;                  // clusters
};

__global__ void __launch_bounds__(fbt::kThreads)
stencil_spmv_window_kernel(const float* __restrict__ vals, const float* __restrict__ x,
                           float* __restrict__ y, int n, WindowTable t,
                           double* __restrict__ partials) {
    extern __shared__ float win[];
    const long long r0 = static_cast<long long>(blockIdx.x) * kTile;
    // stage each cluster's window once (zeros outside [0, n))
    for (int c = 0; c < t.nc; ++c) {
        const long long g0 = r0 + t.lo[c];
        float* w = win + t.base[c];
        for (int i = threadIdx.x; i < t.width[c]; i += fbt::kThreads) {
            const long long g = g0 + i;
            w[i] = (g >= 0 && g < n) ? __ldg(x + g) : 0.0f;
        }
    }
    __syncthreads();
    double xy = 0.0;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
        const int j = threadIdx.x + m * fbt::kThreads;
        const long long r = r0 + j;
        if (r < n) {
            const float* v = vals + r;
            float acc = 0.0f;
#pragma unroll 4
            for (int k = 0; k < t.k; ++k) acc += v[static_cast<long long>(k) * n] * win[t.wofs[k] + j];
            y[r] = acc;
            if (partials != nullptr) xy += static_cast<double>(__ldg(x + r)) * static_cast<double>(acc);
        }
    }
    if (partials != nullptr) {
        const double s = fbt::block_sum<fbt::kThreads>(xy);
        if (threadIdx.x == 0) partials[blockIdx.x] = s;
    }
}

}  // namespace

extern "C" {

// y = A x for the [k, n] value table `vals` of the offsets `offsets[0..k)`,
// grouped into `nc` clusters: offset i lies in cluster cluster_of[i], whose
// offsets run from cluster_lo[c] to cluster_lo[c] + cluster_span[c].  With
// `dot_out` non-null, also <x, y> into dot_out[0], through `partials`
// (ceil(n / 1024) doubles of scratch).  Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for a table that does not hold every
// offset or whose windows exceed a block's shared memory.
int stencil_spmv_window(const float* vals, const float* x, float* y, long long n,
                        const int* offsets, int k, const int* cluster_of,
                        const int* cluster_lo, const int* cluster_span, int nc,
                        double* partials, float* dot_out, void* stream) {
    if (k < 1 || k > kMaxOffsets || nc < 1 || nc > k || n < 1 || n > 0x7fffffffLL) {
        return cudaErrorInvalidValue;
    }
    WindowTable t{};
    long long floats = 0;
    for (int c = 0; c < nc; ++c) {
        if (cluster_span[c] < 0) return cudaErrorInvalidValue;
        t.lo[c] = cluster_lo[c];
        t.base[c] = static_cast<int>(floats);
        t.width[c] = kTile + cluster_span[c];
        floats += t.width[c];
        if (floats * static_cast<long long>(sizeof(float)) > kMaxWindowBytes) return cudaErrorInvalidValue;
    }
    for (int i = 0; i < k; ++i) {
        const int c = cluster_of[i];
        if (c < 0 || c >= nc) return cudaErrorInvalidValue;
        const long long rel = static_cast<long long>(offsets[i]) - cluster_lo[c];
        if (rel < 0 || rel > cluster_span[c]) return cudaErrorInvalidValue;
        t.wofs[i] = t.base[c] + static_cast<int>(rel);
    }
    t.k = k;
    t.nc = nc;
    const int bytes = static_cast<int>(floats * sizeof(float));
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            stencil_spmv_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
    }
    const int blocks = static_cast<int>((n + kTile - 1) / kTile);
    auto s = static_cast<cudaStream_t>(stream);
    const bool dot = dot_out != nullptr;
    stencil_spmv_window_kernel<<<blocks, fbt::kThreads, bytes, s>>>(
        vals, x, y, static_cast<int>(n), t, dot ? partials : nullptr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !dot) return err;
    fbt::finalize_sums<<<1, fbt::kFinalizeThreads, 0, s>>>(partials, blocks, dot_out);
    return cudaGetLastError();
}

}  // extern "C"
