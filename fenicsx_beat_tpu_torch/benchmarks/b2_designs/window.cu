// A design of B2 and B2·B4 (csrc/stencil_spmv_sym.cu) that was measured on
// the card and not kept: x staged in shared memory, a window of the
// block's rows and their halo loaded with cp.async beside 128-bit value
// loads, 4 rows a thread.  benchmarks/b2_designs.py builds it and times it beside the kept kernel;
// PERF.md has the times.  The entry points compute what the kept kernel's
// do, in the same arithmetic (the twins of ops/cuda_spmv.py hold both),
// with the value table's row stride `ld` (a multiple of 4, so that the rows
// are 16-byte aligned) and the rows a block `tile` (1024, 2048 or 4096) as
// arguments.
//
// The design (one launch, whatever the form):
// - a block owns a tile of kTile consecutive rows (kSub sub-tiles of 1024:
//   256 threads, 4 consecutive rows each) and stages the window of x it
//   needs, rows [r0 - dpad, r0 + kTile + dpad + 4) with dpad the largest
//   offset rounded up to 4, in shared memory with cp.async (16-byte copies
//   where x is 16-byte aligned), out-of-range rows as zeros.  B2·B4 stages
//   z and p_old and forms each window element once as z + beta p_old, in
//   the twin's arithmetic (no contraction), then writes p' for its own rows;
//   the halo rows of p' that a neighbouring block owns are formed again,
//   from the same inputs with the same arithmetic, so p' never has to be
//   read back and must not alias z or p_old;
// - while the copies land, each thread loads its 4 rows of the 8 value
//   columns with 128-bit loads (the table's rows are 16-byte aligned: row
//   stride `ld` a multiple of 4); the shifted v_k[r-d] and all 15 reads of
//   x come from two aligned 128-bit reads and a select, in shared memory
//   for x, through L1/L2 for v (the rows r-d were streamed by this block or
//   a nearby one);
// - the dot: per-block f64 partials, summed in a fixed order by the last
//   block to finish (last_block_sum.cuh), which also writes pAp and
//   alpha; no second launch.
#include "last_block_sum.cuh"

#include <cstdint>

namespace {

constexpr int kMaxOffsets = 8;
constexpr int kThreads = fbt::kThreads;
constexpr int kRows = 4;                     // consecutive rows per thread and sub-tile
constexpr int kSubRows = kThreads * kRows;   // 1024
constexpr int kMaxDevices = 64;

enum Mode { kPlain = 0, kDot = 1, kDirDot = 2 };

struct SymOffsets {
    int d[kMaxOffsets];  // the d >= 0 offsets, d[0..kp)
    int kp;
    int dpad;            // the largest offset rounded up to a multiple of 4
};

struct SymArgs {
    const float* vals;      // [kp, ld] value table, rows 16-byte aligned
    long long ld;
    const float* x;         // B2: x; B2·B4: z
    const float* p_old;     // B2·B4, null on the first iteration
    const float* rz_cur;    // B2·B4
    const float* rz_prev;   // B2·B4, null on the first iteration
    float* p_out;           // B2·B4
    float* y;               // A x, or A p'
    int n;
    SymOffsets off;
    double* partials;       // one double per block (dot forms)
    unsigned int* counter;  // 0 on entry, left 0
    float* dot_out;         // <x, A x>, or pAp
    float* alpha_out;       // B2·B4: rz_cur / pAp
};

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

// p[s .. s+3] from the two aligned float4 around it (p 16-byte aligned at
// multiples of 4, p[s - (s & 3) .. + 8) readable).  m = s & 3 is the same
// for every thread of a column, so the select does not diverge.
__device__ __forceinline__ float4 select4(float4 lo, float4 hi, int m) {
    switch (m) {
        case 1: return make_float4(lo.y, lo.z, lo.w, hi.x);
        case 2: return make_float4(lo.z, lo.w, hi.x, hi.y);
        default: return make_float4(lo.w, hi.x, hi.y, hi.z);
    }
}

__device__ __forceinline__ float4 shared4(const float* p, int s) {
    const int m = s & 3;
    const float4* q = reinterpret_cast<const float4*>(p + (s - m));
    const float4 lo = q[0];
    return m == 0 ? lo : select4(lo, q[1], m);
}

__device__ __forceinline__ float4 global4(const float* __restrict__ p, long long s) {
    const int m = static_cast<int>(s & 3);
    const float4* q = reinterpret_cast<const float4*>(p + (s - m));
    const float4 lo = __ldg(q);
    return m == 0 ? lo : select4(lo, __ldg(q + 1), m);
}

__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
    acc.x += a.x * b.x;
    acc.y += a.y * b.y;
    acc.z += a.z * b.z;
    acc.w += a.w * b.w;
}

__device__ __forceinline__ float get(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(float4& v, int j, float a) {
    if (j == 0) v.x = a; else if (j == 1) v.y = a; else if (j == 2) v.z = a; else v.w = a;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Stage src[ws .. ws + w) into win (w a multiple of 4), rows outside
// [0, n) as zeros; the copies are committed by the caller.
__device__ __forceinline__ void stage(float* win, const float* __restrict__ src, int ws, int w, int n) {
    if (aligned16(src)) {
        for (int c = threadIdx.x; c < w / 4; c += kThreads) {
            const int g = ws + 4 * c;  // ws and g are multiples of 4
            if (g >= 0 && g + 4 <= n) {
                cp_async16(win + 4 * c, src + g);
            } else {
                for (int j = 0; j < 4; ++j) {
                    if (g + j >= 0 && g + j < n) cp_async4(win + 4 * c + j, src + g + j);
                    else win[4 * c + j] = 0.0f;
                }
            }
        }
    } else {  // a row view of a larger tensor: 4-byte copies, coalesced
        for (int i = threadIdx.x; i < w; i += kThreads) {
            const int g = ws + i;
            if (g >= 0 && g < n) cp_async4(win + i, src + g);
            else win[i] = 0.0f;
        }
    }
}

// Store rows r..r+3 (those below n) of v.
__device__ __forceinline__ void store4(float* __restrict__ out, int r, int n, float4 v) {
    if (r + 4 <= n && aligned16(out)) {
        *reinterpret_cast<float4*>(out + r) = v;
    } else {
        for (int j = 0; j < 4 && r + j < n; ++j) out[r + j] = get(v, j);
    }
}

// y[r..r+3] from the value columns v (this thread's rows) and the window
// (win[c] holds row r), in the twin's order: per column, the
// super-diagonal term, then the sub-diagonal one.  The window holds zeros
// outside [0, n), so a super-diagonal term whose neighbour lies beyond the
// last row adds v * 0 (the table's entries are finite) and needs no guard;
// rows past n (the last thread's) are computed and never stored.  A
// sub-diagonal term reads v_k[r-d] from global memory only where r-d >= 0:
// the rows below d have none, and the one thread whose 4 rows straddle d
// takes them one by one.
__device__ __forceinline__ float4 rows4(const SymArgs& a, const float4 (&v)[kMaxOffsets],
                                        const float* win, int c, int r) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {
        if (k < a.off.kp) {
            const int d = a.off.d[k];
            fma4(acc, v[k], shared4(win, c + d));
            if (d == 0 || r + 3 < d) continue;
            const float* col = a.vals + k * a.ld;
            const float4 xm = shared4(win, c - d);
            if (r >= ((d + 3) & ~3)) {  // the aligned pair around r - d lies at or above 0
                fma4(acc, global4(col, static_cast<long long>(r) - d), xm);
            } else {
                for (int j = 0; j < 4; ++j) {
                    if (r + j >= d) put(acc, j, get(acc, j) + __ldg(col + r + j - d) * get(xm, j));
                }
            }
        }
    }
    return acc;
}

__device__ __forceinline__ void load_columns(float4 (&v)[kMaxOffsets], const SymArgs& a, int r) {
#pragma unroll
    for (int k = 0; k < kMaxOffsets; ++k) {
        if (k < a.off.kp && r < a.n) {
            v[k] = __ldg(reinterpret_cast<const float4*>(a.vals + k * a.ld + r));
        }
    }
}

template <int kSub, int kMode>
__global__ void __launch_bounds__(kThreads) stencil_spmv_sym_kernel(const SymArgs a) {
    constexpr int kTile = kSub * kSubRows;
    extern __shared__ __align__(16) float smem[];
    const int n = a.n;
    const int w = kTile + 2 * a.off.dpad + 4;
    const int r0 = blockIdx.x * kTile;
    const int ws = r0 - a.off.dpad;  // the window's first row
    float* win = smem;
    const bool fold = kMode == kDirDot && a.rz_prev != nullptr;

    stage(win, a.x, ws, w, n);
    if (fold) stage(smem + w, a.p_old, ws, w, n);
    asm volatile("cp.async.commit_group;\n" ::);

    float4 v[kMaxOffsets];
    load_columns(v, a, r0 + kRows * threadIdx.x);  // in flight with the copies
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    if (fold) {
        const float beta = *a.rz_cur / *a.rz_prev;
        const float* p = smem + w;
        for (int i = threadIdx.x; i < w; i += kThreads) {
            const int g = ws + i;
            if (g >= 0 && g < n) win[i] = __fadd_rn(win[i], __fmul_rn(beta, p[i]));
        }
        __syncthreads();
    }

    double dot = 0.0;
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub) {
        const int r = r0 + sub * kSubRows + kRows * threadIdx.x;
        if (sub > 0) load_columns(v, a, r);
        if (r < n) {
            const int c = r - ws;
            const float4 y = rows4(a, v, win, c, r);
            const float4 x = *reinterpret_cast<const float4*>(win + c);
            if (kMode == kDirDot) store4(a.p_out, r, n, x);
            store4(a.y, r, n, y);
            if (kMode != kPlain) {
                for (int j = 0; j < 4 && r + j < n; ++j) {
                    dot += static_cast<double>(get(x, j)) * static_cast<double>(get(y, j));
                }
            }
        }
    }
    if (kMode == kPlain) return;
    double total;
    dot = fbt::block_sum<kThreads>(dot);
    if (fbt::last_block_sum<kThreads>(dot, a.partials, a.counter, total)) {
        const float pap = static_cast<float>(total);
        *a.dot_out = pap;
        if (kMode == kDirDot) *a.alpha_out = *a.rz_cur / pap;
    }
}

int grid_blocks(long long n, int tile) { return static_cast<int>((n + tile - 1) / tile); }

// The kernel's dynamic shared memory: one window, two for B2·B4.
size_t window_bytes(int tile, int dpad, int mode) {
    return static_cast<size_t>(tile + 2 * dpad + 4) * sizeof(float) * (mode == kDirDot ? 2 : 1);
}

template <int kSub, int kMode>
cudaError_t launch(const SymArgs& a, cudaStream_t s) {
    const size_t bytes = window_bytes(kSub * kSubRows, a.off.dpad, kMode);
    if (bytes > 48 * 1024) {  // above the default: opt in, once per device
        static size_t allowed[kMaxDevices] = {};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
        if (allowed[dev] < bytes) {
            err = cudaFuncSetAttribute(stencil_spmv_sym_kernel<kSub, kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
            if (err != cudaSuccess) return err;
            allowed[dev] = bytes;
        }
    }
    stencil_spmv_sym_kernel<kSub, kMode>
        <<<grid_blocks(a.n, kSub * kSubRows), kThreads, bytes, s>>>(a);
    return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch(int tile, const SymArgs& a, cudaStream_t s) {
    switch (tile) {
        case kSubRows: return launch<1, kMode>(a, s);
        case 2 * kSubRows: return launch<2, kMode>(a, s);
        case 4 * kSubRows: return launch<4, kMode>(a, s);
        default: return cudaErrorInvalidValue;
    }
}

// The host checks every entry point shares; fills a.n and a.off.
bool set_operator(SymArgs& a, const float* vals, long long ld, long long n, const int* offsets,
                  int kp) {
    if (kp < 1 || kp > kMaxOffsets || n < 1 || n > 0x7fffffffLL - 4 * kSubRows || ld < n ||
        ld % 4 != 0 || (reinterpret_cast<std::uintptr_t>(vals) & 15u) != 0) {
        return false;
    }
    a.vals = vals;
    a.ld = ld;
    a.n = static_cast<int>(n);
    int dmax = 0;
    for (int k = 0; k < kp; ++k) {
        if (offsets[k] < 0 || offsets[k] >= n) return false;
        a.off.d[k] = offsets[k];
        dmax = offsets[k] > dmax ? offsets[k] : dmax;
    }
    a.off.kp = kp;
    a.off.dpad = (dmax + 3) / 4 * 4;
    return true;
}

}  // namespace

extern "C" {

// y = A x for the [kp, ld] value table `vals` (rows 16-byte aligned, the
// first n entries of a row used) of the d >= 0 offsets `offsets` (a host
// array).  With `dot_out` non-null also <x, y> into dot_out[0], through
// `partials` (ceil(n / tile) doubles) and `counter` (one unsigned
// int, 0 on entry and left 0).  `tile` rows a block: 1024, 2048 or 4096.
// Returns the cudaError_t of the launch.
int stencil_spmv_sym(const float* vals, long long ld, const float* x, float* y, long long n,
                     const int* offsets, int kp, int tile, double* partials,
                     unsigned int* counter, float* dot_out, void* stream) {
    SymArgs a{};
    if (!set_operator(a, vals, ld, n, offsets, kp)) return cudaErrorInvalidValue;
    a.x = x;
    a.y = y;
    a.partials = partials;
    a.counter = counter;
    a.dot_out = dot_out;
    auto s = static_cast<cudaStream_t>(stream);
    if (dot_out == nullptr) return dispatch<kPlain>(tile, a, s);
    if (partials == nullptr || counter == nullptr) return cudaErrorInvalidValue;
    return dispatch<kDot>(tile, a, s);
}

// B2·B4: p_out = z + (rz_cur / rz_prev) p_old (z when rz_prev is null; then
// p_old is not read), ap_out = A p_out, pap_out = <p_out, ap_out>,
// alpha_out = rz_cur / pap_out; the scalars are device pointers.  p_out
// must not overlap z or p_old.  The rest as stencil_spmv_sym.
int stencil_spmv_sym_dir_dot(const float* vals, long long ld, const float* z, const float* p_old,
                             const float* rz_cur, const float* rz_prev, float* p_out,
                             float* ap_out, long long n, const int* offsets, int kp, int tile,
                             double* partials, unsigned int* counter, float* pap_out,
                             float* alpha_out, void* stream) {
    SymArgs a{};
    if (!set_operator(a, vals, ld, n, offsets, kp)) return cudaErrorInvalidValue;
    if (rz_cur == nullptr || (rz_prev != nullptr && p_old == nullptr) || partials == nullptr ||
        counter == nullptr || pap_out == nullptr || alpha_out == nullptr) {
        return cudaErrorInvalidValue;
    }
    a.x = z;
    a.p_old = rz_prev != nullptr ? p_old : nullptr;
    a.rz_cur = rz_cur;
    a.rz_prev = rz_prev;
    a.p_out = p_out;
    a.y = ap_out;
    a.partials = partials;
    a.counter = counter;
    a.dot_out = pap_out;
    a.alpha_out = alpha_out;
    return dispatch<kDirDot>(tile, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
