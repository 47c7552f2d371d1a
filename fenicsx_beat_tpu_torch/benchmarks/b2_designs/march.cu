// A design of B2 and B2·B4 (csrc/stencil_spmv_sym.cu) that was measured on
// the card and not kept: a block that marches along x with a rolling
// three-plane window.  benchmarks/b2_designs.py builds it and times it
// beside the kept kernel; PERF.md has the times.  The entry points compute
// what the kept kernel's do, in the same arithmetic (the twins of
// ops/cuda_spmv.py hold both), with the value table's row stride `ld` and
// the planes a block marches over, `tile`, as arguments, and
// stencil_spmv_sym_blocks for the length of `partials`.
//
// The design (one launch, whatever the form): the offsets split as
// d = q P + e with P a plane stride (2201 rows, one x-plane, at dx=0.1),
// q 0 or 1 and e at most E (32), so row r = i P + c reads planes i-1, i
// and i+1 only, within E columns of c.  A block owns 256 columns of a
// plane and marches over `tile` planes along x.  It keeps x (or p') of
// planes i-1 .. i+1 and the value columns of planes i-1 and i in shared
// memory slots, and stages the next plane with cp.async while it computes
// the current one, so each element comes from global memory once, with an
// E-column halo.  B2·B4 forms each p' once, as z + beta p_old, when its
// plane lands.  The dot: per-block f64 partials summed in a fixed order by
// the last block to finish (last_block_sum.cuh).
#include "last_block_sum.cuh"

namespace {

constexpr int kMaxOffsets = 8;
constexpr int kCols = fbt::kThreads;  // columns a block, one a thread
constexpr int kXSlots = 4;            // x (or p') planes i-1, i, i+1 and the one in flight
constexpr int kVSlots = 3;            // value planes i-1, i and the one in flight

enum Mode { kPlain = 0, kDot = 1, kDirDot = 2 };

// The operator as planes: every offset d = q P + e with q in {0, 1} and
// 0 <= e <= E < P, so row r = i P + c reads planes i-1, i and i+1 only,
// within E columns of c.
struct Plan {
    int P;            // plane stride (rows)
    int E;            // the largest in-plane offset
    int planes;       // ceil(n / P)
    int per_block;    // planes a block marches over
    int col_blocks;   // ceil(P / kCols)
    int kp;
    int q[kMaxOffsets];
    int e[kMaxOffsets];
};

struct SymArgs {
    const float* vals;      // [kp, ld] value table
    long long ld;
    const float* x;         // B2: x; B2·B4: z
    const float* p_old;     // B2·B4, null on the first iteration
    const float* rz_cur;    // B2·B4
    const float* rz_prev;   // B2·B4, null on the first iteration
    float* p_out;           // B2·B4
    float* y;               // A x, or A p'
    int n;
    Plan plan;
    double* partials;       // one double per block (dot forms)
    unsigned int* counter;  // 0 on entry, left 0
    float* dot_out;         // <x, A x>, or pAp
    float* alpha_out;       // B2·B4: rz_cur / pAp
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Copy src[row0 .. row0 + w) into dst, rows outside [0, n) as zeros; each
// thread takes elements t, t + kCols, ... (the same in every call, so a
// thread may overwrite a slot it alone has read).  Committed by the caller.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long row0, int w, int n) {
    for (int j = threadIdx.x; j < w; j += kCols) {
        const long long g = row0 + j;
        if (g >= 0 && g < n) cp_async4(dst + j, src + g);
        else dst[j] = 0.0f;
    }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ int slot(int i, int slots) { return ((i % slots) + slots) % slots; }

template <int kMode>
__global__ void __launch_bounds__(kCols) stencil_spmv_sym_kernel(const SymArgs a) {
    extern __shared__ float smem[];
    const Plan& pl = a.plan;
    const int n = a.n, E = pl.E, P = pl.P, kp = pl.kp;
    const int wx = kCols + 2 * E;  // an x slot: rows i P + [c0 - E, c0 + kCols + E)
    const int wv = kCols + E;      // a value slot: rows i P + [c0 - E, c0 + kCols)
    float* X = smem;
    float* V = X + kXSlots * wx;
    float* Zs = V + kVSlots * kp * wv;  // B2·B4: z and p_old of the plane in flight
    float* Ps = Zs + wx;
    const int c0 = (blockIdx.x % pl.col_blocks) * kCols;
    const int i0 = (blockIdx.x / pl.col_blocks) * pl.per_block;
    const int i1 = min(i0 + pl.per_block, pl.planes);
    const int t = threadIdx.x;
    const int c = c0 + t;
    const bool fold = kMode == kDirDot && a.rz_prev != nullptr;
    const float beta = fold ? *a.rz_cur / *a.rz_prev : 0.0f;

    auto row0 = [&](int i) { return static_cast<long long>(i) * P + c0 - E; };
    auto stage_values = [&](int i) {
        float* dst = V + slot(i, kVSlots) * kp * wv;
        for (int k = 0; k < kp; ++k) stage(dst + k * wv, a.vals + k * a.ld, row0(i), wv, n);
    };
    auto stage_x = [&](int i) {  // B2: into its slot; B2·B4: z and p_old into the staging pair
        if (kMode != kDirDot) {
            stage(X + slot(i, kXSlots) * wx, a.x, row0(i), wx, n);
        } else {
            stage(Zs, a.x, row0(i), wx, n);
            if (fold) stage(Ps, a.p_old, row0(i), wx, n);
        }
    };
    auto form_p = [&](int i) {  // B2·B4: p' = z + beta p_old for this thread's elements of plane i
        float* dst = X + slot(i, kXSlots) * wx;
        for (int j = t; j < wx; j += kCols) {
            dst[j] = fold ? __fadd_rn(Zs[j], __fmul_rn(beta, Ps[j])) : Zs[j];
        }
    };

    // prologue: values of planes i0-1 and i0, x of planes i0-1 .. i0+1 (in
    // flight for i0+1)
    stage_values(i0 - 1);
    stage_values(i0);
    if (kMode == kDirDot) {
        for (int i = i0 - 1; i <= i0; ++i) {
            stage_x(i);
            commit();
            wait_all();
            form_p(i);  // this thread's own elements: no barrier before restaging
        }
    } else {
        stage_x(i0 - 1);
        stage_x(i0);
    }
    stage_x(i0 + 1);
    commit();

    double dot = 0.0;
    for (int i = i0; i < i1; ++i) {
        wait_all();
        if (kMode == kDirDot) form_p(i + 1);
        __syncthreads();  // planes i-1 .. i+1 and values i-1, i complete; step i-1 done reading
        if (i + 1 < i1) {  // the next step's planes, in flight during this one
            stage_x(i + 2);
            stage_values(i + 1);
            commit();
        }

        const long long r = static_cast<long long>(i) * P + c;
        if (c < P && r < n) {
            const float* xm = X + slot(i - 1, kXSlots) * wx + E + t;  // row r - P
            const float* x0 = X + slot(i, kXSlots) * wx + E + t;      // row r
            const float* xp = X + slot(i + 1, kXSlots) * wx + E + t;  // row r + P
            const float* vm = V + slot(i - 1, kVSlots) * kp * wv + E + t;
            const float* v0 = V + slot(i, kVSlots) * kp * wv + E + t;
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < kMaxOffsets; ++k) {
                if (k < kp) {
                    const int q = pl.q[k], e = pl.e[k];
                    // super-diagonal v_k[r] x[r + d], then sub-diagonal v_k[r - d] x[r - d]
                    acc += v0[k * wv] * (q ? xp : x0)[e];
                    if (q || e) acc += (q ? vm : v0)[k * wv - e] * (q ? xm : x0)[-e];
                }
            }
            a.y[r] = acc;
            if (kMode == kDirDot) a.p_out[r] = x0[0];
            if (kMode != kPlain) dot += static_cast<double>(x0[0]) * static_cast<double>(acc);
        }
    }
    if (kMode == kPlain) return;
    double total;
    dot = fbt::block_sum<kCols>(dot);
    if (fbt::last_block_sum<kCols>(dot, a.partials, a.counter, total)) {
        const float pap = static_cast<float>(total);
        *a.dot_out = pap;
        if (kMode == kDirDot) *a.alpha_out = *a.rz_cur / pap;
    }
}

// The planes of an operator: P is the offset of at least kCols rows (or,
// with none far from the rest, a stride of at least 1024 rows) that leaves
// the smallest in-plane reach E.  False if n or the offsets are out of range.
bool make_plan(Plan& pl, long long n, const int* offsets, int kp, int per_block) {
    if (kp < 1 || kp > kMaxOffsets || n < 1 || n > 0x3fffffffLL || per_block < 1) return false;
    int dmax = 0;
    for (int k = 0; k < kp; ++k) {
        if (offsets[k] < 0 || offsets[k] >= n) return false;
        dmax = offsets[k] > dmax ? offsets[k] : dmax;
    }
    int best_e = -1, best_p = 0;
    for (int cand = 0; cand <= kp; ++cand) {
        const int P = cand < kp ? offsets[cand] : ((dmax + 1 > 1024 ? dmax + 1 : 1024) + kCols - 1) / kCols * kCols;
        if (P < kCols) continue;  // a plane fills at least one block's columns
        int E = 0;
        bool ok = true;
        for (int k = 0; k < kp; ++k) {
            const int e = offsets[k] >= P ? offsets[k] - P : offsets[k];
            ok = ok && e < P;
            E = e > E ? e : E;
        }
        if (ok && (best_e < 0 || E < best_e)) best_e = E, best_p = P;
    }
    pl.P = best_p;
    pl.E = best_e;
    pl.planes = static_cast<int>((n + best_p - 1) / best_p);
    pl.per_block = per_block;
    pl.col_blocks = (best_p + kCols - 1) / kCols;
    pl.kp = kp;
    for (int k = 0; k < kp; ++k) {
        pl.q[k] = offsets[k] >= best_p ? 1 : 0;
        pl.e[k] = offsets[k] - pl.q[k] * best_p;
    }
    return true;
}

int plan_blocks(const Plan& pl) {
    return pl.col_blocks * ((pl.planes + pl.per_block - 1) / pl.per_block);
}

size_t smem_bytes(const Plan& pl, int mode) {
    const size_t wx = kCols + 2 * pl.E, wv = kCols + pl.E;
    return (kXSlots * wx + kVSlots * pl.kp * wv + (mode == kDirDot ? 2 * wx : 0)) * sizeof(float);
}

constexpr int kMaxDevices = 64;

template <int kMode>
cudaError_t launch(const SymArgs& a, cudaStream_t s) {
    const size_t bytes = smem_bytes(a.plan, kMode);
    if (bytes > 48 * 1024) {  // above the default: opt in, once per device
        static size_t allowed[kMaxDevices] = {};
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
        if (allowed[dev] < bytes) {
            err = cudaFuncSetAttribute(stencil_spmv_sym_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
            if (err != cudaSuccess) return err;
            allowed[dev] = bytes;
        }
    }
    stencil_spmv_sym_kernel<kMode><<<plan_blocks(a.plan), kCols, bytes, s>>>(a);
    return cudaGetLastError();
}

bool set_operator(SymArgs& a, const float* vals, long long ld, long long n, const int* offsets,
                  int kp, int per_block) {
    if (!make_plan(a.plan, n, offsets, kp, per_block) || ld < n) return false;
    a.vals = vals;
    a.ld = ld;
    a.n = static_cast<int>(n);
    return true;
}

}  // namespace

extern "C" {

// Blocks of a launch of `tile` planes a block (the length of `partials`),
// or -1 for offsets the kernel does not take.
int stencil_spmv_sym_blocks(long long n, const int* offsets, int kp, int tile) {
    Plan pl{};
    return make_plan(pl, n, offsets, kp, tile) ? plan_blocks(pl) : -1;
}

// y = A x for the [kp, ld] value table `vals` (the first n entries of a
// row used, entries finite) of the d >= 0 offsets `offsets` (a host
// array).  With `dot_out` non-null also <x, y> into dot_out[0], through
// `partials` (stencil_spmv_sym_blocks doubles) and `counter` (one unsigned
// int, 0 on entry and left 0).  `tile`: planes a block marches over.
// Returns the cudaError_t of the launch.
int stencil_spmv_sym(const float* vals, long long ld, const float* x, float* y, long long n,
                     const int* offsets, int kp, int tile, double* partials,
                     unsigned int* counter, float* dot_out, void* stream) {
    SymArgs a{};
    if (!set_operator(a, vals, ld, n, offsets, kp, tile)) return cudaErrorInvalidValue;
    a.x = x;
    a.y = y;
    a.partials = partials;
    a.counter = counter;
    a.dot_out = dot_out;
    auto s = static_cast<cudaStream_t>(stream);
    if (dot_out == nullptr) return launch<kPlain>(a, s);
    if (partials == nullptr || counter == nullptr) return cudaErrorInvalidValue;
    return launch<kDot>(a, s);
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
    if (!set_operator(a, vals, ld, n, offsets, kp, tile)) return cudaErrorInvalidValue;
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
    return launch<kDirDot>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
