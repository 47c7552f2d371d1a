// B2: symmetric fixed-offset stencil SpMV, y = A x, with an optional fused
// <x, A x>; and B2·B4, the same pass with the PCG's search-direction
// update folded in:
//   p' = z + (rz_cur / rz_prev) p_old   (p' = z when rz_prev is null),
//   Ap', pAp = <p', Ap'>, alpha = rz_cur / pAp.
//
// Replaces fenicsx_beat_tpu/ops/pallas_spmv.py:build_pallas_stencil_spmv_sym
// (both its pallas_calls: the plain SpMV and spmv_dot) and, in B2·B4, the
// PCG body's fenicsx_beat_tpu/ops/pallas_cg.py:build_pallas_axpy followed
// by spmv_dot and rz / pAp (fenicsx_beat_tpu/fused.py:545-551).
//
// For a symmetric operator the value column of offset -d is the column of
// +d shifted by d rows (A[r, r-d] = A[r-d, r]), so only the Kp columns with
// d >= 0 are streamed:
//   y[r] = sum_k v_k[r] x[r+d_k] + sum_{d_k>0} v_k[r-d_k] x[r-d_k]
// with every index outside [0, n) contributing 0 (the JAX kernel gets the
// same from guard zeros around x).
//
// Its floor on the H100 is device memory.  At the Niederer dx=0.1 slab
// (n = 442,401, Kp = 8, f32, offsets 0 1 31 32 2201 2202 2232 2233) B2
// streams 8 value columns, reads x and writes y: 10 x 4 B a row, 17.7 MB,
// 5.3 us at the H100 SXM data sheet's 3.35 TB/s, against about 1 flop per
// 4 bytes.  B2·B4 reads z and p_old for x and also writes p': 12 x 4 B a
// row, 21.2 MB, 6.3 us.
//
// The design: one row a thread, kBlock = 512 rows a block (of 128, 256,
// 512 and 1024 measured, benchmarks/b2_designs.py), so the card holds as
// many rows in flight as it can: the pass is bound by the latency of its
// loads, which L1 and L2 serve (the table, 14 MB, and the vectors stay in
// the 50 MB L2 across a PCG's iterations; a row's 15 neighbours were read
// by its own or a nearby block).  B2·B4 forms each neighbour's p' from z
// and p_old where it reads it, in the twin's arithmetic (no contraction),
// and writes p' only for its own row, so p' must not alias z or p_old.
// The dot: per-block f64 partials summed in a fixed order by the last
// block to finish (last_block_sum.cuh), which also writes pAp and alpha:
// one launch, no second pass.  Designs that stage x in shared memory (a
// window of the block's rows and their +-2236-row halo, loaded with
// cp.async beside 128-bit value loads; or a march along x with a rolling
// three-plane window) ran slower on the card (benchmarks/b2_designs.py):
// each phase of a block waits on its loads, and fewer rows are in flight.
// The pass is short of issue slots as much as of bytes, so the address
// arithmetic is 32-bit offsets from per-thread bases, and blocks whose rows
// and neighbours all lie inside [0, n) take a loop without guards.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py, device time per call): B2 with its dot about 9.6 us,
// B2·B4 about 12.6 us.
#include "last_block_sum.cuh"

namespace {

constexpr int kMaxOffsets = 8;
// rows a block; STENCIL_SYM_BLOCK is set only by benchmarks/b2_designs.py,
// which measures the other sizes
#ifndef STENCIL_SYM_BLOCK
#define STENCIL_SYM_BLOCK 512
#endif
constexpr int kBlock = STENCIL_SYM_BLOCK;

enum Mode { kPlain = 0, kDot = 1, kDirDot = 2 };

struct SymOffsets {
    int d[kMaxOffsets];  // the d >= 0 offsets, d[0..kp)
    int kp;
    int dmax;
};

struct SymArgs {
    const float* vals;      // [kp, n] value table
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

template <int kMode>
__global__ void __launch_bounds__(kBlock) stencil_spmv_sym_kernel(const SymArgs a) {
    const int n = a.n;
    const int r = blockIdx.x * kBlock + threadIdx.x;
    const bool fold = kMode == kDirDot && a.rz_prev != nullptr;
    const float beta = fold ? *a.rz_cur / *a.rz_prev : 0.0f;
    double dot = 0.0;
    if (r < n) {
        // this row's entry of the table, x (z) and p_old: 32-bit offsets
        // from per-thread bases keep the address arithmetic short
        const float* __restrict__ vr = a.vals + r;
        const float* __restrict__ xr = a.x + r;
        const float* __restrict__ pr = a.p_old + r;
        // x at row r + o, or in B2·B4 p' = z + beta p_old, in the twin's arithmetic
        auto x_at = [&](int o) {
            const float z = xr[o];
            return fold ? __fadd_rn(z, __fmul_rn(beta, pr[o])) : z;
        };
        float acc = 0.0f;
        // the block's rows and all their neighbours lie in [0, n): no guards
        const int r0 = blockIdx.x * kBlock;
        if (r0 >= a.off.dmax && r0 + kBlock + a.off.dmax <= n) {
#pragma unroll
            for (int k = 0; k < kMaxOffsets; ++k) {
                if (k < a.off.kp) {
                    const int d = a.off.d[k];
                    const float* __restrict__ col = vr + k * n;
                    acc += col[0] * x_at(d);  // super-diagonal (and d = 0)
                    if (d > 0) acc += col[-d] * x_at(-d);  // sub-diagonal
                }
            }
        } else {
#pragma unroll
            for (int k = 0; k < kMaxOffsets; ++k) {
                if (k < a.off.kp) {
                    const int d = a.off.d[k];
                    const float* __restrict__ col = vr + k * n;
                    if (r + d < n) acc += col[0] * x_at(d);
                    if (d > 0 && r - d >= 0) acc += col[-d] * x_at(-d);
                }
            }
        }
        a.y[r] = acc;
        const float x0 = x_at(0);
        if (kMode == kDirDot) a.p_out[r] = x0;
        dot = static_cast<double>(x0) * static_cast<double>(acc);
    }
    if (kMode == kPlain) return;
    double total;
    dot = fbt::block_sum<kBlock>(dot);
    if (fbt::last_block_sum<kBlock>(dot, a.partials, a.counter, total)) {
        const float pap = static_cast<float>(total);
        *a.dot_out = pap;
        if (kMode == kDirDot) *a.alpha_out = *a.rz_cur / pap;
    }
}

template <int kMode>
cudaError_t launch(const SymArgs& a, cudaStream_t s) {
    stencil_spmv_sym_kernel<kMode><<<(a.n + kBlock - 1) / kBlock, kBlock, 0, s>>>(a);
    return cudaGetLastError();
}

// n rows, and every offset into the table (k n + r) in 32 bits
bool set_operator(SymArgs& a, const float* vals, long long n, const int* offsets, int kp) {
    if (kp < 1 || kp > kMaxOffsets || n < 1 || n * kp > 0x7fffffffLL - kBlock) return false;
    for (int k = 0; k < kp; ++k) {
        if (offsets[k] < 0 || offsets[k] >= n) return false;
        a.off.d[k] = offsets[k];
        a.off.dmax = offsets[k] > a.off.dmax ? offsets[k] : a.off.dmax;
    }
    a.off.kp = kp;
    a.vals = vals;
    a.n = static_cast<int>(n);
    return true;
}

}  // namespace

extern "C" {

// y = A x for the contiguous [kp, n] value table `vals` of the d >= 0
// offsets `offsets` (a host array).  With `dot_out` non-null also <x, y>
// into dot_out[0], through `partials` (one double a block of 512 rows)
// and `counter` (one unsigned int, 0 on entry and left 0).
// Returns the cudaError_t of the launch.
int stencil_spmv_sym(const float* vals, const float* x, float* y, long long n, const int* offsets,
                     int kp, double* partials, unsigned int* counter, float* dot_out,
                     void* stream) {
    SymArgs a{};
    if (!set_operator(a, vals, n, offsets, kp)) return cudaErrorInvalidValue;
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
int stencil_spmv_sym_dir_dot(const float* vals, const float* z, const float* p_old,
                             const float* rz_cur, const float* rz_prev, float* p_out,
                             float* ap_out, long long n, const int* offsets, int kp,
                             double* partials, unsigned int* counter, float* pap_out,
                             float* alpha_out, void* stream) {
    SymArgs a{};
    if (!set_operator(a, vals, n, offsets, kp)) return cudaErrorInvalidValue;
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
