// B3 and B4: the vector updates of one Jacobi-PCG iteration.
//
// Replaces fenicsx_beat_tpu/ops/pallas_cg.py:build_pallas_cg_update (B3)
// and fenicsx_beat_tpu/ops/pallas_cg.py:build_pallas_axpy (B4).
//
// B3, cg_update:  x' = x + a p,  r' = r - a Ap,  z' = r' * minv,
//                 with <r', z'> and <r', r'>;  a read from a device pointer.
// B4, axpy:       p' = z + b p;  b read from a device pointer.
//
// What bounds them on the H100: device memory; each does under 1 flop per
// byte.  At n = 442,401 in f32, B3 reads 5 vectors and writes 3 (14 MB
// counted from the shapes, a floor of about 4 us at the H100 SXM data
// sheet's 3.35 TB/s) and B4 reads 2 and writes 1 (5 MB).  Measured on an
// H100 80GB HBM3 at a 700 W power limit (device time per call inside the
// main path, torch.profiler, benchmarks/profile_main.py): B3 4.7 us plus
// 1.8 us for the second pass, B4 2.3 us.  The design
// is one pass over the vectors, one element per thread, coalesced; the two
// dot products ride in the same pass (per-block partials, then the
// fixed-order second pass of common.cuh), so no vector is read twice.
// The scalars stay on the device: a and b are 0-d tensors the kernels read
// by pointer, so the iteration needs no host round trip for them.
#include "common.cuh"

namespace {

__global__ void cg_update_kernel(const float* __restrict__ alpha, const float* __restrict__ x,
                                 const float* __restrict__ r, const float* __restrict__ p,
                                 const float* __restrict__ ap, const float* __restrict__ minv,
                                 float* __restrict__ xo, float* __restrict__ ro,
                                 float* __restrict__ zo, int n,
                                 double* __restrict__ partials) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    double rz = 0.0, rr = 0.0;
    if (i < n) {
        const float a = *alpha;
        xo[i] = x[i] + a * p[i];
        const float rn = r[i] - a * ap[i];
        const float zn = rn * minv[i];
        ro[i] = rn;
        zo[i] = zn;
        rz = static_cast<double>(rn) * zn;
        rr = static_cast<double>(rn) * rn;
    }
    rz = fbt::block_sum<fbt::kThreads>(rz);
    rr = fbt::block_sum<fbt::kThreads>(rr);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = rz;
        partials[gridDim.x + blockIdx.x] = rr;
    }
}

__global__ void axpy_kernel(const float* __restrict__ z, const float* __restrict__ p,
                            const float* __restrict__ beta, float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = z[i] + *beta * p[i];
}

}  // namespace

extern "C" {

// (x', r', z') = (x + a p, r - a Ap, (r - a Ap) * minv); sums[0] = <r', z'>,
// sums[1] = <r', r'>.  `partials` is 2 * num_blocks(n) doubles of scratch.
int cg_update(const float* alpha, const float* x, const float* r, const float* p,
              const float* ap, const float* minv, float* xo, float* ro, float* zo,
              long long n, double* partials, float* sums, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int blocks = fbt::num_blocks(n);
    auto s = static_cast<cudaStream_t>(stream);
    cg_update_kernel<<<blocks, fbt::kThreads, 0, s>>>(alpha, x, r, p, ap, minv, xo, ro, zo,
                                                      static_cast<int>(n), partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fbt::finalize_sums<<<2, fbt::kFinalizeThreads, 0, s>>>(partials, blocks, sums);
    return cudaGetLastError();
}

// out = z + b p.
int axpy(const float* z, const float* p, const float* beta, float* out, long long n,
         void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    axpy_kernel<<<fbt::num_blocks(n), fbt::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        z, p, beta, out, static_cast<int>(n));
    return cudaGetLastError();
}

}  // extern "C"
