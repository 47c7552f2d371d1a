// A design of ToR-ORd's and Land's B1, per-node form and B7 that was
// measured on the card and not kept: every form one node a thread, stepped
// in place in the states, at the library's launch shapes.  The library
// stages B1, the per-node form and B7's block-list form (csrc/staged.cuh),
// which measured faster in each (PERF.md).  benchmarks/b1_designs.py builds
// it with the entry points of both models.
#include <cstring>

#include "torord_designs.cuh"

namespace {

// B1 (parameters by value) or the per-node form (a node-aligned [NP, n]
// field), one node a thread.
template <bool kLand, class Src>
__device__ __forceinline__ void b1(float* states, const float* vin, int n, float t, float dt, Src src) {
    using M = design::Model<kLand>;
    fbt::torord_steps<M::kS, TORORD_BLOCK, false, false>(
        states, vin, nullptr, n, 0, [](int k) { return k; },
        [&](float* row, long long ld, float v, int i, int) {
            fbt::torord_grl_node<kLand>(row, ld, v, t, dt, src(i));
            return M::kS;
        });
}

__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_grl_step_v_kernel(float* states, const float* vin, int n, float t, float dt, TorordParams p) {
    b1<false>(states, vin, n, t, dt, [&](int) { return fbt::ParamSet<TorordParams>{p}; });
}
__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_land_grl_step_v_kernel(float* states, const float* vin, int n, float t, float dt, TorordLandParams p) {
    b1<true>(states, vin, n, t, dt, [&](int) { return fbt::ParamSet<TorordLandParams>{p}; });
}
__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_grl_node_step_v_kernel(float* states, const float* vin, const float* __restrict__ params, int n,
                                  float t, float dt) {
    b1<false>(states, vin, n, t, dt, [&](int i) { return fbt::StridedParams{params + i, n}; });
}
__global__ void __launch_bounds__(TORORD_BLOCK, TORORD_MIN_BLOCKS)
    torord_land_grl_node_step_v_kernel(float* states, const float* vin, const float* __restrict__ params, int n,
                                       float t, float dt) {
    b1<true>(states, vin, n, t, dt, [&](int i) { return fbt::StridedParams{params + i, n}; });
}

template <class Params>
int b1_launch(void (*kernel)(float*, const float*, int, float, float, Params), float* states, const float* v,
              long long n, float t, float dt, const float* params, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    Params p;
    std::memcpy(&p, params, sizeof p);
    kernel<<<fbt::num_blocks(n, TORORD_BLOCK), TORORD_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        states, v, static_cast<int>(n), t, dt, p);
    return cudaGetLastError();
}

int node_launch(void (*kernel)(float*, const float*, const float*, int, float, float), float* states,
                const float* v, const float* params, long long n, float t, float dt, void* stream) {
    if (n < 1 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<fbt::num_blocks(n, TORORD_BLOCK), TORORD_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        states, v, params, static_cast<int>(n), t, dt);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int torord_grl_step_v(float* states, const float* v, long long n, float t, float dt, const float* params,
                      void* stream) {
    return b1_launch(&torord_grl_step_v_kernel, states, v, n, t, dt, params, stream);
}
int torord_land_grl_step_v(float* states, const float* v, long long n, float t, float dt, const float* params,
                           void* stream) {
    return b1_launch(&torord_land_grl_step_v_kernel, states, v, n, t, dt, params, stream);
}
int torord_grl_node_step_v(float* states, const float* v, const float* params, long long n, float t, float dt,
                           void* stream) {
    return node_launch(&torord_grl_node_step_v_kernel, states, v, params, n, t, dt, stream);
}
int torord_land_grl_node_step_v(float* states, const float* v, const float* params, long long n, float t,
                                float dt, void* stream) {
    return node_launch(&torord_land_grl_node_step_v_kernel, states, v, params, n, t, dt, stream);
}

}  // extern "C"

#define MULTI_MIN_BLOCKS(land) design::Model<land>::kMultiMinBlocks
TORORD_DESIGN_B7(false, false, MULTI_MIN_BLOCKS)
