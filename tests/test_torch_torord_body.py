"""ToR-ORd dynCl's CUDA node body (``csrc/torord.cuh``'s
``torord_grl_node``, the one copy that B1, B1's per-node form and B7 of
ToR-ORd, and of ToR-ORd dynCl + Land with ``torord_land.cuh``, run),
compiled by the host's g++ without contraction (``tests/torch_host_body.py``)
against the port's float32 twin.

- One step of plain ToR-ORd from the one-step check's state sets
  (physiological, and each slow row scaled), for endo, epi and mid, at a
  time inside the pacing stimulus (0.5 ms) and one outside it: every state
  row within ``kernel_check.IONIC_STEP_TOL`` of its increment.
- ToR-ORd and ToR-ORd dynCl + Land: the body with its parameters by value
  (B1's launch) and from a uniform node-aligned field (the per-node form)
  gives the same bits.
- The staged driver (``csrc/staged.cuh``'s ``staged_steps``, its copies made
  at once on the host) over persistent blocks walking uneven tiles, as B1's
  per-node form, and over a block list with nodes of another model and of
  no layer, as B7's mixed form: the bits of the body stepped in place, the
  other model's nodes untouched, V alone injected where no layer is.
"""

import ctypes

import numpy as np
import pytest
import torch

from torch_host_body import build_host_body, run_host_step

from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as tland
from fenicsx_beat_tpu_torch.ops import cuda_ode

N = 2048
DT = 0.05
MODELS = {"torord_dyncl": ttor, "torord_dyncl_land": tland}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the body over n nodes, for ToR-ORd (land = false) and ToR-ORd dynCl + Land
# (true): parameters from a node-aligned [NP, n] field (the per-node form's
# source), or one set by value (B1's)
_HARNESS = r"""
#include "torord_land.cuh"
template <bool kLand>
void step_field(float* states, const float* v, const float* params, long long n, float t, float dt) {
    for (long long i = 0; i < n; ++i)
        fbt::torord_grl_node<kLand>(states + i, n, v[i], t, dt, fbt::StridedParams{params + i, n});
}
template <bool kLand, class Params, int kNumParams>
void step_set(float* states, const float* v, const float* params, long long n, float t, float dt) {
    Params p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kNumParams; ++k) dst[k] = params[k];
    for (long long i = 0; i < n; ++i)
        fbt::torord_grl_node<kLand>(states + i, n, v[i], t, dt, fbt::ParamSet<Params>{p});
}
#undef __shared__
#define __shared__
#define __align__(x)
#define FBT_HOST_STAGED
#include <cstring>
static fbt_dim3 gridDim;
namespace fbt {
inline void cp_async4(void* smem, const void* gmem) { std::memcpy(smem, gmem, 4); }
inline void cp_async_commit() {}
template <int kPending> inline void cp_async_wait() {}
}  // namespace fbt
#include "staged.cuh"
namespace fbt {
float stage[2 * (TORORD_LAND_NUM_STATES * 256 + 256)];
}
// every thread of `grid` persistent blocks of kTile, one after another: the
// threads of a staged launch share nothing
template <int kTile, class Run>
void each_thread(int grid, Run run) {
    gridDim.x = grid;
    for (int b = 0; b < grid; ++b)
        for (int th = 0; th < kTile; ++th) {
            blockIdx.x = b;
            threadIdx.x = th;
            run();
        }
}
// B1's per-node form, staged over `grid` blocks of 128 nodes' tiles
template <bool kLand, int kS>
void staged_field(float* s, const float* v, const float* p, int n, float t, float dt, int grid) {
    each_thread<128>(grid, [&] {
        fbt::staged_steps<kS, 128, false>(s, v, nullptr, n, (n + 127) / 128, [](int k) { return k; },
                                          [&](float* row, long long ld, float vv, int i, int) {
                                              fbt::torord_grl_node<kLand>(row, ld, vv, t, dt,
                                                                          fbt::StridedParams{p + i, n});
                                              return kS;
                                          });
    });
}
// B7's mixed form, staged over `grid` blocks walking the listed 256-node blocks
template <bool kLand, int kS, int kNumParams>
void staged_multi(float* s, const float* v, const int* model, int n, float t, float dt, const float* table, int nm,
                  const int* blocks, int nblocks, int grid) {
    each_thread<256>(grid, [&] {
        fbt::staged_steps<kS, 256, true>(s, v, model, n, nblocks, [&](int k) { return blocks[k]; },
                                         [&](float* row, long long ld, float vv, int, int mi) {
                                             if (mi == fbt::kOtherModel) return 0;
                                             if (mi < 0 || mi >= nm) return 1;
                                             const fbt::StridedParams prm{table + mi * kNumParams, 1};
                                             fbt::torord_grl_node<kLand>(row, ld, vv, t, dt, prm);
                                             return kS;
                                         });
    });
}
extern "C" {
void torord_staged_field(float* s, const float* v, const float* p, int n, float t, float dt, int grid) {
    staged_field<false, TORORD_NUM_STATES>(s, v, p, n, t, dt, grid);
}
void land_staged_field(float* s, const float* v, const float* p, int n, float t, float dt, int grid) {
    staged_field<true, TORORD_LAND_NUM_STATES>(s, v, p, n, t, dt, grid);
}
void torord_staged_multi(float* s, const float* v, const int* model, int n, float t, float dt, const float* table,
                         int nm, const int* blocks, int nblocks, int grid) {
    staged_multi<false, TORORD_NUM_STATES, kTorordNumParams>(s, v, model, n, t, dt, table, nm, blocks, nblocks, grid);
}
void land_staged_multi(float* s, const float* v, const int* model, int n, float t, float dt, const float* table,
                       int nm, const int* blocks, int nblocks, int grid) {
    staged_multi<true, TORORD_LAND_NUM_STATES, kTorordLandNumParams>(s, v, model, n, t, dt, table, nm, blocks,
                                                                     nblocks, grid);
}
void torord_field(float* s, const float* v, const float* p, long long n, float t, float dt) {
    step_field<false>(s, v, p, n, t, dt);
}
void torord_set(float* s, const float* v, const float* p, long long n, float t, float dt) {
    step_set<false, TorordParams, kTorordNumParams>(s, v, p, n, t, dt);
}
void land_field(float* s, const float* v, const float* p, long long n, float t, float dt) {
    step_field<true>(s, v, p, n, t, dt);
}
void land_set(float* s, const float* v, const float* p, long long n, float t, float dt) {
    step_set<true, TorordLandParams, kTorordLandNumParams>(s, v, p, n, t, dt);
}
}
"""
_PREFIX = {"torord_dyncl": "torord", "torord_dyncl_land": "land"}


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """ToR-ORd's node body (both switches) built by the host's g++."""
    return build_host_body(tmp_path_factory, "torord_body", _HARNESS)


@pytest.mark.parametrize("t", [0.5, 10.5], ids=["stimulus", "no-stimulus"])
@pytest.mark.parametrize("celltype", kernel_check.CELLTYPES, ids=["endo", "epi", "mid"])
def test_cuda_body_matches_float32_twin_on_host(host_body, celltype, t):
    rng = np.random.default_rng(int(10 * t) + int(celltype))
    S0 = torch.tensor(kernel_check.check_states("torord_dyncl", N, rng), dtype=torch.float32)
    v = torch.tensor(rng.uniform(-90.0, 40.0, N), dtype=torch.float32)
    field = np.tile(ttor.init_parameter_values(celltype=celltype)[:, None], (1, N))
    assert field[ttor.parameter_index("i_Stim_Amplitude"), 0] != 0.0  # the pacing stimulus is on

    def body(S, v_, t_, dt, p):
        S.copy_(torch.from_numpy(run_host_step(host_body.torord_field, S.numpy(), v_.numpy(), field, t_, dt)))
        return S

    for label, S in kernel_check.step_check_states(S0, "torord_dyncl"):
        _, err = kernel_check.ionic_step_errors(body, cuda_ode.torord_grl_step_v_twin, S, v, t, DT,
                                                torch.tensor(field, dtype=torch.float32))
        assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, (label, err.tolist())


@pytest.mark.parametrize("model", list(MODELS))
def test_cuda_body_parameter_set_and_uniform_field_give_equal_bits(host_body, model):
    mod = MODELS[model]
    rng = np.random.default_rng(40 + len(model))
    states = kernel_check.check_states(model, N, rng)
    v = rng.uniform(-90.0, 40.0, N)
    for celltype in kernel_check.CELLTYPES:
        params = mod.init_parameter_values(celltype=celltype)
        set_fn, field_fn = (getattr(host_body, f"{_PREFIX[model]}_{form}") for form in ("set", "field"))
        by_set = run_host_step(set_fn, states, v, params, 0.5, DT)
        by_field = run_host_step(field_fn, states, v, np.tile(params[:, None], (1, N)), 0.5, DT)
        np.testing.assert_array_equal(by_set, by_field)
        assert np.isfinite(by_set).all() and not np.array_equal(by_set[1:], states[1:].astype(np.float32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("model", list(MODELS))
def test_staged_driver_gives_the_bits_of_the_body_in_place(host_body, model):
    mod, prefix = MODELS[model], _PREFIX[model]
    rng = np.random.default_rng(50 + len(model))
    n, t, f32 = 1500, 0.5, np.float32
    states = kernel_check.check_states(model, n, rng).astype(f32)
    v = rng.uniform(-90.0, 40.0, n).astype(f32)
    table = np.stack([mod.init_parameter_values(celltype=ct) for ct in kernel_check.CELLTYPES]).astype(f32)
    cts = rng.integers(0, 3, n)
    field = np.ascontiguousarray(table[cts].T)
    in_place = run_host_step(getattr(host_body, f"{prefix}_field"), states, v, field, t, DT)

    # B1's per-node form: 3 persistent blocks over 12 tiles of 128 nodes, the last one short
    out = states.copy()
    getattr(host_body, f"{prefix}_staged_field")(_ptr(out), _ptr(v), _ptr(field), ctypes.c_int(n), ctypes.c_float(t),
                                                 ctypes.c_float(DT), ctypes.c_int(3))
    np.testing.assert_array_equal(out, in_place)

    # B7's mixed form: blocks 1, 2, 4 and 5 of 256 nodes (the last one short),
    # another model's nodes outside them and among them, nodes of no layer
    model_index = cts.astype(np.int32)
    model_index[rng.random(n) < 0.05] = -1
    model_index[:256] = model_index[768:1024] = cuda_ode.OTHER_MODEL
    model_index[rng.random(n) < 0.05] = cuda_ode.OTHER_MODEL
    blocks = np.array([1, 2, 4, 5], dtype=np.int32)
    out = states.copy()
    getattr(host_body, f"{prefix}_staged_multi")(
        _ptr(out), _ptr(v), _ptr(model_index), ctypes.c_int(n), ctypes.c_float(t), ctypes.c_float(DT), _ptr(table),
        ctypes.c_int(len(table)), _ptr(blocks), ctypes.c_int(len(blocks)), ctypes.c_int(3))
    stepped, no_layer, other = model_index >= 0, model_index == -1, model_index == cuda_ode.OTHER_MODEL
    assert stepped.any() and no_layer.any() and other.any()
    np.testing.assert_array_equal(out[:, stepped], in_place[:, stepped])
    np.testing.assert_array_equal(out[0, no_layer], v[no_layer])
    np.testing.assert_array_equal(out[1:, no_layer], states[1:, no_layer])
    np.testing.assert_array_equal(out[:, other], states[:, other])
