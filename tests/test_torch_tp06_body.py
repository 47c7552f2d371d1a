"""TP06's CUDA node body (``csrc/tp06.cuh``, the one copy B1, B1's per-node
form and B7 run), compiled by the host's g++ without contraction (as the
card builds it with -fmad=false), against the port's float32 twin.  The
host divides exactly where the card divides approximately
(-prec-div=false): this holds the body's formulas, the card's build is
held by ``chip_smoke.py``.

- One step from the one-step check's state sets (physiological, and each
  slow row scaled), for epi, mid and endo, at a time inside the pacing
  stimulus (10.5 ms: stimulus on) and one outside it: every state row
  within ``kernel_check.IONIC_STEP_TOL`` of its increment.
- The body with its parameters by value (B1's launch) and from a uniform
  node-aligned field (the per-node form) gives the same bits.
"""

import numpy as np
import pytest
import torch

from torch_host_body import build_host_body, run_host_step

from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
from fenicsx_beat_tpu_torch.ops import cuda_ode

N = 2048
DT = 0.05


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the body over n nodes: parameters from a node-aligned [54, n] field (the
# per-node form's source), or one set by value (B1's)
_HARNESS = r"""
#include "tp06.cuh"
extern "C" void step_field(float* states, const float* v, const float* params, long long n, float t, float dt) {
    for (long long i = 0; i < n; ++i)
        fbt::tp06_grl_node(states + i, n, v[i], t, dt, fbt::StridedParams{params + i, n});
}
extern "C" void step_set(float* states, const float* v, const float* params, long long n, float t, float dt) {
    Tp06Params p;
    float* dst = reinterpret_cast<float*>(&p);
    for (int k = 0; k < kTp06NumParams; ++k) dst[k] = params[k];
    for (long long i = 0; i < n; ++i) fbt::tp06_grl_node(states + i, n, v[i], t, dt, fbt::ParamSet<Tp06Params>{p});
}
"""


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """The TP06 node body built by the host's g++ into a ctypes library."""
    return build_host_body(tmp_path_factory, "tp06_body", _HARNESS)


def _run(fn, states: np.ndarray, v: np.ndarray, params: np.ndarray, t: float) -> np.ndarray:
    return run_host_step(fn, states, v, params, t, DT)


@pytest.mark.parametrize("t", [10.5, 5.0], ids=["stimulus", "no-stimulus"])
@pytest.mark.parametrize("celltype", kernel_check.CELLTYPES, ids=["endo", "epi", "mid"])
def test_cuda_body_matches_float32_twin_on_host(host_body, celltype, t):
    rng = np.random.default_rng(int(10 * t) + int(celltype))
    S0 = torch.tensor(kernel_check.check_states("tp06", N, rng), dtype=torch.float32)
    v = torch.tensor(rng.uniform(-90.0, 40.0, N), dtype=torch.float32)
    field = np.tile(tp06.init_parameter_values(celltype=celltype)[:, None], (1, N))
    assert field[tp06.parameter_index("stim_amplitude"), 0] != 0.0  # the pacing stimulus is on

    def body(S, v_, t_, dt, p):
        S.copy_(torch.from_numpy(_run(host_body.step_field, S.numpy(), v_.numpy(), field, t_)))
        return S

    def twin(S, v_, t_, dt, p):
        return cuda_ode.tp06_grl_step_v_twin(S, v_, t_, dt, p)

    for label, S in kernel_check.step_check_states(S0):
        _, err = kernel_check.ionic_step_errors(body, twin, S, v, t, DT, torch.tensor(field, dtype=torch.float32))
        assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, (label, err.tolist())


@pytest.mark.parametrize("celltype", kernel_check.CELLTYPES, ids=["endo", "epi", "mid"])
def test_cuda_body_parameter_set_and_uniform_field_give_equal_bits(host_body, celltype):
    rng = np.random.default_rng(40 + int(celltype))
    states = kernel_check.check_states("tp06", N, rng)
    v = rng.uniform(-90.0, 40.0, N)
    params = tp06.init_parameter_values(celltype=celltype)
    by_set = _run(host_body.step_set, states, v, params, 10.5)
    by_field = _run(host_body.step_field, states, v, np.tile(params[:, None], (1, N)), 10.5)
    np.testing.assert_array_equal(by_set, by_field)
    assert np.isfinite(by_set).all() and not np.array_equal(by_set[1:], states[1:].astype(np.float32))
