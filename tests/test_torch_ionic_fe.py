"""Forward Euler of the three hand-written ionic models (TP06, ToR-ORd dynCl,
ToR-ORd dynCl + Land) on B1, B1's per-node form and B7.

- The twins (each model's ``forward_euler``) against the JAX package's at
  one step, f64, from the one-step check's states (``kernel_check``), with
  the stimulus on and off: rtol 1e-12.
- The node bodies in their forward-Euler form (``csrc/tp06.cuh`` and
  ``csrc/torord.cuh``'s compile-time switch ``kFE``, the one copy of the
  formulas the GRL kernels run), built by the host's g++ without
  contraction, against the float32 twins: every state row within
  ``kernel_check.IONIC_STEP_TOL`` of its increment, for each celltype; the
  body on one parameter set and on a uniform field gives the same bits.
- The three forms' wrappers dispatch a CPU tensor to the twin, and the
  registry maps each model's ``forward_euler`` to its kernels.
- The fused solver with forward Euler against JAX's on the Niederer slab at
  dx=1.0, Strang, 40 steps, f64 (``tests/test_torch_fused.py``'s
  tolerances: states within atol 1e-8, activation times equal), at a dt at
  which JAX's float64 run stays finite (:data:`FE_DT`: TP06's gates make
  forward Euler unstable at 0.005 ms and above on this slab, ToR-ORd's and
  Land's not below 0.005 ms over 2 ms); and a marker layer mixing TP06's
  forward Euler (B7) with ToR-ORd's GRL.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_host_body import build_host_body, run_host_step

from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.models import torord_dyncl as jtor
from fenicsx_beat_tpu.models import torord_dyncl_land as jland
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as tland
from fenicsx_beat_tpu_torch.ops import cuda_ode

MODELS = {"tp06": (jtp, ttp), "torord_dyncl": (jtor, ttor), "torord_dyncl_land": (jland, tland)}
# the forward-Euler dt of the tissue runs (ms): JAX's float64 run is finite
# there (chip_smoke.py's TP06 slab run takes TP06's)
FE_DT = {"tp06": 0.002, "torord_dyncl": 0.005, "torord_dyncl_land": 0.005}
N, DT = 512, 0.05


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stimulus_name(module) -> str:
    return "stim_amplitude" if "stim_amplitude" in module._PARAM_NAMES else "i_Stim_Amplitude"


@pytest.mark.parametrize("t", [0.5, 10.5], ids=["stimulus", "no-stimulus"])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_euler_twin_matches_jax(name, t):
    jm, tm = MODELS[name]
    rng = np.random.default_rng(5)
    S = kernel_check.check_states(name, 64, rng)
    params = tm.init_parameter_values(celltype=2.0)
    ref = np.asarray(jm.forward_euler(jnp.asarray(S), t, jnp.asarray(params), DT))
    out = tm.forward_euler(torch.tensor(S), t, params, DT).numpy()
    assert np.isfinite(ref).all() and not np.array_equal(ref, S)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-300)


_HARNESS = r"""
#include "tp06.cuh"
#include "torord_land.cuh"
template <class Body>
void each(long long n, Body body) {
    for (long long i = 0; i < n; ++i) body(i);
}
extern "C" {
void tp06_field(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) { fbt::tp06_grl_node<true>(s + i, n, v[i], t, dt, fbt::StridedParams{p + i, n}); });
}
void tp06_set(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) { fbt::tp06_grl_node<true>(s + i, n, v[i], t, dt, fbt::StridedParams{p, 1}); });
}
void torord_dyncl_field(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) {
        fbt::torord_grl_node<false, true>(s + i, n, v[i], t, dt, fbt::StridedParams{p + i, n});
    });
}
void torord_dyncl_set(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) { fbt::torord_grl_node<false, true>(s + i, n, v[i], t, dt, fbt::StridedParams{p, 1}); });
}
void torord_dyncl_land_field(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) {
        fbt::torord_grl_node<true, true>(s + i, n, v[i], t, dt, fbt::StridedParams{p + i, n});
    });
}
void torord_dyncl_land_set(float* s, const float* v, const float* p, long long n, float t, float dt) {
    each(n, [&](long long i) { fbt::torord_grl_node<true, true>(s + i, n, v[i], t, dt, fbt::StridedParams{p, 1}); });
}
}
"""


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """The three node bodies in their forward-Euler form, built by g++."""
    return build_host_body(tmp_path_factory, "fe_body", _HARNESS)


@pytest.mark.parametrize("t", [0.5, 10.5], ids=["stimulus", "no-stimulus"])
@pytest.mark.parametrize("celltype", kernel_check.CELLTYPES, ids=["endo", "epi", "mid"])
@pytest.mark.parametrize("name", list(MODELS))
def test_fe_body_matches_float32_twin_on_host(host_body, name, celltype, t):
    _, tm = MODELS[name]
    rng = np.random.default_rng(int(10 * t) + int(celltype))
    S0 = torch.tensor(kernel_check.check_states(name, N, rng), dtype=torch.float32)
    v = torch.tensor(rng.uniform(-90.0, 40.0, N), dtype=torch.float32)
    field = np.tile(tm.init_parameter_values(celltype=celltype)[:, None], (1, N))
    assert field[tm.parameter_index(stimulus_name(tm)), 0] != 0.0  # the pacing stimulus is on
    fn = getattr(host_body, f"{name}_field")
    twin = cuda_ode.ionic_model(tm.forward_euler).step_twin

    def body(S, v_, t_, dt, p):
        S.copy_(torch.from_numpy(run_host_step(fn, S.numpy(), v_.numpy(), field, t_, dt)))
        return S

    for label, S in kernel_check.step_check_states(S0, name):
        _, err = kernel_check.ionic_step_errors(body, twin, S, v, t, DT, torch.tensor(field, dtype=torch.float32))
        assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, (label, err.tolist())


@pytest.mark.parametrize("name", list(MODELS))
def test_fe_body_parameter_set_and_uniform_field_give_equal_bits(host_body, name):
    _, tm = MODELS[name]
    rng = np.random.default_rng(41)
    states = kernel_check.check_states(name, N, rng)
    v = rng.uniform(-90.0, 40.0, N)
    params = tm.init_parameter_values(celltype=1.0)
    by_set = run_host_step(getattr(host_body, f"{name}_set"), states, v, params, 0.5, DT)
    by_field = run_host_step(getattr(host_body, f"{name}_field"), states, v, np.tile(params[:, None], (1, N)),
                             0.5, DT)
    np.testing.assert_array_equal(by_set, by_field)
    assert np.isfinite(by_set).all()


@pytest.mark.parametrize("name", list(MODELS))
def test_fe_wrappers_run_their_twins_on_the_cpu(name):
    """The three forms of each model's forward Euler: registered under its
    ``forward_euler``, their twins on a CPU tensor (no launch counted)."""
    _, tm = MODELS[name]
    spec = cuda_ode.ionic_model(tm.forward_euler)
    assert spec is not cuda_ode.ionic_model(tm.generalized_rush_larsen) and spec.module is tm
    assert all("_fe_" in f.__name__ for f in (spec.step, spec.node_step, spec.multi_step))
    rng = np.random.default_rng(2)
    S = torch.tensor(kernel_check.check_states(name, 40, rng))
    v = torch.tensor(rng.uniform(-90.0, 40.0, 40))
    params = tm.init_parameter_values()
    ref = S.clone()
    ref[0] = v
    ref = tm.forward_euler(ref, 0.5, params, DT)
    launches = [f.launches for f in (spec.step, spec.node_step, spec.multi_step)]
    a, b, c = S.clone(), S.clone(), S.clone()
    spec.step(a, v, 0.5, DT, params)
    spec.node_step(b, v, 0.5, DT, torch.tensor(np.tile(params[:, None], (1, 40))))
    spec.multi_step(c, v, torch.zeros(40, dtype=torch.int32), 0.5, DT, params[None, :])
    for x in (a, b, c):
        torch.testing.assert_close(x, ref, rtol=1e-12, atol=0)
    assert [f.launches for f in (spec.step, spec.node_step, spec.multi_step)] == launches


@pytest.mark.parametrize("name", list(MODELS))
def test_fused_solver_forward_euler_matches_jax(name):
    jm, tm = MODELS[name]
    dt = FE_DT[name]
    js = jnied._build_solver(dx=1.0, theta=0.5, scheme="forward_euler", model=jm, use_pallas_ode=False,
                             operator_cache_key=None)
    ts = tnied._build_solver(dx=1.0, theta=0.5, scheme="forward_euler", model=tm, device="cpu")
    assert ts._ionic is cuda_ode.ionic_model(tm.forward_euler)
    js.solve((0.0, 40 * dt), dt=dt, save_freq=20)
    ts.solve((0.0, 40 * dt), dt=dt, save_freq=20)
    ref = np.asarray(js.states)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(ts.states.numpy(), ref[:, : ts._n], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ts.activation_times(), np.asarray(js.activation_times()))


def test_fused_solver_mixed_forward_euler_markers_match_jax():
    """TP06's forward Euler (B7's twin, its table) below x = 10 mm beside
    ToR-ORd's GRL (B7's mixed form, two launches)."""
    dt = FE_DT["tp06"]
    sides = {}
    for side, (tp, tor) in (("jax", (jtp, jtor)), ("port", (ttp, ttor))):
        if side == "jax":
            base = jnied._build_solver(dx=1.0, theta=0.5, use_pallas_ode=False, operator_cache_key=None)
        else:
            base = tnied._build_solver(dx=1.0, theta=0.5, device="cpu")
        markers = (base.mesh.coords[:, 0] >= 10.0).astype(np.int64)
        sides[side] = dataclasses.replace(
            base, ode_fun={0: tp.forward_euler, 1: tor.generalized_rush_larsen},
            init_states={0: tp.init_state_values(), 1: tor.init_state_values()},
            parameters={0: tp.init_parameter_values(stim_amplitude=0.0),
                        1: tor.init_parameter_values(i_Stim_Amplitude=0.0)},
            v_index={0: 0, 1: 0}, ode_markers=markers,
        )
    ts = sides["port"]
    assert [g.model.name for g in ts._ionic_groups] == ["tp06_fe", "torord_dyncl"]
    for s in sides.values():
        s.solve((0.0, 40 * dt), dt=dt)
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(sides["jax"].states)[:, : ts._n], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ts.activation_times(), np.asarray(sides["jax"].activation_times()))
