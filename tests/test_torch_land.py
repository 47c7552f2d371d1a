"""ToR-ORd dynCl + Land: the port's torch model, its B1 / B1-node / B7
twins, single-cell pacing and the Land LV, against the JAX package in f64
on the CPU (the port on its kernels' twins).

- Model API and initial values: bit-equal.
- ``rhs``, forward Euler, one GRL step and ``active_tension`` on perturbed
  states (Land's mechanics rows across their range, a stretch rate so
  Zetas and Zetaw move), all three celltypes, inside and outside the
  pacing window: rtol 1e-12 (the two frameworks' own exp/log/pow rounding).
- B1 (a vector and a node-aligned field of mixed celltypes) and B7 (Land
  layers, a marker with no model) through their wrappers, against the JAX
  Pallas kernels in interpret mode at n = 1024: rtol 1e-12.
- The CUDA node body (``csrc/torord_land.cuh`` with ``torord.cuh``)
  compiled by the host's g++ without contraction against the float32 twin:
  the one-step limit of ``benchmarks/kernel_check.py`` per state row.
- ``get_steady_state`` against the JAX package's: rtol 1e-10.
- The LV with Land layers at psize 0.3, 50 steps (the stimulated endocardium
  fires): states within atol 1e-8 and activation times equal to the JAX
  ``FusedMonodomainSolver``'s; the probes' active tension.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lv_reference import jax_lv_solver, probe_values

from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import single_cell as jsc
from fenicsx_beat_tpu.models import torord_dyncl_land as jland
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step, build_pallas_ode_step
from fenicsx_beat_tpu_torch import single_cell as tsc
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.benchmarks import lv as tlv
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as tland
from fenicsx_beat_tpu_torch.ops import cuda_ode

RTOL = 1e-12
CSRC = Path(cuda_ode.__file__).resolve().parent.parent / "csrc"
OFF = {"i_Stim_Amplitude": 0.0}
SPEC = cuda_ode.IONIC_MODELS[tland.generalized_rush_larsen]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread: its tensors here are small, and in
    the parallel test run, where every worker's threads compete for the
    cores, a process whose parallel regions wait on all its threads runs
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def perturbed(n=256, seed=0):
    """The one-step check's states (V across the action potential's range,
    Land's mechanics rows across theirs) and a PDE voltage."""
    rng = np.random.default_rng(seed)
    return kernel_check.check_states("torord_dyncl_land", n, rng), rng.uniform(-90.0, 40.0, n)


def celltype_field(n, seed, **overrides):
    """A node-aligned [136, n] field of randomly mixed celltypes."""
    cts = np.random.default_rng(seed).integers(0, 3, n).astype(float)
    return np.stack([jland.init_parameter_values(celltype=ct, **overrides) for ct in cts], axis=1)


def test_init_values_and_indices_equal():
    np.testing.assert_array_equal(tland.init_state_values(), jland.init_state_values())
    np.testing.assert_array_equal(tland.init_parameter_values(), jland.init_parameter_values())
    kw = dict(i_Stim_Amplitude=0.0, celltype=2.0, lmbda=1.1, dLambda=0.01)
    np.testing.assert_array_equal(tland.init_parameter_values(**kw), jland.init_parameter_values(**kw))
    np.testing.assert_array_equal(tland.init_state_values(cai=2e-4), jland.init_state_values(cai=2e-4))
    assert tland._STATE_NAMES == jland._STATE_NAMES and tland._PARAM_NAMES == jland._PARAM_NAMES
    assert len(tland._STATE_NAMES) == 52 and len(tland._PARAM_NAMES) == 136
    assert tland.init_state_values()[tland.state_index("cai")] == 1e-4  # Land's own, not ToR-ORd's
    assert all(tland.parameter_index(n) == jland.parameter_index(n) for n in jland._PARAM_NAMES)
    assert SPEC.name == "torord_dyncl_land" and SPEC.v_index == 0 and SPEC.num_states == 52
    with pytest.raises(KeyError):
        tland.init_state_values(nope=1.0)
    with pytest.raises(KeyError):
        tland.init_parameter_values(nope=1.0)


@pytest.mark.parametrize("t", [0.5, 10.5])  # inside and outside the pacing window (0 to 1 ms)
@pytest.mark.parametrize("celltype", [0.0, 1.0, 2.0])
def test_rhs_euler_grl_tension_match_jax(celltype, t):
    s, _ = perturbed(seed=1)
    p = jland.init_parameter_values(celltype=celltype, lmbda=1.05, dLambda=0.01)
    S = torch.tensor(s)
    for fn, args in (("generalized_rush_larsen", (0.05,)), ("forward_euler", (0.01,)), ("rhs", ())):
        ref = np.asarray(getattr(jland, fn)(s, t, p, *args))
        out = getattr(tland, fn)(S, t, p, *args).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-300, err_msg=fn)
    for a, b in zip(tland.active_tension(S, p), jland.active_tension(s, p)):
        np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b), rtol=RTOL, atol=1e-300)


def test_troponin_clamp_and_rest():
    """CaTrpn at 0 (its unbinding rate's power is +inf, clamped to 100) and
    below 0, and the rest states (XS, XW, Zetas, Zetaw, Cd at 0): finite,
    as JAX's."""
    s = np.tile(jland.init_state_values()[:, None], (1, 3))
    s[jland.state_index("CaTrpn")] = [0.0, -1e-3, 1e-8]
    p = jland.init_parameter_values()
    out = tland.generalized_rush_larsen(torch.tensor(s), 0.5, p, 0.05).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(jland.generalized_rush_larsen(s, 0.5, p, 0.05)), rtol=RTOL,
                               atol=1e-300)


@pytest.mark.parametrize("node_params", [False, True])
def test_b1_twin_matches_pallas_kernel(node_params):
    """B1 and its per-node form, through the wrappers, against the JAX
    ionic kernel in its v_index form, in interpret mode at n = 1024."""
    n = 1024
    s, v = perturbed(n=n, seed=4)
    states = torch.tensor(s)
    if node_params:
        field = celltype_field(n, seed=5, **OFF)
        step = build_pallas_ode_step(jland.generalized_rush_larsen, num_states=52, n_nodes=n, parameters=None,
                                     dtype=jnp.float64, v_index=0, node_params=field.shape[0], interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(field), 2.0, 0.05))
        out = SPEC.node_step(states, torch.tensor(v), 2.0, 0.05, torch.tensor(field))
    else:
        p = jland.init_parameter_values(celltype=1.0, **OFF)
        step = build_pallas_ode_step(jland.generalized_rush_larsen, num_states=52, n_nodes=n, parameters=p,
                                     dtype=jnp.float64, v_index=0, interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), 2.0, 0.05))
        out = SPEC.step(states, torch.tensor(v), 2.0, 0.05, p)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)


def test_b7_twin_matches_pallas_kernel():
    """B7 over Land layers, against the JAX block-skip kernel in interpret
    mode at n = 1024: three celltypes in runs of 50 nodes, one marker value
    (7) with no model, the PDE voltage injected everywhere."""
    n = 1024
    rng = np.random.default_rng(6)
    markers = np.repeat(rng.integers(0, 3, n // 50 + 1), 50)[:n]
    markers[rng.choice(n, size=n // 50, replace=False)] = 7
    celltypes = {0: 2.0, 1: 0.0, 2: 1.0}
    funs = {m: jland.generalized_rush_larsen for m in celltypes}
    init = {m: jland.init_state_values() for m in celltypes}
    params = {m: jland.init_parameter_values(celltype=ct, **OFF) for m, ct in celltypes.items()}
    fj, _, masks, _ = jode.make_multi_ode(markers, funs, init, params, {m: 0 for m in celltypes})
    step = build_pallas_multi_ode_step(fj.multi, masks_np=masks, num_states=52, n_nodes=n, dtype=jnp.float64,
                                       v_index=0, interpret=True)
    s, v = perturbed(n=n, seed=7)
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 2.0, 0.05))
    index = torch.as_tensor(cuda_ode.model_index_from_masks(masks))
    table = torch.tensor(np.stack([params[m] for m in sorted(celltypes)]))
    states = torch.tensor(s)
    cuda_ode.torord_land_grl_multi_step_v(states, torch.tensor(v), index, 2.0, 0.05, table)
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)
    none = index.numpy() < 0
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])


def test_cuda_source_tables_match_model():
    """torord_land.cuh's state enum continues torord.cuh's; its parameter
    struct is ToR-ORd's 108 then Land's 28, in the model's order."""
    src, base = (CSRC / "torord_land.cuh").read_text(), (CSRC / "torord.cuh").read_text()
    enum = src[src.index("enum TorordLandState"):]
    enum = enum[: enum.index("};")]
    states = dict((name, int(i)) for name, i in re.findall(r"\bTL_(\w+)\s*=\s*(\d+)", enum))
    assert list(states) == tland._MECH_STATE_NAMES
    assert [states[nm] for nm in tland._MECH_STATE_NAMES] == [tland.state_index(nm) for nm in states]
    assert re.search(r"TORORD_LAND_NUM_STATES\s*=\s*52", enum)
    struct = src[src.index("struct TorordLandParams"):]
    struct = struct[: struct.index("};")]
    assert re.search(r"^\s*TorordParams torord;", struct, re.M)
    base_struct = base[base.index("struct TorordParams"):]
    base_struct = base_struct[: base_struct.index("};")]
    names = re.findall(r"float\s+(\w+);", base_struct) + re.findall(r"float\s+(\w+);", struct)
    assert names == tland._PARAM_NAMES
    assert re.search(rf"kTorordLandNumParams\s*=\s*{len(tland._PARAM_NAMES)};", src)


# host stand-ins for the CUDA names the ionic headers use, so the host's
# g++ compiles the card's node body as it is
_CUDA_STUB = r"""
#pragma once
#include <cmath>
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
struct fbt_dim3 { unsigned x = 0; };
static fbt_dim3 threadIdx, blockIdx, blockDim;
template <class T> inline T __shfl_down_sync(unsigned, T v, int) { return v; }
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
"""
_HARNESS = r"""
#include "torord_land.cuh"
struct Strided {
    const float* base;
    long long ld;
    float operator()(int k) const { return base[k * ld]; }
};
extern "C" void step(float* states, const float* v, const float* params, long long n, float t, float dt) {
    for (long long i = 0; i < n; ++i) fbt::torord_grl_node<true>(states + i, n, v[i], t, dt, Strided{params + i, n});
}
"""


@pytest.fixture(scope="module")
def host_body(tmp_path_factory):
    """The Land node body built by the host's g++ into a ctypes library:
    the card's float32 arithmetic, without contraction (-ffp-contract=off,
    as the card builds with -fmad=false)."""
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("needs the host's g++")
    d = tmp_path_factory.mktemp("land_body")
    (d / "cuda_runtime.h").write_text(_CUDA_STUB)
    (d / "harness.cpp").write_text(_HARNESS)
    subprocess.run([gpp, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                    "-o", str(d / "body.so"), str(d / "harness.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "body.so"))


@pytest.mark.parametrize("t", [0.5, 10.5])
def test_cuda_body_matches_float32_twin_on_host(host_body, t):
    n = 2048
    s, v = perturbed(n=n, seed=8)
    field = celltype_field(n, seed=9, lmbda=1.05, dLambda=0.01)
    sf, vf, pf = (np.ascontiguousarray(a, dtype=np.float32) for a in (s, v, field))
    out = sf.copy()
    host_body.step(*(a.ctypes.data_as(ctypes.c_void_p) for a in (out, vf, pf)), ctypes.c_longlong(n),
                   ctypes.c_float(t), ctypes.c_float(0.05))

    def twin(S, v_, t_, dt, p):
        return cuda_ode.torord_land_grl_step_v_twin(S, v_, t_, dt, p)

    def body(S, v_, t_, dt, p):
        S.copy_(torch.tensor(out))
        return S

    _, err = kernel_check.ionic_step_errors(body, twin, torch.tensor(sf), torch.tensor(vf), t, 0.05,
                                            torch.tensor(pf))
    assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, err.tolist()


def test_step_check_states_scale_land_slow_rows():
    s, _ = perturbed(n=32, seed=9)
    S = torch.tensor(s, dtype=torch.float32)
    sets = dict(kernel_check.step_check_states(S, "torord_dyncl_land"))
    assert list(sets)[0] == "physiological" and len(sets) == 7
    for name in ("CaTrpn", "TmB", "Cd", "cansr"):
        row = tland.state_index(name)
        torch.testing.assert_close(sets[f"{name} scaled"][row], S[row] * kernel_check.SLOW_ROW_SCALE)
    for name, (lo, hi) in kernel_check.LAND_CHECK_RANGES.items():
        row = s[tland.state_index(name)]
        assert lo <= row.min() and row.max() <= hi and row.std() > 0


def test_get_steady_state_matches_jax(tmp_path):
    """One beat of 50 ms (the stimulus at 0-1 ms fires the cell), endo."""
    kw = dict(init_states=jland.init_state_values(), parameters=jland.init_parameter_values(celltype=0.0),
              nbeats=1, BCL=50, dt=0.05)
    ref = jsc.get_steady_state(fun=jland.generalized_rush_larsen, outdir=tmp_path / "jax", **kw)
    out = tsc.get_steady_state(fun=tland.generalized_rush_larsen, outdir=tmp_path / "port", device="cpu", **kw)
    assert out.shape == ref.shape == (52,)
    assert out[0] > -85.0 and out[tland.state_index("CaTrpn")] > 1e-8  # fired; troponin bound calcium
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-300)


LV_PSIZE, LV_STEPS = 0.3, 50


def test_land_lv_matches_jax():
    """The LV with Land layers at psize 0.3 (9,780 nodes, from
    init_state_values(), unpaced), Strang, 50 steps, on the JAX plain path:
    three endocardial probes fire (1.3, 1.65, 2.05 ms)."""
    probes = np.array(list(tlv.lv_probe_points(LV_PSIZE).values()))
    js, layers = jax_lv_solver(LV_PSIZE, probe_points=probes, model="torord_dyncl_land", use_pallas_ode=False)
    assert js.solve((0.0, LV_STEPS * 0.05), dt=0.05).name == "OK"
    ts = tlv.build_lv_solver(psize=LV_PSIZE, device="cpu", model="torord_dyncl_land", probe_points=probes,
                             layers=np.asarray(layers.x.array))
    assert ts.solve((0.0, LV_STEPS * 0.05), dt=0.05) == Status.OK
    assert ts._ionic.name == "torord_dyncl_land" and ts.states.shape == (52, 9780)
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states)[:, : ts._n], rtol=0, atol=1e-8)
    act = ts.activation_times()
    np.testing.assert_array_equal(act, np.asarray(js.activation_times())[: ts._n])
    tp = (ts.activation_time[ts._probe_dofs] * ts._probe_w).sum(dim=1).numpy()
    assert (tp > 0).sum() >= 3  # the endocardial probes fired
    assert np.abs(tp - probe_values(js)).max() <= 0.05  # within one dt
    tension = tlv.probe_active_tension(ts)
    assert len(tension) == probes.shape[0] and np.isfinite(tension).all()


def test_run_lv_prepaces_land(tmp_path, monkeypatch):
    """run_lv pre-paces Land's layers (2 beats, one node, on B1's twin)
    and reports the probes' active tension."""
    calls = []

    def steady(dt, device, model):
        calls.append(model)
        return {m: tland.init_state_values() for m in tlv.CELLTYPES}

    monkeypatch.setattr(tlv, "lv_steady_states", steady)
    res = tlv.run_lv(psize=0.8, T=0.5, device="cpu", model="torord_dyncl_land")
    assert calls == ["torord_dyncl_land"] and res.model == "torord_dyncl_land" and res.all_finite
    assert set(res.active_tension) == set(tlv.lv_probe_points(0.8))


def _assert_kernel_matches_twin(step, twin, states, v, parameters):
    for _, S in kernel_check.step_check_states(states, "torord_dyncl_land"):
        for dt in (0.025, 0.05):
            _, err = kernel_check.ionic_step_errors(step, twin, S, v, 1.0, dt, parameters)
            assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, err.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["b1", "node", "multi"])
def test_land_kernels_match_twins_on_card(cuda_device, form):
    """Every state row of each Land kernel against its twin, one step at
    n = 100,000 (the check's states and each slow row scaled); the node
    form on a uniform field gives B1's bits."""
    n = 100_000
    s, v = perturbed(n=n, seed=10)
    S = torch.tensor(s, dtype=torch.float32, device=cuda_device)
    V = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    p = jland.init_parameter_values(celltype=1.0, **OFF)
    if form == "b1":
        _assert_kernel_matches_twin(SPEC.step, SPEC.step_twin, S, V, p)
    elif form == "node":
        field = torch.tensor(celltype_field(n, seed=11, **OFF), dtype=torch.float32, device=cuda_device)
        _assert_kernel_matches_twin(SPEC.node_step, SPEC.step_twin, S, V, field)
        uniform = torch.tensor(np.tile(p[:, None], (1, n)), dtype=torch.float32, device=cuda_device)
        a, b = S.clone(), S.clone()
        SPEC.step(a, V, 1.0, 0.05, p)
        SPEC.node_step(b, V, 1.0, 0.05, uniform)
        assert torch.equal(a, b)
    else:
        index = torch.as_tensor(np.random.default_rng(12).integers(-1, 3, n).astype(np.int32), device=cuda_device)
        table = np.stack([jland.init_parameter_values(celltype=c, **OFF) for c in (0.0, 1.0, 2.0)])
        table_k = torch.tensor(table, dtype=torch.float32, device=cuda_device)
        _assert_kernel_matches_twin(lambda S_, v_, t, dt, _p: SPEC.multi_step(S_, v_, index, t, dt, table_k),
                                    lambda S_, v_, t, dt, _p: SPEC.multi_step_twin(S_, v_, index, t, dt, table),
                                    S, V, None)
