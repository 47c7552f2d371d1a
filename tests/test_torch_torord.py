"""The ToR-ORd dynCl slice: the port's torch model, its B1 / B1-node / B7
twins, single-cell pacing, the slab demo and the ToR-ORd LV layers, against
the JAX package in f64 on the CPU (the port on its kernels' twins).

- Model API and initial values: bit-equal.
- One GRL step, forward Euler and the right-hand side on perturbed states,
  all three celltypes, inside and outside the pacing window: rtol 1e-12
  (room for the two frameworks' own exp/log rounding only); 200 steps
  through the upstroke at n = 64: rtol 1e-9.
- B1 (TP06 and ToR-ORd, with and without a node-aligned parameter field)
  and B7 (ToR-ORd layers) through their wrappers, against the JAX Pallas
  kernels in interpret mode: rtol 1e-12.
- ``get_steady_state`` against the JAX package's: rtol 1e-10, and its
  cache.

The slab demo and the ToR-ORd LV are in ``test_torch_torord_tissue.py``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import single_cell as jsc
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.models import torord_dyncl as jtor
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step, build_pallas_ode_step
from fenicsx_beat_tpu_torch import single_cell as tsc
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor
from fenicsx_beat_tpu_torch.ops import cuda_ode

RTOL = 1e-12
CU_SOURCE = Path(cuda_ode.__file__).resolve().parent.parent / "csrc" / "torord.cuh"
MODELS = {"tp06": (jtp, ttp, {"stim_amplitude": 0.0}), "torord_dyncl": (jtor, ttor, {"i_Stim_Amplitude": 0.0})}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def perturbed(model=jtor, n=256, seed=0):
    """States around the initial values, V across the action potential's
    range so every branch of the model runs, and a PDE voltage."""
    rng = np.random.default_rng(seed)
    init = model.init_state_values()
    s = np.tile(init[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((init.size, n)))
    s[0] = rng.uniform(-90.0, 40.0, n)
    return s, rng.uniform(-90.0, 40.0, n)


def celltype_field(model, n, seed, **overrides):
    """A node-aligned [NP, n] field of randomly mixed celltypes."""
    cts = np.random.default_rng(seed).integers(0, 3, n).astype(float)
    return np.stack([model.init_parameter_values(celltype=ct, **overrides) for ct in cts], axis=1)


def test_init_values_and_indices_equal():
    np.testing.assert_array_equal(ttor.init_state_values(), jtor.init_state_values())
    np.testing.assert_array_equal(ttor.init_parameter_values(), jtor.init_parameter_values())
    kw = dict(i_Stim_Amplitude=0.0, celltype=2.0, i_Stim_Start=1e18)
    np.testing.assert_array_equal(ttor.init_parameter_values(**kw), jtor.init_parameter_values(**kw))
    np.testing.assert_array_equal(ttor.init_state_values(v=-80.0), jtor.init_state_values(v=-80.0))
    assert ttor._STATE_NAMES == jtor._STATE_NAMES and ttor._PARAM_NAMES == jtor._PARAM_NAMES
    assert all(ttor.state_index(n) == jtor.state_index(n) for n in jtor._STATE_NAMES)
    assert all(ttor.parameter_index(n) == jtor.parameter_index(n) for n in jtor._PARAM_NAMES)
    with pytest.raises(KeyError):
        ttor.init_state_values(nope=1.0)
    with pytest.raises(KeyError):
        ttor.init_parameter_values(nope=1.0)


@pytest.mark.parametrize("t", [0.5, 10.5])  # inside and outside the pacing window (0 to 1 ms)
@pytest.mark.parametrize("celltype", [0.0, 1.0, 2.0])
def test_grl_euler_rhs_match_jax(celltype, t):
    s, _ = perturbed(seed=1)
    p = jtor.init_parameter_values(celltype=celltype)
    S = torch.tensor(s)
    for fn, args in (("generalized_rush_larsen", (0.05,)), ("forward_euler", (0.01,)), ("rhs", ())):
        ref = np.asarray(getattr(jtor, fn)(s, t, p, *args))
        out = getattr(ttor, fn)(S, t, p, *args).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=1e-300, err_msg=fn)


def test_compute_aux_matches_jax():
    """The auxiliary currents a coupled variant (Land) reads."""
    s, _ = perturbed(seed=2, n=64)
    p = jtor.init_parameter_values(celltype=1.0)
    *_, aux_j = jtor._compute(s, 1.0, jtor._unpack_params(p))
    *_, aux_t = ttor._compute(torch.tensor(s), 1.0, ttor.unpack_params(p, torch.tensor(s), ttor._PARAM_NAMES))
    assert set(aux_t) == set(aux_j)
    for k in aux_j:
        np.testing.assert_allclose(np.asarray(aux_t[k], dtype=float), np.asarray(aux_j[k]), rtol=RTOL, err_msg=k)


def test_upstroke_200_steps_match_jax():
    """200 steps of 0.05 ms from the initial state, through the paced
    upstroke (stimulus at 0-1 ms), at n = 64."""
    rng = np.random.default_rng(3)
    init = jtor.init_state_values()
    s0 = np.tile(init[:, None], (1, 64)) * (1 + 0.001 * rng.standard_normal((45, 64)))
    p = jtor.init_parameter_values()
    step = jax.jit(lambda y, t: jtor.generalized_rush_larsen(y, t, p, 0.05))
    y, z = jnp.asarray(s0), torch.tensor(s0)
    for k in range(200):
        y = step(y, 0.05 * k)
        z = ttor.generalized_rush_larsen(z, 0.05 * k, p, 0.05)
    assert float(np.asarray(y)[0].min()) > 0.0  # every cell fired
    np.testing.assert_allclose(z.numpy(), np.asarray(y), rtol=1e-9, atol=1e-300)


@pytest.mark.parametrize("node_params", [False, True])
@pytest.mark.parametrize("model", ["tp06", "torord_dyncl"])
def test_b1_twin_matches_pallas_kernel(model, node_params):
    """B1 and its per-node form, through the wrappers, against the JAX
    ionic kernel in its v_index form, with a vector or a node-aligned
    field of mixed celltypes, in interpret mode at n = 1024."""
    jm, tm, off = MODELS[model]
    n, S = 1024, len(jm._STATE_NAMES)
    s, v = perturbed(jm, n=n, seed=4)
    spec = cuda_ode.IONIC_MODELS[tm.generalized_rush_larsen]
    states = torch.tensor(s)
    if node_params:
        field = celltype_field(jm, n, seed=5, **off)
        step = build_pallas_ode_step(jm.generalized_rush_larsen, num_states=S, n_nodes=n, parameters=None,
                                     dtype=jnp.float64, v_index=0, node_params=field.shape[0], interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(field), 2.0, 0.05))
        out = spec.node_step(states, torch.tensor(v), 2.0, 0.05, torch.tensor(field))
    else:
        p = jm.init_parameter_values(celltype=1.0, **off)
        step = build_pallas_ode_step(jm.generalized_rush_larsen, num_states=S, n_nodes=n, parameters=p,
                                     dtype=jnp.float64, v_index=0, interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), 2.0, 0.05))
        out = spec.step(states, torch.tensor(v), 2.0, 0.05, p)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)


def test_b7_twin_matches_pallas_kernel():
    """B7 over ToR-ORd layers, against the JAX block-skip kernel in
    interpret mode: three celltypes mixed inside 1024-node blocks, one
    marker value (7) with no model, the PDE voltage injected everywhere."""
    n = 2500  # not a multiple of the kernel block: the JAX side pads
    rng = np.random.default_rng(6)
    markers = np.repeat(rng.integers(0, 3, n // 50 + 1), 50)[:n]
    markers[rng.choice(n, size=n // 50, replace=False)] = 7
    celltypes = {0: 2.0, 1: 0.0, 2: 1.0}
    funs = {m: jtor.generalized_rush_larsen for m in celltypes}
    init = {m: jtor.init_state_values() for m in celltypes}
    params = {m: jtor.init_parameter_values(i_Stim_Amplitude=0.0, celltype=ct) for m, ct in celltypes.items()}
    fj, _, masks, _ = jode.make_multi_ode(markers, funs, init, params, {m: 0 for m in celltypes})
    step = build_pallas_multi_ode_step(fj.multi, masks_np=masks, num_states=45, n_nodes=n, dtype=jnp.float64,
                                       v_index=0, interpret=True)
    s, v = perturbed(n=n, seed=7)
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 2.0, 0.05))
    index = torch.as_tensor(cuda_ode.model_index_from_masks(masks))
    table = torch.tensor(np.stack([params[m] for m in sorted(celltypes)]))
    states = torch.tensor(s)
    cuda_ode.torord_grl_multi_step_v(states, torch.tensor(v), index, 2.0, 0.05, table)
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)
    none = index.numpy() < 0
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])


def test_twin_accepts_its_own_voltage_row_and_a_device_time():
    """The solver passes row v itself as v; a captured step passes t as a
    0-d tensor (the beat check's CUDA graph): the same result."""
    s, _ = perturbed(n=64, seed=8)
    p = jtor.init_parameter_values()
    a, b = torch.tensor(s), torch.tensor(s)
    cuda_ode.torord_grl_step_v(a, a[0], 0.5, 0.05, p)
    cuda_ode.torord_grl_step_v_twin(b, b[0], torch.tensor(0.5, dtype=torch.float64), 0.05, p)
    np.testing.assert_allclose(a.numpy(), np.asarray(jtor.generalized_rush_larsen(s, 0.5, p, 0.05)), rtol=RTOL)
    assert torch.equal(a, b)


def test_cuda_source_index_table_matches_model():
    src = CU_SOURCE.read_text()
    enum = src[src.index("enum TorordState"):]
    enum = enum[: enum.index("};")]
    states = dict((name, int(i)) for name, i in re.findall(r"\bTR_(\w+)\s*=\s*(\d+)", enum))
    assert list(states) == jtor._STATE_NAMES
    assert [states[nm] for nm in jtor._STATE_NAMES] == list(range(45))
    assert re.search(r"TORORD_NUM_STATES\s*=\s*45", enum)
    struct = src[src.index("struct TorordParams"):]
    struct = struct[: struct.index("};")]
    assert re.findall(r"float\s+(\w+);", struct) == jtor._PARAM_NAMES
    assert re.search(rf"kTorordNumParams\s*=\s*{len(jtor._PARAM_NAMES)};", src)


def test_step_check_states_scale_torord_slow_rows():
    s, _ = perturbed(n=32, seed=9)
    S = torch.tensor(s, dtype=torch.float32)
    sets = dict(kernel_check.step_check_states(S, "torord_dyncl"))
    assert list(sets) == ["physiological", "cansr scaled", "CaMKt scaled", "fs scaled"]
    for name in kernel_check.SLOW_ROWS["torord_dyncl"]:
        row = ttor.state_index(name)
        torch.testing.assert_close(sets[f"{name} scaled"][row], S[row] * kernel_check.SLOW_ROW_SCALE)


@pytest.mark.parametrize("tracked", [False, True])
def test_get_steady_state_matches_jax(tmp_path, tracked):
    """One beat of 50 ms (the stimulus at 0-1 ms fires the cell), with and
    without tracked states, and the cache: a second call reads the file."""
    kw = dict(init_states=jtor.init_state_values(), parameters=jtor.init_parameter_values(celltype=2.0),
              nbeats=1, BCL=50, dt=0.05, track_indices=[0, 2] if tracked else None)
    ref = jsc.get_steady_state(fun=jtor.generalized_rush_larsen, outdir=tmp_path / "jax", **kw)
    out = tsc.get_steady_state(fun=ttor.generalized_rush_larsen, outdir=tmp_path / "port", device="cpu", **kw)
    np.testing.assert_array_equal(kw["init_states"], jtor.init_state_values())  # the caller's array stays
    assert out.shape == ref.shape == (45,)
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=1e-300)
    key = tsc.compute_hash(ttor.generalized_rush_larsen, kw["init_states"], kw["parameters"], 1, 50, 0.05)
    cached = tmp_path / "port" / f"steady_states_{key}.npy"
    assert cached.is_file()
    if tracked:
        jkey = jsc.compute_hash(jtor.generalized_rush_larsen, kw["init_states"], kw["parameters"], 1, 50, 0.05)
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"tracked_values_{key}.npy"),
                                   np.load(tmp_path / "jax" / f"tracked_values_{jkey}.npy"), rtol=1e-10)
    np.save(cached, np.zeros(45))
    hit = tsc.get_steady_state(fun=ttor.generalized_rush_larsen, outdir=tmp_path / "port", device="cpu", **kw)
    np.testing.assert_array_equal(hit, np.zeros(45))


def test_single_cell_refuses_an_unported_model(tmp_path):
    with pytest.raises(NotImplementedError, match="A8"):
        tsc.get_steady_state(fun=ttor.rhs, init_states=ttor.init_state_values(),
                             parameters=ttor.init_parameter_values(), outdir=tmp_path, nbeats=1, BCL=1,
                             device="cpu")


def _assert_kernel_matches_twin(step, twin, states, v, parameters, model):
    for _, S in kernel_check.step_check_states(states, model):
        for dt in (0.025, 0.05):
            _, err = kernel_check.ionic_step_errors(step, twin, S, v, 1.0, dt, parameters)
            assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, err.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["b1", "node", "multi"])
def test_torord_kernels_match_twins_on_card(cuda_device, form):
    """Every state row of each ToR-ORd kernel against its twin, one step at
    n = 100,000 (physiological states and each slow row scaled)."""
    n = 100_000
    s, v = perturbed(n=n, seed=10)
    S = torch.tensor(s, dtype=torch.float32, device=cuda_device)
    V = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    p = jtor.init_parameter_values(i_Stim_Amplitude=0.0, celltype=1.0)
    if form == "b1":
        step, twin, par = cuda_ode.torord_grl_step_v, cuda_ode.torord_grl_step_v_twin, p
    elif form == "node":
        par = torch.tensor(celltype_field(jtor, n, seed=11, i_Stim_Amplitude=0.0), dtype=torch.float32,
                           device=cuda_device)
        step, twin = cuda_ode.torord_grl_node_step_v, cuda_ode.torord_grl_step_v_twin
    else:
        index = torch.as_tensor(np.random.default_rng(12).integers(-1, 3, n).astype(np.int32), device=cuda_device)
        table = np.stack([jtor.init_parameter_values(i_Stim_Amplitude=0.0, celltype=c) for c in (0.0, 1.0, 2.0)])
        table_k = torch.tensor(table, dtype=torch.float32, device=cuda_device)

        def step(S_, v_, t, dt, _p):
            return cuda_ode.torord_grl_multi_step_v(S_, v_, index, t, dt, table_k)

        def twin(S_, v_, t, dt, _p):
            return cuda_ode.torord_grl_multi_step_v_twin(S_, v_, index, t, dt, table)

        par = None
    _assert_kernel_matches_twin(step, twin, S, V, par, "torord_dyncl")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["tp06", "torord_dyncl"])
def test_node_form_on_a_uniform_field_gives_b1_bits_on_card(cuda_device, model):
    jm, tm, off = MODELS[model]
    spec = cuda_ode.IONIC_MODELS[tm.generalized_rush_larsen]
    n = 50_000
    s, v = perturbed(jm, n=n, seed=13)
    S = torch.tensor(s, dtype=torch.float32, device=cuda_device)
    V = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    p = jm.init_parameter_values(celltype=2.0, **off)
    field = torch.tensor(np.tile(p[:, None], (1, n)), dtype=torch.float32, device=cuda_device)
    a, b = S.clone(), S.clone()
    spec.step(a, V, 1.0, 0.05, p)
    before = spec.node_step.launches
    spec.node_step(b, V, 1.0, 0.05, field)
    assert spec.node_step.launches == before + 1
    assert torch.equal(a, b)
    if model == "tp06":
        _assert_kernel_matches_twin(spec.node_step, spec.step_twin, S, V, field, model)


@pytest.mark.cuda
def test_steady_state_on_card(cuda_device, tmp_path):
    kw = dict(init_states=jtor.init_state_values(), parameters=jtor.init_parameter_values(), nbeats=1, BCL=50)
    ref = jsc.get_steady_state(fun=jtor.generalized_rush_larsen, outdir=tmp_path / "jax", **kw)
    before = cuda_ode.torord_grl_step_v.launches
    out = tsc.get_steady_state(fun=ttor.generalized_rush_larsen, outdir=tmp_path / "port", device=cuda_device, **kw)
    assert cuda_ode.torord_grl_step_v.launches == before + 1000
    assert abs(out[0] - ref[0]) < 1.0
