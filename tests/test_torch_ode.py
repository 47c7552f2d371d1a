"""B1, the TP06 ionic step: the port's torch model and kernel twin against
the JAX model and its Pallas kernel (interpret mode), in f64, and the
CUDA source's index table against the model's state and parameter lists.

The twin evaluates the JAX formulas term for term; the tolerance rtol
1e-12 leaves room for the two frameworks' own exp/log rounding only.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_ode_step
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.ops import cuda_ode

CU_SOURCE = Path(cuda_ode.__file__).resolve().parent.parent / "csrc" / "tp06.cuh"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def perturbed_states(n=256, seed=0):
    """TP06 states around the initial values, V across the action
    potential's range so every branch of the model runs."""
    rng = np.random.default_rng(seed)
    s = np.tile(jtp.init_state_values()[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((19, n)))
    s[0] = rng.uniform(-90.0, 40.0, n)
    v = rng.uniform(-90.0, 40.0, n)
    return s, v


def test_init_values_and_indices_equal():
    np.testing.assert_array_equal(ttp.init_state_values(), jtp.init_state_values())
    np.testing.assert_array_equal(ttp.init_parameter_values(), jtp.init_parameter_values())
    np.testing.assert_array_equal(
        ttp.init_parameter_values(stim_amplitude=0.0, celltype=2.0),
        jtp.init_parameter_values(stim_amplitude=0.0, celltype=2.0),
    )
    assert ttp._STATE_NAMES == jtp._STATE_NAMES and ttp._PARAM_NAMES == jtp._PARAM_NAMES
    assert all(ttp.state_index(n) == jtp.state_index(n) for n in jtp._STATE_NAMES)
    with pytest.raises(KeyError):
        ttp.init_state_values(nope=1.0)


@pytest.mark.parametrize("dt", [0.025, 0.05])
@pytest.mark.parametrize("celltype", [0.0, 1.0, 2.0])
def test_grl_matches_jax(dt, celltype):
    s, _ = perturbed_states()
    p = jtp.init_parameter_values(stim_amplitude=0.0, celltype=celltype)
    ref = np.asarray(jtp.generalized_rush_larsen(s, 1.0, p, dt))
    out = ttp.generalized_rush_larsen(torch.tensor(s), 1.0, p, dt).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("t", [0.5, 10.5])
def test_rhs_and_pacing_window_match_jax(t):
    """t=10.5 lies in the model's own pacing window (amplitude -52)."""
    s, _ = perturbed_states(seed=1)
    p = jtp.init_parameter_values()
    np.testing.assert_allclose(
        ttp.rhs(torch.tensor(s), t, p).numpy(), np.asarray(jtp.rhs(s, t, p)), rtol=1e-12, atol=1e-300
    )
    np.testing.assert_allclose(
        ttp.forward_euler(torch.tensor(s), t, p, 0.01).numpy(),
        np.asarray(jtp.forward_euler(s, t, p, 0.01)),
        rtol=1e-12, atol=0,
    )


@pytest.mark.parametrize("dt", [0.025, 0.05])
def test_twin_matches_pallas_kernel(dt):
    """The kernel twin (row injection + GRL, in place) against the JAX
    ionic kernel in its v_index form, run in interpret mode."""
    n = 200  # not a multiple of the kernel block: the JAX side pads
    s, v = perturbed_states(n=n, seed=2)
    p = jtp.init_parameter_values(stim_amplitude=0.0)
    step = build_pallas_ode_step(
        jtp.generalized_rush_larsen, num_states=19, n_nodes=n, parameters=p,
        dtype=jnp.float64, v_index=0, interpret=True,
    )
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), 2.0, dt))
    states = torch.tensor(s)
    out = cuda_ode.tp06_grl_step_v(states, torch.tensor(v), 2.0, dt, p)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=0)


def test_twin_accepts_its_own_voltage_row():
    """The solver passes row V itself as v; the step must read it first."""
    s, _ = perturbed_states(n=64, seed=3)
    p = jtp.init_parameter_values(stim_amplitude=0.0)
    states = torch.tensor(s)
    cuda_ode.tp06_grl_step_v(states, states[0], 0.0, 0.05, p)
    ref = np.asarray(jtp.generalized_rush_larsen(s, 0.0, p, 0.05))
    np.testing.assert_allclose(states.numpy(), ref, rtol=1e-12, atol=0)


def test_cuda_source_index_table_matches_model():
    src = CU_SOURCE.read_text()
    enum = src[src.index("enum Tp06State"):]
    enum = enum[: enum.index("};")]
    states = dict((name, int(i)) for name, i in re.findall(r"\bS_(\w+)\s*=\s*(\d+)", enum))
    assert list(states) == jtp._STATE_NAMES
    assert [states[nm] for nm in jtp._STATE_NAMES] == list(range(19))
    assert re.search(r"TP06_NUM_STATES\s*=\s*19", enum)
    struct = src[src.index("struct Tp06Params"):]
    struct = struct[: struct.index("};")]
    assert re.findall(r"float\s+(\w+);", struct) == jtp._PARAM_NAMES
    assert re.search(rf"kTp06NumParams\s*=\s*{len(jtp._PARAM_NAMES)};", src)


def _with_rate_scaled(row: int, factor: float):
    """The twin with one state row's increment scaled: a kernel whose rate
    for that row is wrong (factor 0: the row is never updated)."""

    def step(states, v, t, dt, p):
        keep = states[row].clone()
        cuda_ode.tp06_grl_step_v_twin(states, v, t, dt, p)
        states[row] = keep + factor * (states[row] - keep)
        return states

    return step


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["K_i", "Na_i", "Ca_SR"])
def test_ionic_step_check_sees_slow_rows(name, dtype):
    """The one-step check resolves the slow concentrations: their one-step
    change is a few float32 ulps of their value, far below any value-based
    tolerance, yet a frozen row or a halved rate exceeds the limit on that
    row alone, while the twin against itself shows nothing."""
    s, v = perturbed_states(n=1024, seed=5)
    p = jtp.init_parameter_values(stim_amplitude=0.0)
    S, V = torch.tensor(s, dtype=dtype), torch.tensor(v, dtype=dtype)
    twin = cuda_ode.tp06_grl_step_v_twin
    _, same = kernel_check.ionic_step_errors(twin, twin, S, V, 1.0, 0.025, p)
    assert float(same.max()) == 0.0
    row = jtp.state_index(name)
    for factor in (0.0, 0.5):
        _, err = kernel_check.ionic_step_errors(_with_rate_scaled(row, factor), twin, S, V, 1.0, 0.025, p)
        assert float(err[row]) > kernel_check.IONIC_STEP_TOL
        assert float(torch.cat([err[:row], err[row + 1:]]).max()) == 0.0


@pytest.mark.parametrize("name", ["K_i", "Na_i", "Ca_SR"])
def test_scaled_slow_rows_resolve_a_small_rate_error(name):
    """In float32 at physiological values one step moves K_i by less than
    an ulp, so a rate 5% off is invisible there; with that row scaled the
    one-step check sees it on that row alone."""
    s, v = perturbed_states(n=1024, seed=8)
    p = jtp.init_parameter_values(stim_amplitude=0.0)
    S, V = torch.tensor(s, dtype=torch.float32), torch.tensor(v, dtype=torch.float32)
    sets = dict(kernel_check.step_check_states(S))
    assert list(sets) == ["physiological", "Ca_SR scaled", "Na_i scaled", "K_i scaled"]
    scaled = sets[f"{name} scaled"]
    row = jtp.state_index(name)
    assert torch.equal(torch.cat([scaled[:row], scaled[row + 1:]]), torch.cat([S[:row], S[row + 1:]]))
    assert float(scaled[row].abs().max()) < 0.02 * float(S[row].abs().max())
    twin = cuda_ode.tp06_grl_step_v_twin
    for dt in (0.025, 0.05):
        _, same = kernel_check.ionic_step_errors(twin, twin, scaled, V, 1.0, dt, p)
        assert float(same.max()) == 0.0
        _, err = kernel_check.ionic_step_errors(_with_rate_scaled(row, 0.95), twin, scaled, V, 1.0, dt, p)
        assert float(err[row]) > kernel_check.IONIC_STEP_TOL
        assert float(torch.cat([err[:row], err[row + 1:]]).max()) == 0.0
    if name == "K_i":
        _, err = kernel_check.ionic_step_errors(_with_rate_scaled(row, 0.95), twin, S, V, 1.0, 0.025, p)
        assert float(err[row]) == 0.0


@pytest.mark.parametrize("name", ["K_i", "Na_i", "Ca_SR"])
def test_ionic_beat_check_sees_a_wrong_rate(name):
    """Over a paced stretch (stimulus at 10 ms, upstroke and early plateau),
    a halved rate on one slow row exceeds the beat limit."""
    rng = np.random.default_rng(6)
    init = jtp.init_state_values()
    s0 = torch.tensor(np.tile(init[:, None], (1, 8)) * (1 + 0.01 * rng.standard_normal((19, 8))))
    p = jtp.init_parameter_values()
    twin = cuda_ode.tp06_grl_step_v_twin
    _, same = kernel_check.ionic_beat_errors(twin, twin, s0, p, dt=0.1, n_steps=10)
    assert float(same.max()) == 0.0
    row = jtp.state_index(name)
    _, err = kernel_check.ionic_beat_errors(_with_rate_scaled(row, 0.5), twin, s0, p, dt=0.1, n_steps=150)
    assert float(err[row]) > kernel_check.IONIC_BEAT_TOL


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    """Every state row of the kernel against the twin, for each celltype:
    one step's increment at n = 100,000 (physiological states and each
    slow row scaled), and one paced beat of 4,096 cells."""
    n = 100_000
    s, v = perturbed_states(n=n, seed=4)
    sk = torch.tensor(s, dtype=torch.float32, device=cuda_device)
    vk = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    launches = cuda_ode.tp06_grl_step_v.launches
    cuda_ode.tp06_grl_step_v(sk.clone(), vk, 1.0, 0.025, jtp.init_parameter_values(stim_amplitude=0.0))
    assert cuda_ode.tp06_grl_step_v.launches == launches + 1
    rng = np.random.default_rng(7)
    init = jtp.init_state_values()
    s0 = np.tile(init[:, None], (1, 4096)) * (1 + 0.01 * rng.standard_normal((19, 4096)))
    for ct in kernel_check.CELLTYPES:
        p = jtp.init_parameter_values(stim_amplitude=0.0, celltype=ct)
        for _, S in kernel_check.step_check_states(sk):
            for dt in (0.025, 0.05):
                _, err = kernel_check.ionic_step_errors(
                    cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin, S, vk, 1.0, dt, p
                )
                assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, (ct, err.tolist())
        _, err = kernel_check.ionic_beat_errors(
            cuda_ode.tp06_grl_step_v, cuda_ode.tp06_grl_step_v_twin,
            torch.tensor(s0, dtype=torch.float32, device=cuda_device),
            jtp.init_parameter_values(celltype=ct),
        )
        assert float(err.max()) <= kernel_check.IONIC_BEAT_TOL, (ct, err.tolist())
