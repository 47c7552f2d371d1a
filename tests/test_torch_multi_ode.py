"""B7, the multi-marker ionic step, and ``make_multi_ode``: the port against
the JAX package in f64 on the CPU (the port on the kernel's twin).

The composition and the twin evaluate the TP06 formulas the JAX model
evaluates, node by node; rtol 1e-12 leaves room for the two frameworks'
own exp/log rounding only (as in ``test_torch_ode.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step
from fenicsx_beat_tpu_torch import odesolver as tode
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.ops import cuda_ode

RTOL = 1e-12
CELLTYPE = {0: 2.0, 1: 0.0, 2: 1.0}  # marker -> TP06 celltype (mid, endo, epi)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def layered_markers(n, seed=0, absent=7):
    """Markers 0/1/2 in runs of 1-200 nodes (so every 1024-node kernel
    block of the JAX kernel holds several), and a few nodes of a marker
    value that has no model."""
    rng = np.random.default_rng(seed)
    out, i = np.empty(n, dtype=np.int64), 0
    while i < n:
        run = int(rng.integers(1, 200))
        out[i : i + run] = rng.integers(0, 3)
        i += run
    out[rng.choice(n, size=n // 50, replace=False)] = absent
    return out


def multi_inputs(markers, dim_init=1, seed=0):
    rng = np.random.default_rng(seed)
    n = markers.shape[0]
    funs_j = {m: jtp.generalized_rush_larsen for m in CELLTYPE}
    funs_t = {m: ttp.generalized_rush_larsen for m in CELLTYPE}
    init = {}
    for m in CELLTYPE:
        base = jtp.init_state_values()
        init[m] = base * (1 + 0.01 * m) if dim_init == 1 else (
            np.tile(base[:, None], (1, n)) * (1 + 0.01 * rng.standard_normal((19, n))))
    params = {m: jtp.init_parameter_values(stim_amplitude=0.0, celltype=ct) for m, ct in CELLTYPE.items()}
    v_idx = {m: 0 for m in CELLTYPE}
    return funs_j, funs_t, init, params, v_idx


def perturbed(n, seed=1):
    rng = np.random.default_rng(seed)
    s = np.tile(jtp.init_state_values()[:, None], (1, n)) * (1 + 0.05 * rng.standard_normal((19, n)))
    s[0] = rng.uniform(-90.0, 40.0, n)
    return s, rng.uniform(-90.0, 40.0, n)


@pytest.mark.parametrize("dim_init", [1, 2])
def test_make_multi_ode_matches_jax(dim_init):
    markers = layered_markers(3000)
    funs_j, funs_t, init, params, v_idx = multi_inputs(markers, dim_init)
    fj, init_j, masks_j, vi_j = jode.make_multi_ode(markers, funs_j, init, params, v_idx)
    ft, init_t, masks_t, vi_t = tode.make_multi_ode(markers, funs_t, init, params, v_idx)
    np.testing.assert_array_equal(init_t, init_j)
    np.testing.assert_array_equal(masks_t, masks_j)
    assert vi_t == vi_j == 0
    for key in ("sizes", "trivial_swap"):
        assert ft.multi[key] == fj.multi[key]
    for a, b in zip(ft.multi["swaps"], fj.multi["swaps"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ft.multi["params"], fj.multi["params"]):
        np.testing.assert_array_equal(a, b)
    s, _ = perturbed(3000)
    ref = np.asarray(fj(jnp.asarray(s), 1.0, masks_j, 0.05))
    out = ft(torch.tensor(s), 1.0, masks_t, 0.05).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)
    # nodes whose marker has no model keep their states
    none = ~masks_t.any(axis=0)
    assert none.sum() > 0
    np.testing.assert_array_equal(out[:, none], s[:, none])


@pytest.mark.parametrize("dt", [0.025, 0.05])
def test_twin_matches_pallas_kernel(dt):
    """B7's twin against the JAX block-skip kernel in interpret mode: three
    celltypes mixed inside 1024-node blocks, one marker value (7) with no
    model, the PDE voltage injected into every node."""
    n = 2500  # not a multiple of the kernel block: the JAX side pads
    markers = layered_markers(n, seed=2)
    funs_j, funs_t, init, params, v_idx = multi_inputs(markers)
    fj, _, masks, _ = jode.make_multi_ode(markers, funs_j, init, params, v_idx)
    step = build_pallas_multi_ode_step(
        fj.multi, masks_np=masks, num_states=19, n_nodes=n, dtype=jnp.float64, v_index=0, interpret=True,
    )
    s, v = perturbed(n, seed=3)
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 2.0, dt))
    model = torch.as_tensor(cuda_ode.model_index_from_masks(masks))
    table = torch.tensor(np.stack([params[m] for m in sorted(CELLTYPE)]))
    states = torch.tensor(s)
    out = cuda_ode.tp06_grl_multi_step_v(states, torch.tensor(v), model, 2.0, dt, table)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=0)
    none = model.numpy() < 0
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])


def test_model_index_from_masks():
    masks = np.array([[1, 0, 0, 1, 0], [0, 1, 0, 1, 0], [0, 0, 1, 0, 0]], dtype=bool)
    np.testing.assert_array_equal(cuda_ode.model_index_from_masks(masks), [0, 1, 2, 1, -1])
    assert cuda_ode.model_index_from_masks(masks).dtype == np.int32


def test_twin_accepts_its_own_voltage_row():
    markers = layered_markers(500, seed=4)
    _, _, _, params, _ = multi_inputs(markers)
    model = torch.as_tensor(np.where(markers < 3, markers, -1).astype(np.int32))
    table = torch.tensor(np.stack([params[m] for m in sorted(CELLTYPE)]))
    s, _ = perturbed(500, seed=5)
    a, b = torch.tensor(s), torch.tensor(s)
    cuda_ode.tp06_grl_multi_step_v(a, a[0], model, 0.0, 0.05, table)
    cuda_ode.tp06_grl_multi_step_v(b, torch.tensor(s[0]), model, 0.0, 0.05, table)
    assert torch.equal(a, b)


def test_non_tp06_models_raise():
    """A step with no kernels raises; TP06's forward Euler has its kernels."""
    markers = np.zeros(10, dtype=np.int64)
    with pytest.raises(NotImplementedError, match="A4"):
        tode.make_multi_ode(
            markers, {0: ttp.rhs}, {0: ttp.init_state_values()},
            {0: ttp.init_parameter_values()}, {0: 0},
        )
    fun, *_ = tode.make_multi_ode(markers, {0: ttp.forward_euler}, {0: ttp.init_state_values()},
                                  {0: ttp.init_parameter_values()}, {0: 0})
    assert fun.multi["funs"] == [ttp.forward_euler]


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device):
    """Every state row of B7 against its twin for each celltype, one step
    at n = 100,000 (physiological states and each slow row scaled); nodes
    of no model exactly as the twin leaves them."""
    n = 100_000
    markers = layered_markers(n, seed=6)
    _, _, _, params, _ = multi_inputs(markers)
    model = torch.as_tensor(np.where(markers < 3, markers, -1).astype(np.int32), device=cuda_device)
    table = torch.tensor(np.stack([params[m] for m in sorted(CELLTYPE)]), dtype=torch.float32,
                         device=cuda_device)
    s, v = perturbed(n, seed=7)
    sk = torch.tensor(s, dtype=torch.float32, device=cuda_device)
    vk = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    groups = {i: torch.nonzero(model == i).flatten() for i in range(3)}
    groups[-1] = torch.nonzero(model < 0).flatten()
    before = cuda_ode.tp06_grl_multi_step_v.launches

    def step(S, v, t, dt, p):
        return cuda_ode.tp06_grl_multi_step_v(S, v, model, t, dt, p)

    def twin(S, v, t, dt, p):
        return cuda_ode.tp06_grl_multi_step_v_twin(S, v, model, t, dt, p)

    for _, S in kernel_check.step_check_states(sk):
        for dt in (0.025, 0.05):
            out = kernel_check.ionic_step_errors_by_group(step, twin, S, vk, 1.0, dt, table, groups)
            assert out[-1][0] == 0.0
            for i in range(3):
                assert float(out[i][1].max()) <= kernel_check.IONIC_STEP_TOL, (i, out[i][1].tolist())
    assert cuda_ode.tp06_grl_multi_step_v.launches > before
