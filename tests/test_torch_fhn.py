"""FitzHugh-Nagumo on the port: the torch model, its B1 / B1-node / B7
twins and the fused solver, against the JAX package in f64 on the CPU (the
port on its kernels' twins).

- Model API and initial values: bit-equal; ``rhs`` and forward Euler on
  perturbed states, inside, outside and on both edges of the open stimulus
  window: rtol 1e-12.
- B1 (V injected into row 1), its per-node form (a node-aligned [11, n]
  field) and B7 (FHN markers, in ``make_multi_ode``'s storage layout where
  V is row 0), through their wrappers, against the JAX Pallas kernels in
  interpret mode: rtol 1e-12 per state row.
- The port's FusedMonodomainSolver with FHN (one parameter vector, and
  marker layers on B7) against the JAX FusedMonodomainSolver on the unit
  square: states within atol 1e-8 (CG rtol 1e-8 on both sides),
  activation times equal.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.fused import FusedMonodomainSolver as JFused
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step, build_pallas_ode_step
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver as TFused
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.ops import cuda_ode

RTOL = 1e-12
CU_SOURCE = Path(cuda_ode.__file__).resolve().parent.parent / "csrc" / "fhn.cuh"
SPEC = cuda_ode.IONIC_MODELS[tfhn.generalized_rush_larsen]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def perturbed(n=256, seed=0):
    """(s, v) states over the ranges a beat visits, and a PDE voltage."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 60.0, n), rng.uniform(-90.0, 40.0, n)]), rng.uniform(-90.0, 40.0, n)


def test_init_values_and_indices_equal():
    np.testing.assert_array_equal(tfhn.init_state_values(), jfhn.init_state_values())
    np.testing.assert_array_equal(tfhn.init_parameter_values(), jfhn.init_parameter_values())
    kw = dict(stim_amplitude=0.0, b=0.02)
    np.testing.assert_array_equal(tfhn.init_parameter_values(**kw), jfhn.init_parameter_values(**kw))
    np.testing.assert_array_equal(tfhn.init_state_values(v=-80.0), jfhn.init_state_values(v=-80.0))
    assert tfhn._STATE_NAMES == jfhn._STATE_NAMES and tfhn._PARAM_NAMES == jfhn._PARAM_NAMES
    assert tfhn.state_index("v") == jfhn.state_index("v") == SPEC.v_index == 1
    assert all(tfhn.parameter_index(n) == jfhn.parameter_index(n) for n in jfhn._PARAM_NAMES)
    assert tfhn.forward_euler is tfhn.generalized_rush_larsen  # the demo's step finds the kernels
    assert cuda_ode.ionic_model(tfhn.forward_euler) is SPEC
    with pytest.raises(KeyError):
        tfhn.init_state_values(nope=1.0)


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0, 2.0])  # the open window (0, 1): its edges apply no current
def test_rhs_and_forward_euler_match_jax(t):
    s, _ = perturbed(seed=1)
    p = jfhn.init_parameter_values()
    ds_j, dv_j = jfhn.rhs(s, t, p)
    ds_t, dv_t = tfhn.rhs(torch.tensor(s), t, p)
    np.testing.assert_allclose(ds_t.numpy(), ds_j, rtol=RTOL)
    np.testing.assert_allclose(dv_t.numpy(), dv_j, rtol=RTOL)
    ref = np.asarray(jfhn.forward_euler(jnp.asarray(s), t, p, 0.05))
    np.testing.assert_allclose(tfhn.forward_euler(torch.tensor(s), t, p, 0.05).numpy(), ref, rtol=RTOL)
    on = 0.0 < t < 1.0
    free = tfhn.rhs(torch.tensor(s), t, jfhn.init_parameter_values(stim_amplitude=0.0))[1]
    np.testing.assert_allclose((dv_t - free).numpy(), 100.0 if on else 0.0, rtol=RTOL)


def test_stimulus_window_in_the_states_dtype():
    """float32 states compare t with the window in float32, as the kernels
    and the JAX model in the working dtype do: t = 1 - 2^-30 rounds to 1.0,
    the window's open end, and applies no current."""
    s = torch.zeros((2, 4), dtype=torch.float32)
    s[1] = -85.0
    _, dv32 = tfhn.rhs(s, 1.0 - 2.0**-30, tfhn.init_parameter_values())
    _, dv64 = tfhn.rhs(s.double(), 1.0 - 2.0**-30, tfhn.init_parameter_values())
    assert float(dv32.max()) == 0.0 and float(dv64.min()) == 100.0


@pytest.mark.parametrize("form", ["b1", "node"])
def test_b1_twin_matches_pallas_kernel(form):
    """B1 and its per-node form, V injected into row 1, against the JAX
    ionic kernel in its v_index form, in interpret mode at n = 1024, with
    the stimulus on (t = 0.5)."""
    n = 1024
    s, v = perturbed(n=n, seed=2)
    states = torch.tensor(s)
    if form == "node":
        rng = np.random.default_rng(3)
        field = np.tile(jfhn.init_parameter_values()[:, None], (1, n)) * (1 + 0.1 * rng.standard_normal((11, n)))
        step = build_pallas_ode_step(jfhn.forward_euler, num_states=2, n_nodes=n, parameters=None,
                                     dtype=jnp.float64, v_index=1, node_params=11, interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(field), 0.5, 0.05))
        out = SPEC.node_step(states, torch.tensor(v), 0.5, 0.05, torch.tensor(field))
    else:
        p = jfhn.init_parameter_values()
        step = build_pallas_ode_step(jfhn.forward_euler, num_states=2, n_nodes=n, parameters=p,
                                     dtype=jnp.float64, v_index=1, interpret=True)
        ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), 0.5, 0.05))
        out = SPEC.step(states, torch.tensor(v), 0.5, 0.05, p)
    assert out is states  # in place
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)


def test_b7_twin_matches_pallas_kernel():
    """B7 over two FHN parameter sets in make_multi_ode's storage layout (V
    in row 0, s in row 1), against the JAX block-skip kernel with its row
    swaps, in interpret mode; a marker value with no model keeps its
    states, V injected."""
    n = 2500
    rng = np.random.default_rng(4)
    markers = np.repeat(rng.integers(0, 2, n // 50 + 1), 50)[:n]
    markers[rng.choice(n, size=n // 50, replace=False)] = 7
    params = {0: jfhn.init_parameter_values(stim_amplitude=0.0), 1: jfhn.init_parameter_values(b=0.02)}
    funs = {m: jfhn.forward_euler for m in params}
    fj, init, masks, vi = jode.make_multi_ode(markers, funs, {m: jfhn.init_state_values() for m in params},
                                              params, {m: 1 for m in params})
    assert vi == 0 and not any(fj.multi["trivial_swap"])
    step = build_pallas_multi_ode_step(fj.multi, masks_np=masks, num_states=2, n_nodes=n, dtype=jnp.float64,
                                       v_index=0, interpret=True)
    s, v = perturbed(n=n, seed=5)
    s = s[::-1].copy()  # storage layout
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 0.5, 0.05))
    index = torch.as_tensor(cuda_ode.model_index_from_masks(masks))
    states = torch.tensor(s)
    SPEC.multi_step(states, torch.tensor(v), index, 0.5, 0.05, torch.tensor(np.stack([params[0], params[1]])))
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)
    none = index.numpy() < 0
    np.testing.assert_array_equal(states.numpy()[1, none], s[1, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])


def test_cuda_source_tables_match_model():
    src = CU_SOURCE.read_text()
    enum = src[src.index("enum FhnState"):]
    enum = enum[: enum.index("};")]
    states = dict((name, int(i)) for name, i in re.findall(r"\bFHN_(\w+)\s*=\s*(\d+)", enum))
    assert [k for k in states if k != "NUM_STATES"] == jfhn._STATE_NAMES
    assert [states[nm] for nm in jfhn._STATE_NAMES] == [0, 1] and states["NUM_STATES"] == 2
    struct = src[src.index("struct FhnParams"):]
    struct = struct[: struct.index("};")]
    assert re.findall(r"float\s+(\w+);", struct) == jfhn._PARAM_NAMES
    assert re.search(rf"kFhnNumParams\s*=\s*{len(jfhn._PARAM_NAMES)};", src)


def _unit_square(mm, st, nx=8):
    mesh = mm.create_unit_square(None, nx, nx)
    cells = mm.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    tags = mm.meshtags(mesh, 2, cells, 1)
    I_s = st.Stimulus(expr=st.TimeWindow(amplitude=50.0, start=0.0, duration=1.0),
                      dZ=st.dx(mesh, subdomain_data=tags), marker=1)
    return mesh, I_s


@pytest.mark.parametrize("case", ["godunov", "strang", "markers"])
def test_fused_solver_with_fhn_matches_jax(case):
    """The port's fused monodomain solver on FHN (B1's twin, or B7's for
    two marker layers) against the JAX fused solver, 30 steps of 0.1 ms."""
    out = {}
    for pkg, mm, st, fused, model in (("jax", jmesh, jstim, JFused, jfhn), ("port", tmesh, tstim, TFused, tfhn)):
        mesh, I_s = _unit_square(mm, st)
        kw = dict(mesh=mesh, M=0.004, I_s=I_s, theta=0.5 if case == "strang" else 1.0, activation_threshold=-40.0)
        if case == "markers":
            markers = (mesh.coords[:, 0] > 0.5).astype(np.int64)
            kw.update(ode_fun={0: model.forward_euler, 1: model.forward_euler},
                      init_states={m: model.init_state_values() for m in (0, 1)},
                      parameters={0: model.init_parameter_values(stim_amplitude=0.0),
                                  1: model.init_parameter_values(stim_amplitude=0.0, b=0.03)},
                      v_index={0: 1, 1: 1}, ode_markers=markers)
        else:
            kw.update(ode_fun=model.forward_euler, init_states=model.init_state_values(),
                      parameters=model.init_parameter_values(stim_amplitude=0.0), v_index=1)
        if pkg == "jax":
            solver = fused(use_pallas_ode=False, **kw)
        else:
            solver = fused(device="cpu", **kw)
        solver.solve((0.0, 3.0), dt=0.1)
        out[pkg] = (np.asarray(solver.states)[:, : mesh.num_vertices], np.asarray(solver.activation_times()),
                    solver)
    (sj, aj, _), (sp, ap, port) = out["jax"], out["port"]
    assert (ap >= 0).sum() > 0
    np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ap, aj)
    assert (port._ionic_groups is not None) == (case == "markers")


def test_fused_refuses_a_wrong_voltage_row():
    mesh, I_s = _unit_square(tmesh, tstim, nx=4)
    with pytest.raises(ValueError, match="row 1"):
        TFused(mesh=mesh, M=0.004, I_s=I_s, ode_fun=tfhn.forward_euler, init_states=tfhn.init_state_values(),
               parameters=tfhn.init_parameter_values(), v_index=0, device="cpu")


def test_fhn_checks_run_on_the_cpu():
    """kernel_check.fhn_checks, the card's FHN phase, through the twins at
    a small width: every form within the ionic gates (B7's twin reads its
    parameter table rounded to float32 where the reference twin reads it in
    float64: the only difference the CPU can show)."""
    out = kernel_check.fhn_checks(n=600, device="cpu", beat_steps=40)
    assert set(out["forms"]) == {"fhn_step_v", "fhn_node_step_v", "fhn_multi_step_v"}
    for res in out["forms"].values():
        for (_, _, g), (a, e) in res["step"].items():
            assert float(e.max()) <= kernel_check.IONIC_STEP_TOL
            assert g != "no layer" or a == 0.0
        for a, e in res["beat"].values():
            assert float(e.max()) <= kernel_check.IONIC_BEAT_TOL
    assert out["forms"]["fhn_multi_step_v"]["rows"] == ["v", "s"]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["b1", "node", "multi"])
def test_fhn_kernels_match_twins_on_card(cuda_device, form):
    """Each FHN kernel against its twin on the card, one step at
    n = 100,000, per state row by increment."""
    n = 100_000
    s, v = perturbed(n=n, seed=6)
    V = torch.tensor(v, dtype=torch.float32, device=cuda_device)
    p = jfhn.init_parameter_values()
    if form == "multi":
        S = torch.tensor(s[::-1].copy(), dtype=torch.float32, device=cuda_device)
        index = torch.as_tensor(np.random.default_rng(7).integers(-1, 2, n).astype(np.int32), device=cuda_device)
        table = np.stack([p, jfhn.init_parameter_values(b=0.02)])
        table_k = torch.tensor(table, dtype=torch.float32, device=cuda_device)

        def step(S_, v_, t, dt, _p):
            return SPEC.multi_step(S_, v_, index, t, dt, table_k)

        def twin(S_, v_, t, dt, _p):
            return SPEC.multi_step_twin(S_, v_, index, t, dt, table)

        par, vi = None, 0
    else:
        S = torch.tensor(s, dtype=torch.float32, device=cuda_device)
        step, twin, par, vi = SPEC.step, SPEC.step_twin, p, 1
        if form == "node":
            step = SPEC.node_step
            par = torch.tensor(np.tile(p[:, None], (1, n)), dtype=torch.float32, device=cuda_device)
    for t in (0.5, 2.0):
        _, err = kernel_check.ionic_step_errors(step, twin, S, V, t, 0.05, par, v_index=vi)
        assert float(err.max()) <= kernel_check.IONIC_STEP_TOL, err.tolist()
