"""The whole slice: the port's FusedMonodomainSolver against the JAX
package's, on the Niederer-configured slab at dx=1.0 (672 nodes), 40
steps of dt=0.05, in f64 on the CPU (the port on its kernels' twins).

All states agree within atol 1e-8 (CG tolerance rtol 1e-8 on both sides;
the port's symmetric SpMV sums in another order) and activation times are
equal.  Also: a JAX checkpoint continued by the port, the port's
checkpoint read by JAX, a run with node-aligned (2-D) parameters, the
device policy, the options that stay unported, and the import boundary (the
port never loads jax or the JAX package).
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu_torch import fused as tfused
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.config import resolve_device
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.benchmarks.kernel_check import kernel_check
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor

DX, DT, N_STEPS = 1.0, 0.05, 40
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def jax_solver(theta, **kw):
    kw.setdefault("use_pallas_ode", False)
    return jnied._build_solver(dx=DX, theta=theta, operator_cache_key=None, **kw)


def assert_same_run(port, jax_solver_):
    np.testing.assert_allclose(port.states.numpy(), np.asarray(jax_solver_.states)[:, : port._n], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(port.activation_times(), np.asarray(jax_solver_.activation_times()))


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_slice_matches_jax_plain_path(theta):
    js = jax_solver(theta)
    assert js.solve((0.0, N_STEPS * DT), dt=DT).name == "OK"
    ts = tnied._build_solver(dx=DX, theta=theta, device="cpu")
    assert ts.solve((0.0, N_STEPS * DT), dt=DT) == Status.OK
    assert (ts.activation_times() >= 0).sum() > 0  # the S1 region fired
    assert_same_run(ts, js)
    # every step ran the PCG loop's exit test once per iteration, plus once
    assert ts.host_syncs >= 2 * N_STEPS


def test_slice_matches_jax_pallas_interpret_path():
    """Strang against the JAX solver on its Pallas kernels (interpret mode,
    padded node axis, blocked ionic carry, three-kernel PCG)."""
    js = jax_solver(0.5, use_pallas_ode=True, pallas_spmv_min_nodes=1)
    assert js._n_pad > js._n
    js.solve((0.0, N_STEPS * DT), dt=DT)
    ts = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert_same_run(ts, js)


def test_jax_checkpoint_continued_by_port(tmp_path):
    half = N_STEPS // 2
    ref = jax_solver(0.5)
    ref.solve((0.0, N_STEPS * DT), dt=DT, save_freq=half)  # chunked like the resumed run
    first = jax_solver(0.5)
    first.solve((0.0, half * DT), dt=DT)
    path = first.save_state(tmp_path / "ckpt", t=half * DT)
    ts = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    t0 = ts.load_state(path)
    assert t0 == half * DT
    ts.solve((t0, N_STEPS * DT), dt=DT)
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(ref.states), rtol=0, atol=1e-8)
    # the resumed clock restarts from the saved float: stamps agree to rounding
    np.testing.assert_allclose(ts.activation_times(), np.asarray(ref.activation_times()), rtol=0, atol=1e-12)


def test_port_checkpoint_read_by_jax(tmp_path):
    ts = tnied._build_solver(dx=DX, theta=1.0, device="cpu")
    ts.solve((0.0, 5 * DT), dt=DT)
    path = ts.save_state(tmp_path / "port", t=5 * DT)
    js = jax_solver(1.0)
    assert js.load_state(path) == 5 * DT
    np.testing.assert_array_equal(np.asarray(js.states), ts.states.numpy())
    np.testing.assert_array_equal(np.asarray(js.activation_times()), ts.activation_times())
    other = tnied._build_solver(dx=DX, theta=1.0, device="cpu")
    other.load_state(path)
    assert torch.equal(other.states, ts.states)


def test_solver_does_not_alias_caller_arrays():
    """The solver updates its states in place; the caller's arrays stay."""
    init = np.tile(ttp.init_state_values()[:, None], (1, 672))
    before = init.copy()
    ts = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    ts2 = tfused.FusedMonodomainSolver(
        mesh=ts.mesh, M=ts.M, ode_fun=ts.ode_fun, init_states=init, parameters=ts.parameters,
        I_s=ts.I_s, theta=0.5, C_m=ts.C_m, device="cpu",
    )
    ts2.solve((0.0, 2 * DT), dt=DT)
    np.testing.assert_array_equal(init, before)
    assert not np.array_equal(ts2.states.numpy(), before)


def test_surfaces_cg_non_convergence():
    ts = tnied._build_solver(
        dx=DX, theta=1.0, device="cpu", params={"ksp_max_it": 1, "ksp_rtol": 1e-14, "ksp_atol": 1e-16}
    )
    assert ts.solve((0.0, 2 * DT), dt=DT) == Status.NOT_CONVERGING
    assert not ts.last_solve_converged and ts.last_cg.iterations == 1


def test_twins_on_request_match_default_path():
    """use_kernels=False selects the twins explicitly; on the CPU the
    kernel wrappers dispatch to the same twins."""
    out = kernel_check(dx=DX, dt=DT, n_steps=4, device="cpu")
    assert out["max_abs_dev"] == 0.0 and out["device"] == "cpu"


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tnied._build_solver(dx=DX, theta=0.5, device="cuda")


def test_default_device_is_the_card():
    """With no device named the entry points take the card; without one
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    ts = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tfused.FusedMonodomainSolver(
            mesh=ts.mesh, M=ts.M, ode_fun=ts.ode_fun, init_states=ts.init_states,
            parameters=ts.parameters, I_s=ts.I_s, theta=0.5, C_m=ts.C_m, device=None,
        )
    with pytest.raises(RuntimeError, match="cuda"):
        tnied.run_niederer_benchmark(dx=DX, T=1.0)


def unported_step(states, t, parameters, dt):
    """An ionic step the port has no kernel for."""
    return states


# merged Strang, any theta, forward Euler and a marker's parameter field run
# since they were ported (tests/test_torch_fused_scope.py,
# tests/test_torch_ionic_fe.py); a model with no kernels still raises, alone
# or in a marker layer, and so does a model given no parameters
@pytest.mark.parametrize(
    "kw",
    [
        {"ode_fun": unported_step},
        {"ode_fun": ttp.rhs},
        {"ode_fun": {0: unported_step}, "ode_markers": np.zeros(672, dtype=int)},
        {"ode_fun": {0: ttp.generalized_rush_larsen, 1: unported_step},
         "ode_markers": np.arange(672) % 2,
         "init_states": {0: ttp.init_state_values(), 1: ttor.init_state_values()},
         "parameters": {0: np.tile(ttp.init_parameter_values()[:, None], (1, 672)), 1: ttor.init_parameter_values()},
         "v_index": {0: 0, 1: 0}},
        {"parameters": None},
    ],
)
def test_unported_options_raise(kw):
    common = dict(
        mesh=None, M=1.0, ode_fun=ttp.generalized_rush_larsen, init_states=ttp.init_state_values(),
        parameters=ttp.init_parameter_values(), theta=0.5,
    )
    common.update(kw)
    with pytest.raises(NotImplementedError):
        tfused.FusedMonodomainSolver(**common)


@pytest.mark.parametrize("route", ["plain", "pallas_interpret"])
def test_node_aligned_parameters_match_jax(route):
    """2-D ``parameters``, a [54, n] field of mixed celltypes, through B1's
    per-node form (its twin here), against the JAX solver, which routes
    the field to its plain step or to the Pallas kernel's node_params form
    (interpret mode, padded node axis)."""
    n = 672
    cts = np.random.default_rng(0).integers(0, 3, n).astype(float)
    field = np.stack([ttp.init_parameter_values(stim_amplitude=0.0, celltype=c) for c in cts], axis=1)
    kw = {"use_pallas_ode": route == "pallas_interpret"}
    if route == "pallas_interpret":
        kw["pallas_spmv_min_nodes"] = 1
    js = dataclasses.replace(jax_solver(0.5, **kw), parameters=field)
    js.solve((0.0, N_STEPS * DT), dt=DT)
    vec = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    ts = dataclasses.replace(vec, parameters=field)
    assert ts._ionic_groups is None and np.shape(ts.parameters) == (54, n)
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert_same_run(ts, js)
    vec.solve((0.0, N_STEPS * DT), dt=DT)
    assert not torch.equal(vec.states, ts.states)  # the celltypes took effect


def test_node_aligned_parameters_of_the_wrong_shape_raise():
    ts = tnied._build_solver(dx=DX, theta=0.5, device="cpu")
    with pytest.raises(ValueError, match="node-aligned"):
        dataclasses.replace(ts, parameters=np.zeros((54, 5)))


def test_port_imports_neither_jax_nor_jax_package():
    code = (
        "import sys; import fenicsx_beat_tpu_torch, fenicsx_beat_tpu_torch.fused, "
        "fenicsx_beat_tpu_torch.benchmarks.niederer, fenicsx_beat_tpu_torch.benchmarks.kernel_check, "
        "fenicsx_beat_tpu_torch.benchmarks.lv, fenicsx_beat_tpu_torch.convert, "
        "fenicsx_beat_tpu_torch.odesolver, fenicsx_beat_tpu_torch.utils, fenicsx_beat_tpu_torch.geometry, "
        "fenicsx_beat_tpu_torch.ops.cuda_ell, fenicsx_beat_tpu_torch.ops.cuda_ode, "
        "fenicsx_beat_tpu_torch.ops.sparse, fenicsx_beat_tpu_torch.ops.cg, "
        "fenicsx_beat_tpu_torch.ecg, fenicsx_beat_tpu_torch.ops.cuda_stencil, "
        "fenicsx_beat_tpu_torch.benchmarks.ecg_scale, fenicsx_beat_tpu_torch.benchmarks.slab, "
        "fenicsx_beat_tpu_torch.single_cell, fenicsx_beat_tpu_torch.models.torord_dyncl, "
        "fenicsx_beat_tpu_torch.models._common, fenicsx_beat_tpu_torch.models.fitzhughnagumo, "
        "fenicsx_beat_tpu_torch.bidomain, fenicsx_beat_tpu_torch.ops.spectral, "
        "fenicsx_beat_tpu_torch.benchmarks.bidomain_scale, fenicsx_beat_tpu_torch.telemetry, "
        "fenicsx_beat_tpu_torch.base_model, fenicsx_beat_tpu_torch.monodomain_model, "
        "fenicsx_beat_tpu_torch.monodomain_solver, fenicsx_beat_tpu_torch.theta_system, "
        "fenicsx_beat_tpu_torch.stimulation, fenicsx_beat_tpu_torch.fem, "
        "fenicsx_beat_tpu_torch.benchmarks.lv_endocardial, fenicsx_beat_tpu_torch.benchmarks.verification, "
        "fenicsx_beat_tpu_torch.benchmarks.lv_cg_start, fenicsx_beat_tpu_torch.adjoint, "
        "fenicsx_beat_tpu_torch.benchmarks.fit_scale, fenicsx_beat_tpu_torch.benchmarks.adjoint_scale, "
        "fenicsx_beat_tpu_torch.benchmarks.conductivity_fit, fenicsx_beat_tpu_torch.benchmarks.anisotropy_fit; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fenicsx_beat_tpu' or m.startswith('fenicsx_beat_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # chip_smoke.py imports inside its phases: no import line names either
    bad_import = re.compile(r"^\s*(import|from)\s+(jax|fenicsx_beat_tpu)(\.|\s|$)", re.M)
    assert not bad_import.findall((ROOT / "chip_smoke.py").read_text())


@pytest.mark.cuda
def test_kernel_check_on_card(cuda_device):
    out = kernel_check(dx=0.5, dt=DT, n_steps=40, device=cuda_device)
    assert out["max_abs_dev"] < out["threshold"]
