"""The differentiable solver's use of B8 (``csrc/csr_spmv.cu``), without JAX.

On the CPU: B8's combination (``adjoint.LaneCombo``) runs the twin and
counts no launch, forward or backward, and its backward equals the twin's
products it is made of.  On the card (``-m cuda``): the combination's
forward is one B8 launch and its backward ``1 + n_components`` more (dx,
then one per component), counted by ``csr_spmv.launches``, within 1e-4 of
max|twin|, with the same bits over two calls; lane ops with float64 on the
card raise, and a lane-path simulator's steps launch B8, its float32
gradient within 3x float32's noise of the CPU's float64 one.  Imports neither
JAX nor the JAX package, so the card's machine runs it as it is::

    python -m pytest --noconftest tests/test_torch_adjoint_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch import adjoint, fem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.benchmarks import fit_scale
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as fhn
from fenicsx_beat_tpu_torch.ops import cuda_ell

REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _lv_ops():
    geo = get_lv_ellipsoid_geometry(psize_ref=0.8)
    V = fem.functionspace(geo.mesh, ("P", 1))
    mass, k1 = fem.assemble_mass_stiffness_auto(V, 1.0)
    _, k2 = fem.assemble_mass_stiffness_auto(V, np.diag([1.0, 0.2, 0.5]))
    return geo, (mass, k1, k2)


def _combination_pass(combo, w, x, yb):
    wr, xr = w.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = combo.mv(wr, xr)
    y.backward(yb)
    return y.detach(), xr.grad, wr.grad


def _twin_pass(combo, w, x, yb):
    A = combo.matrix(w)
    y = cuda_ell.csr_spmv_twin(A, x)
    dx = cuda_ell.csr_spmv_twin(A, yb)
    dw = torch.stack([torch.dot(yb, cuda_ell.csr_spmv_twin(K, x)) for K in combo.parts])
    return y, dx, dw


def _inputs(n, device, dtype):
    rng = np.random.default_rng(13)
    w = torch.tensor([1.0, 0.004, 0.0012], dtype=dtype, device=device)
    x = torch.as_tensor(rng.uniform(-90.0, 40.0, n), device=device).to(dtype)
    yb = torch.as_tensor(rng.standard_normal(n), device=device).to(dtype)
    return w, x, yb


def test_combination_on_cpu_runs_the_twin():
    _, ops = _lv_ops()
    combo = adjoint.LaneCombo.pack(ops, torch.device("cpu"), torch.float64)
    w, x, yb = _inputs(ops[0].shape[0], "cpu", torch.float64)
    before, back = cuda_ell.csr_spmv.launches, adjoint.LaneCombo.backward_launches
    got = _combination_pass(combo, w, x, yb)
    assert cuda_ell.csr_spmv.launches == before and adjoint.LaneCombo.backward_launches == back
    for a, b in zip(got, _twin_pass(combo, w, x, yb)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_combination_launches_b8_forward_and_backward(cuda_device):
    _, ops = _lv_ops()
    combo = adjoint.LaneCombo.pack(ops, cuda_device, torch.float32)
    w, x, yb = _inputs(ops[0].shape[0], cuda_device, torch.float32)
    A_w = combo.matrix(w)
    before = cuda_ell.csr_spmv.launches
    with torch.no_grad():
        combo.mv(w, x, A_w)
    assert cuda_ell.csr_spmv.launches == before + 1
    before, back = cuda_ell.csr_spmv.launches, adjoint.LaneCombo.backward_launches
    got = _combination_pass(combo, w, x, yb)
    torch.cuda.synchronize()
    assert cuda_ell.csr_spmv.launches == before + 1 + 1 + len(ops)
    assert adjoint.LaneCombo.backward_launches == back + 1 + len(ops)
    for k, t in zip(got, _twin_pass(combo, w, x, yb)):
        assert float((k - t).abs().max()) <= REL_TOL * float(t.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(got, _combination_pass(combo, w, x, yb)))


@pytest.mark.cuda
def test_lane_ops_with_float64_on_the_card_raise(cuda_device):
    geo, _ = _lv_ops()
    with pytest.raises(ValueError, match="float32"):
        adjoint.build_diff_simulator(
            geo.mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=1,
            probe_points=geo.mesh.coords[:2], dt=0.1, n_steps=2, dtype=torch.float64, use_lane_ops=True,
            device=cuda_device)


@pytest.mark.cuda
def test_lane_simulator_launches_b8_every_step(cuda_device):
    """The LV at psize 0.8 asked for lane ops, FitzHugh-Nagumo, 20 steps,
    the trace misfit to a run at another g: B8 launched in the steps and in
    the backward, and the float32 gradient on B8's combination and on the
    plain path (B8's twin) each within 3x float32's noise of the CPU's
    float64 gradient, the noise the larger gap to it of the CPU's float32
    gradient and of its run from states one ulp away (the readings are
    printed: ``-s``)."""
    geo, _ = _lv_ops()
    m3 = geo.mesh
    zmin = m3.coords[:, 2].min()
    tags = tmesh.meshtags(m3, 3, tmesh.locate_entities(m3, 3, lambda x: x[2] <= zmin + 2.0), 1)
    I_s = tstim.Stimulus(expr=tstim.TimeWindow(amplitude=50.0, start=0.0, duration=1.0),
                         dZ=tstim.dx(m3, subdomain_data=tags), marker=1)
    ionic = fhn.init_parameter_values(stim_amplitude=0.0)

    def grad(device, lane, dtype, ulp_seed=None):
        sim = adjoint.build_diff_simulator(
            m3, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=1, I_s=I_s,
            probe_points=m3.coords[::200][:4], dt=0.1, n_steps=20, cg_rtol=1e-6, cg_atol=1e-8,
            use_lane_ops=lane, device=device, dtype=dtype)
        s0 = torch.as_tensor(fhn.init_state_values(), device=device).to(dtype)[:, None].repeat(1, m3.num_vertices)
        if ulp_seed is not None:
            s0 = fit_scale.ulp_moved(s0, ulp_seed)
        with torch.no_grad():
            target = sim({"g": 0.006, "ionic": ionic})
        g = torch.tensor(0.003, dtype=dtype, device=device, requires_grad=True)
        before, back = cuda_ell.csr_spmv.launches, adjoint.LaneCombo.backward_launches
        torch.sum((sim({"g": g, "ionic": ionic}, states0_in=s0) - target) ** 2).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            launched = cuda_ell.csr_spmv.launches - before
            assert (launched > 20 and adjoint.LaneCombo.backward_launches > back) if lane else launched == 0
        return float(g.grad)

    cpu = torch.device("cpu")
    ref = grad(cpu, False, torch.float64)
    noise = max(abs(grad(cpu, False, torch.float32) - ref), abs(grad(cpu, False, torch.float32, 1) - ref))
    for lane in (True, False):
        gap = abs(grad(cuda_device, lane, torch.float32) - ref)
        print(f"use_lane_ops={lane}: float64 gradient {ref:.9e}, card float32 gap {gap:.3e}, float32 noise "
              f"{noise:.3e} ({gap / noise:.2f}x, limit 3x)")
        assert gap <= 3.0 * noise, f"use_lane_ops={lane}"
