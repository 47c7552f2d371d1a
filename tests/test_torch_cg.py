"""B3 and B4, the PCG vector updates, and the PCG itself: the port's twins
against the JAX Pallas kernels in interpret mode, and the port's Jacobi
PCG (generic and the fused solver's kernel choreography) against JAX's
``ops.cg.cg`` on one theta system of the Niederer slab, in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu.ops.cg import cg as j_cg
from fenicsx_beat_tpu.ops.pallas_cg import build_pallas_axpy, build_pallas_cg_update
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.convert import stencil_from_numpy
from fenicsx_beat_tpu_torch.ops import cuda_cg
from fenicsx_beat_tpu_torch.ops.cg import cg as t_cg


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def vectors(n, seed=0):
    rng = np.random.default_rng(seed)
    x, r, p, ap = (rng.standard_normal(n) for _ in range(4))
    minv = rng.uniform(0.5, 2.0, n)
    return x, r, p, ap, minv


@pytest.mark.parametrize("n", [1000, 4096])
def test_cg_update_twin_matches_pallas(n):
    x, r, p, ap, minv = vectors(n)
    alpha = 0.37
    upd = build_pallas_cg_update(n, jnp.float64, interpret=True)
    ref = upd(*map(jnp.asarray, (x, r, p, ap, minv)), jnp.asarray(alpha))
    out = cuda_cg.cg_update(*map(torch.tensor, (x, r, p, ap, minv)), torch.tensor(alpha, dtype=torch.float64))
    for o, e in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(e), rtol=1e-12, atol=1e-15)
    for o, e in zip(out[3:], ref[3:]):
        np.testing.assert_allclose(float(o), float(e), rtol=1e-12)


@pytest.mark.parametrize("n", [1000, 4096])
def test_axpy_twin_matches_pallas(n):
    z, p = vectors(n, seed=1)[:2]
    axpy = build_pallas_axpy(n, jnp.float64, interpret=True)
    ref = np.asarray(axpy(jnp.asarray(z), jnp.asarray(p), jnp.asarray(0.61)))
    out = cuda_cg.axpy(torch.tensor(z), torch.tensor(p), torch.tensor(0.61, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-15)


@pytest.fixture(scope="module")
def theta_system():
    """One Crank-Nicolson system of the Niederer slab (dx=1.0, dt=0.05)
    with the S1 stimulus on, from both packages' solvers."""
    js = jnied._build_solver(dx=1.0, theta=0.5, operator_cache_key=None)
    ts = tnied._build_solver(dx=1.0, theta=0.5, device="cpu")
    dt = 0.05
    mass, stiff = js._mass, js._stiff
    A = mass.combine(js.C_m, stiff, 0.5 * dt)
    B = mass.combine(js.C_m, stiff, -0.5 * dt)
    v = np.asarray(js.v)
    b_unit = np.asarray(js._stim_quads[0][0].assemble_load_host())
    b = np.asarray(B @ jnp.asarray(v)) + dt * float(js.stimulus_amplitudes()[0]) * b_unit
    return js, ts, A, B, v, b, dt


def test_generic_pcg_matches_jax(theta_system):
    _, _, A, _, v, b, _ = theta_system
    kw = dict(rtol=1e-8, atol=1e-10, maxiter=1000)
    xj, info_j = j_cg(lambda u: A @ u, jnp.asarray(b), jnp.asarray(v), precond_diag=A.diagonal(), **kw)
    At = stencil_from_numpy(A.offsets, np.asarray(A.vals))
    xt, info_t = t_cg(lambda u: At @ u, torch.tensor(b), torch.tensor(v), precond_diag=At.diagonal(), **kw)
    assert info_t.iterations == int(info_j.iterations) > 0
    assert info_t.converged and bool(info_j.converged)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)


def test_solver_pcg_matches_jax(theta_system):
    """The fused solver's PCG (B2 + B3 + B4 twins, scalars kept as 0-d
    tensors, one host test per iteration) against JAX's generic CG."""
    js, ts, A, _, v, b, dt = theta_system
    xj, info_j = j_cg(
        lambda u: A @ u, jnp.asarray(b), jnp.asarray(v), precond_diag=A.diagonal(),
        rtol=1e-8, atol=1e-10, maxiter=1000,
    )
    ops = ts._operators(dt)
    syncs = ts.host_syncs
    # t_stim inside the S1 window: the RHS includes the stimulus load
    x, iters, rr, conv = ts._pde_solve(ops, torch.tensor(v), torch.tensor(v), 0.025, dt, ts.stimulus_amplitudes())
    assert iters == int(info_j.iterations) and conv
    assert ts.host_syncs - syncs == iters + 1
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_kernels_match_twins_on_card(cuda_device):
    n = 100_003
    x, r, p, ap, minv = (torch.tensor(a, dtype=torch.float32, device=cuda_device) for a in vectors(n))
    alpha = torch.tensor(0.37, dtype=torch.float32, device=cuda_device)
    launches = cuda_cg.cg_update.launches, cuda_cg.axpy.launches
    outk = cuda_cg.cg_update(x, r, p, ap, minv, alpha)
    outt = cuda_cg.cg_update_twin(x, r, p, ap, minv, alpha)
    pk = cuda_cg.axpy(x, p, alpha)
    assert (cuda_cg.cg_update.launches, cuda_cg.axpy.launches) == (launches[0] + 1, launches[1] + 1)
    torch.cuda.synchronize()
    for k, t in zip(outk, outt):
        assert float((k - t).abs().max()) <= 1e-5 * float(t.abs().max())
    assert float((pk - cuda_cg.axpy_twin(x, p, alpha)).abs().max()) <= 1e-6
