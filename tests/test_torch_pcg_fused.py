"""B2·B4, the symmetric stencil SpMV with the PCG's search-direction
update folded in, and the structured PCG that runs on it.

- The twin (``stencil_spmv_sym_dir_dot_twin``, through the wrapper) against
  the JAX package's PCG body in interpret mode, f64, on the Niederer slab's
  mass, stiffness and theta operators (dx=1.0): ``build_pallas_axpy``, then
  ``spmv_dot``, then ``rz / pAp``; rtol 1e-12 with an absolute floor of
  1e-12 * max|y| (the sym form sums the sub-diagonal terms in another
  order than the full product), in both the first-iteration form
  (``p' = z``) and the folded one.
- The fused solver's structured ``_pde_solve`` on the CPU, through the
  bound B2·B4 and B3 (which run their twins on CPU tensors) and with
  ``use_kernels=False``, against the generic ``ops/cg.py:cg_solve`` with
  the twin SpMV on the same system: the two run the same recurrences in
  the same operations, so x, the iteration count and rr are equal bit for
  bit.
- On a card (``@pytest.mark.cuda``, skipped without one): the kernel
  against its twin, launches per PCG iteration, and the refusal of a
  ``z`` or ``p_old`` that overlaps the ``p'`` buffer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.conductivities import as_cell_tensors, default_conductivities
from fenicsx_beat_tpu.conductivities import define_conductivity_tensor
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
from fenicsx_beat_tpu.ops.pallas_cg import build_pallas_axpy
from fenicsx_beat_tpu.ops.pallas_spmv import build_pallas_stencil_spmv_sym
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.convert import stencil_from_numpy
from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_spmv
from fenicsx_beat_tpu_torch.ops.cg import cg_solve
from fenicsx_beat_tpu_torch.ops.sparse import pack_sym_values


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


def assert_close_floor(actual, desired, rtol=1e-12):
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=1e-12 * np.abs(desired).max())


@pytest.fixture(scope="module")
def operators():
    """The JAX package's Niederer mass, stiffness and theta stencils (numpy)."""
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    M = as_cell_tensors(define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")), geo.mesh)
    mass, stiff = jfem.assemble_mass_stiffness_stencil(jfem.functionspace(geo.mesh, ("P", 1)), M)
    return {"mass": mass, "stiff": stiff, "theta": mass.combine(1.0, stiff, 0.025)}


def direction_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-90.0, 40.0, n), rng.uniform(-90.0, 40.0, n), 0.83, 1.37


@pytest.mark.parametrize("first", [True, False], ids=["first", "folded"])
@pytest.mark.parametrize("which", ["mass", "stiff", "theta"])
def test_dir_dot_twin_matches_pallas_pcg_body(operators, which, first):
    A = operators[which]
    offsets, vals = A.offsets, np.asarray(A.vals)
    n = vals.shape[0]
    z, p_old, rz_cur, rz_prev = direction_inputs(n, seed=3)

    spmv = build_pallas_stencil_spmv_sym(offsets, n, jnp.float64, interpret=True)
    axpy = build_pallas_axpy(n, jnp.float64, interpret=True)
    jz = jnp.asarray(z)
    jp = jz if first else axpy(jz, jnp.asarray(p_old), jnp.asarray(rz_cur) / jnp.asarray(rz_prev))
    jap, jpap = spmv.spmv_dot(spmv.pack_values(vals), jp)
    jalpha = jnp.asarray(rz_cur) / jpap

    pos, vT = pack_sym_values(stencil_from_numpy(offsets, vals))
    tz = torch.tensor(z)
    p, ap, pap, alpha = cuda_spmv.stencil_spmv_sym_dir_dot(
        vT, tz, torch.tensor(p_old), pos,
        torch.tensor(rz_cur, dtype=torch.float64), None if first else torch.tensor(rz_prev, dtype=torch.float64),
    )
    if first:
        assert p is tz  # p' = z exactly, as the PCG starts
    assert_close_floor(p.numpy(), np.asarray(jp))
    assert_close_floor(ap.numpy(), np.asarray(jap))
    np.testing.assert_allclose(float(pap), float(jpap), rtol=1e-12)
    np.testing.assert_allclose(float(alpha), float(jalpha), rtol=1e-12)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["bound", "twins"])
@pytest.mark.parametrize("warm_steps", [0, 40], ids=["stimulus", "wave"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_structured_pcg_equals_generic_cg(dtype, warm_steps, use_kernels):
    """One theta system of the dx=1 slab (inside the S1 window from the
    initial state, or after 40 steps with the wave under way): the
    structured PCG and the generic one give the same bits."""
    dt = 0.05
    ts = tnied._build_solver(dx=1.0, theta=0.5, device="cpu", dtype=dtype, use_kernels=use_kernels)
    if warm_steps:
        ts.run_chunk(0.0, dt, warm_steps)
    A, B, minv, pcg = ts._operators(dt)
    bound = isinstance(pcg[0], cuda_spmv.SymDirDot) and isinstance(pcg[1], cuda_cg.CGUpdate)
    assert bound == use_kernels  # on CPU tensors the bound kernels run their twins
    v = ts.v.clone()
    x0 = v + 0.01 * torch.linspace(-1.0, 1.0, v.shape[0], dtype=dtype)
    t_stim = warm_steps * dt + 0.025
    amps = ts.stimulus_amplitudes()
    syncs = ts.host_syncs
    x, k, rr, conv = ts._pde_solve((A, B, minv, pcg), v, x0, t_stim, dt, amps)
    assert ts.host_syncs - syncs == k + 1 and conv and k > 0

    b = ts._assemble_rhs(B, v, t_stim, dt, amps)
    pos = ts._pos
    opts = ts._opts
    xg, kg, rrg, _ = cg_solve(
        lambda u: cuda_spmv.stencil_spmv_sym_twin(A, u, pos), b, x0, precond_diag=A[ts._k0],
        rtol=opts["ksp_rtol"], atol=opts["ksp_atol"], maxiter=opts["ksp_max_it"],
    )
    assert k == kg
    assert torch.equal(x, xg) and torch.equal(rr, rrg)


def card_operator(operators, device):
    A = operators["theta"]
    T = stencil_from_numpy(A.offsets, np.asarray(A.vals), device=device, dtype=torch.float32)
    return pack_sym_values(T)


@pytest.mark.cuda
@pytest.mark.parametrize("first", [True, False], ids=["first", "folded"])
def test_dir_dot_kernel_matches_twin_on_card(operators, cuda_device, first):
    pos, vT = card_operator(operators, cuda_device)
    n = vT.shape[1]
    z, p_old, rz_cur, rz_prev = (torch.tensor(np.asarray(a), dtype=torch.float32, device=cuda_device)
                                 for a in direction_inputs(n, seed=5))
    rz_prev = None if first else rz_prev
    launches = cuda_spmv.stencil_spmv_sym_dir_dot.launches
    out_k = cuda_spmv.stencil_spmv_sym_dir_dot(vT, z, p_old, pos, rz_cur, rz_prev)
    assert cuda_spmv.stencil_spmv_sym_dir_dot.launches == launches + 1
    out_t = cuda_spmv.stencil_spmv_sym_dir_dot_twin(vT, z, p_old, pos, rz_cur, rz_prev)
    torch.cuda.synchronize()
    for k, t in zip(out_k, out_t):
        assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())


@pytest.mark.cuda
def test_dir_dot_refuses_aliased_direction_on_card(operators, cuda_device):
    """The bound call writes p' to the buffer that is not ``p_old``; a
    ``z``, or a view as ``p_old``, of that buffer raises."""
    pos, vT = card_operator(operators, cuda_device)
    n = vT.shape[1]
    z, p_old, rz_cur, rz_prev = (torch.tensor(np.asarray(a), dtype=torch.float32, device=cuda_device)
                                 for a in direction_inputs(n, seed=7))
    bound = cuda_spmv.SymDirDot(vT, pos)
    p = bound(z, None, rz_cur, None)[0]
    assert bound(z, p, rz_cur, rz_prev)[0] is not p  # the other buffer
    p = bound(z, p_old, rz_cur, rz_prev)[0]
    with pytest.raises(ValueError, match="apart from the p' buffer"):
        bound(p, p_old, rz_cur, rz_prev)
    with pytest.raises(ValueError, match="apart from the p' buffer"):
        bound(z, p.view(n), rz_cur, rz_prev)


@pytest.mark.cuda
def test_pcg_launches_per_iteration_on_card(cuda_device):
    """Each PCG iteration on the card: B2·B4 once, B3 once, no B4; B2
    twice a solve (A x0 and the right-hand side B v)."""
    dt = 0.05
    ts = tnied._build_solver(dx=1.0, theta=0.5, device=cuda_device)
    ops = ts._operators(dt)
    v = ts.v.clone()
    counts = (cuda_spmv.stencil_spmv_sym_dir_dot, cuda_spmv.stencil_spmv_sym, cuda_cg.cg_update, cuda_cg.axpy)
    before = [w.launches for w in counts]
    x, k, rr, conv = ts._pde_solve(ops, v, v, 0.025, dt, ts.stimulus_amplitudes())
    torch.cuda.synchronize()
    assert k > 0 and conv
    assert [w.launches - b for w, b in zip(counts, before)] == [k, 2, k, 0]
    assert bool(torch.isfinite(x).all())
