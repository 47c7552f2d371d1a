"""The DCT spectral preconditioner and the general-preconditioner CG on the
port, against the JAX package in f64 on the CPU.

- ``grid_shape`` and ``stencil_dct_eigenvalues`` (the host numpy copy):
  bit-equal to JAX's on the unit square and a 3-D box, and both decline on
  a heterogeneous conductivity and an unstructured mesh.
- ``dct_solve``: within 1e-12 relative of JAX's (HIGHEST-precision)
  ``dct_solve``, 2-D and 3-D.
- CG with ``precond`` on the DCT solver: the same iterations and solution
  as JAX's ``cg``; a stacked ``[2, n]`` system: the flattening inner
  product gives JAX's ``vdot`` iterations.
- On the card (marked ``cuda``): the float32 solve within 1e-5 of a
  float64 host solve, also with TF32 matmuls switched on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as jslab
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.ops import cg as jcg
from fenicsx_beat_tpu.ops import spectral as jsp
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry as tslab
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as tlv
from fenicsx_beat_tpu_torch.ops import cg as tcg
from fenicsx_beat_tpu_torch.ops import spectral as tsp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _stiffness(fem, mesh, M):
    _, stiff = fem.assemble_mass_stiffness_auto(fem.functionspace(mesh, ("P", 1)), M)
    return stiff


def _meshes(kind):
    if kind == "square":
        return jmesh.create_unit_square(None, 12, 9), tmesh.create_unit_square(None, 12, 9), np.diag([0.004, 0.0004])
    kw = dict(dx=0.5, Lx=4.0, Ly=2.0, Lz=2.5)
    return jslab(None, **kw).mesh, tslab(None, **kw).mesh, np.diag([0.004, 0.0004, 0.002])


@pytest.mark.parametrize("kind", ["square", "box"])
def test_eigenvalues_bit_equal(kind):
    """On the same stencil values (JAX's assembly; the port's agrees to
    rounding) the eigenvalue model is bit-equal; on the port's own stencil
    it agrees to 1e-12."""
    jm, tm, M = _meshes(kind)
    assert tsp.grid_shape(tm) == jsp.grid_shape(jm) is not None
    js, ts = _stiffness(jfem, jm, M), _stiffness(tfem, tm, M)
    assert ts.offsets == js.offsets
    ref = jsp.stencil_dct_eigenvalues(js, jm, dtype=jnp.float64)
    same = tsp.stencil_dct_eigenvalues(ts.with_values(torch.tensor(np.asarray(js.vals))), tm, dtype=np.float64)
    assert same[1] == ref[1]
    np.testing.assert_array_equal(same[0], ref[0])
    np.testing.assert_allclose(tsp.stencil_dct_eigenvalues(ts, tm)[0], ref[0], rtol=1e-12)


def test_eigenvalues_decline_where_jax_declines():
    jm, tm, _ = _meshes("square")
    mids = tm.coords[tm.cells].mean(axis=1)
    scale = np.where((mids[:, 0] > 0.4) & (mids[:, 0] < 0.6), 1e-3, 1.0)
    M = scale[:, None, None] * (0.004 * np.eye(2))[None]
    assert jsp.stencil_dct_eigenvalues(_stiffness(jfem, jm, M), jm) is None
    assert tsp.stencil_dct_eigenvalues(_stiffness(tfem, tm, M), tm) is None
    assert tsp.grid_shape(tlv(psize_ref=1.2).mesh) is None is jsp.grid_shape(jlv(psize_ref=1.2).mesh)


@pytest.mark.parametrize("kind", ["square", "box"])
def test_dct_solve_matches_jax(kind):
    jm, tm, M = _meshes(kind)
    lam, dims = tsp.stencil_dct_eigenvalues(_stiffness(tfem, tm, M), tm)
    r = np.random.default_rng(0).standard_normal(int(np.prod(dims)))
    ref = np.asarray(jsp.dct_solve(jnp.asarray(r), jnp.asarray(lam), dims))
    out = tsp.dct_solve(torch.tensor(r), torch.tensor(lam), dims).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


def test_preconditioned_cg_matches_jax():
    """mass + stiffness preconditioned by the DCT inverse of its own
    stencil: a handful of iterations, JAX's count and solution."""
    jm, tm, _ = _meshes("square")
    out = {}
    for name, fem, mesh, sp, cgm, arr in (("jax", jfem, jm, jsp, jcg, jnp.asarray),
                                          ("port", tfem, tm, tsp, tcg, torch.tensor)):
        mass, stiff = fem.assemble_mass_stiffness_auto(fem.functionspace(mesh, ("P", 1)), 1.0)
        A = mass.combine(1.0, stiff, 1.0)
        solver = sp.stencil_dct_solver(A, mesh)
        b = arr(np.random.default_rng(1).standard_normal(mesh.num_vertices))
        x, info = cgm.cg(lambda u: A @ u, b, precond=solver, rtol=1e-10, maxiter=200)
        out[name] = (np.asarray(x), int(info.iterations), bool(info.converged))
    assert out["port"][2] and out["port"][1] == out["jax"][1] <= 25
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=0, atol=1e-10)


def test_stacked_system_cg_matches_jax():
    """A coupled SPD system on a [2, n] vector (two diagonal blocks, a
    diagonal coupling) with a callable preconditioner: the flattened inner
    product gives JAX's iterations and solution."""
    rng = np.random.default_rng(2)
    n = 200
    d = rng.uniform(1.0, 10.0, (2, n))
    b = rng.standard_normal((2, n))

    def run(arr, stack, cgm):
        D = arr(d)

        def matvec(x):
            return stack([D[0] * x[0] + 0.5 * x[1], 0.5 * x[0] + D[1] * x[1]])

        x, info = cgm.cg(matvec, arr(b), precond=lambda r: r / D, rtol=1e-10, maxiter=500)
        return np.asarray(x), int(info.iterations)

    xj, kj = run(jnp.asarray, jnp.stack, jcg)
    xt, kt = run(torch.tensor, torch.stack, tcg)
    assert kt == kj > 1
    np.testing.assert_allclose(xt, xj, rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_dct_on_card_is_float32_grade_whatever_tf32(cuda_device, tf32):
    """The card's float32 solve against a float64 host solve on the dx=0.5
    slab's elliptic block, with TF32 matmuls allowed or not: the transform
    does not read the setting."""
    from fenicsx_beat_tpu_torch.benchmarks.bidomain_scale import slab_solver

    bi = slab_solver(0.5, device="cpu", dtype=torch.float64)
    r = np.random.default_rng(3).standard_normal(bi._n)
    ref = tsp.dct_solve(torch.tensor(r), bi._u_lam, bi._dims).numpy()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = tsp.dct_solve(torch.tensor(r, dtype=torch.float32, device=cuda_device),
                            bi._u_lam.to(cuda_device), bi._dims).double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
