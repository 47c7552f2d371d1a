"""B2, the symmetric stencil SpMV: the port's twin (and its dot) against
the JAX Pallas kernel in interpret mode and against both packages'
``StencilMatrix @ x``, in f64 on the Niederer slab operator (dx=1.0).

The sym form sums the sub-diagonal terms in another order than the full
K-column product, so the tolerance is rtol 1e-12 with an absolute floor
of 1e-12 * max|y| for entries that nearly cancel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.conductivities import as_cell_tensors, default_conductivities
from fenicsx_beat_tpu.conductivities import define_conductivity_tensor
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
from fenicsx_beat_tpu.ops.pallas_spmv import build_pallas_stencil_spmv_sym
from fenicsx_beat_tpu.ops.pallas_spmv import stencil_is_symmetric as j_is_sym
from fenicsx_beat_tpu_torch.convert import stencil_from_numpy
from fenicsx_beat_tpu_torch.ops import cuda_spmv
from fenicsx_beat_tpu_torch.ops.sparse import pack_sym_values, stencil_is_symmetric


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
    """The JAX package's Niederer mass and stiffness stencils (numpy)."""
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    M = as_cell_tensors(define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")), geo.mesh)
    return jfem.assemble_mass_stiffness_stencil(jfem.functionspace(geo.mesh, ("P", 1)), M)


@pytest.mark.parametrize("which", ["mass", "stiff", "theta"])
def test_sym_twin_matches_pallas_and_stencil(operators, which):
    jmass, jstiff = operators
    A = {"mass": jmass, "stiff": jstiff, "theta": jmass.combine(1.0, jstiff, 0.025)}[which]
    offsets, vals = A.offsets, np.asarray(A.vals)
    n = vals.shape[0]
    x = np.random.default_rng(0).uniform(-90.0, 40.0, n)

    spmv = build_pallas_stencil_spmv_sym(offsets, n, jnp.float64, interpret=True)
    packed = spmv.pack_values(vals)
    y_pallas = np.asarray(spmv(packed, jnp.asarray(x)))
    y2_pallas, dot_pallas = spmv.spmv_dot(packed, jnp.asarray(x))
    y_full = np.asarray(A @ jnp.asarray(x))

    T = stencil_from_numpy(offsets, vals)
    pos, vT = pack_sym_values(T)
    assert pos == spmv.positive_offsets
    xt = torch.tensor(x)
    y = cuda_spmv.stencil_spmv_sym(vT, xt, pos).numpy()
    y2, dot = cuda_spmv.stencil_spmv_sym_dot(vT, xt, pos)

    assert_close_floor(y, y_pallas)
    assert_close_floor(y, y_full)
    assert_close_floor(y2.numpy(), np.asarray(y2_pallas))
    np.testing.assert_allclose(float(dot), float(dot_pallas), rtol=1e-12)
    assert_close_floor((T @ xt).numpy(), y_full)


def test_combine_and_diagonal_match(operators):
    jmass, jstiff = operators
    tm = stencil_from_numpy(jmass.offsets, np.asarray(jmass.vals))
    tk = stencil_from_numpy(jstiff.offsets, np.asarray(jstiff.vals))
    jA = jmass.combine(1.0, jstiff, 0.025)
    tA = tm.combine(1.0, tk, 0.025)
    np.testing.assert_array_equal(tA.vals.numpy(), np.asarray(jA.vals))
    np.testing.assert_array_equal(tA.diagonal().numpy(), np.asarray(jA.diagonal()))


def test_symmetry_check_matches_jax(operators):
    jmass, _ = operators
    vals = np.asarray(jmass.vals).copy()
    assert stencil_is_symmetric(jmass.offsets, vals) and j_is_sym(jmass.offsets, vals)
    vals[10, jmass.offsets.index(1)] *= 1.5
    assert not stencil_is_symmetric(jmass.offsets, vals)
    assert not j_is_sym(jmass.offsets, vals)


def test_stencil_from_numpy_rejects_bad_shape():
    with pytest.raises(ValueError):
        stencil_from_numpy((-1, 0, 1), np.zeros((10, 2)))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(operators, cuda_device):
    jmass, jstiff = operators
    A = jmass.combine(1.0, jstiff, 0.025)
    T = stencil_from_numpy(A.offsets, np.asarray(A.vals), device=cuda_device, dtype=torch.float32)
    pos, vT = pack_sym_values(T)
    x = torch.tensor(
        np.random.default_rng(1).uniform(-90.0, 40.0, vT.shape[1]), dtype=torch.float32, device=cuda_device
    )
    launches = cuda_spmv.stencil_spmv_sym.launches
    yk, dk = cuda_spmv.stencil_spmv_sym_dot(vT, x, pos)
    assert cuda_spmv.stencil_spmv_sym.launches == launches + 1
    yt, dt = cuda_spmv.stencil_spmv_sym_dot_twin(vT, x, pos)
    torch.cuda.synchronize()
    assert float((yk - yt).abs().max() / yt.abs().max()) < 1e-5
    assert abs(float(dk) - float(dt)) <= 1e-4 * abs(float(dt))
