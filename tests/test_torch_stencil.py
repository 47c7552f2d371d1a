"""B5 and B6, the general stencil SpMV and its windowed form: the twin
the two share (plain and with the dot), reached through each wrapper's CPU
dispatch, against the JAX Pallas kernels in interpret mode, in f64,
mirroring ``tests/test_stencil.py``; the offset-cluster table of B6; the
conversion of the JAX package's packed values.

Both sides add the K products of a row in offset order, so the tolerance
is rtol 1e-12 with an absolute floor of 1e-12 * max|y| for entries that
nearly cancel; the dot products, summed in other orders, rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry
from fenicsx_beat_tpu.ops.pallas_spmv import (
    build_pallas_stencil_spmv,
    build_pallas_stencil_spmv_streamed,
)
from fenicsx_beat_tpu.ops.sparse import StencilMatrix as JStencil
from fenicsx_beat_tpu_torch.convert import stencil_from_numpy, values_from_packed
from fenicsx_beat_tpu_torch.ops import cuda_stencil
from fenicsx_beat_tpu_torch.ops.sparse import offset_clusters, pack_values


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def assert_close_floor(actual, desired, rtol=1e-12):
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=1e-12 * np.abs(desired).max())


def random_stencil(rng, n, offs):
    """[n, K] values with the entries whose column falls outside [0, n)
    zeroed, as an assembled operator has them."""
    vals = rng.standard_normal((n, len(offs)))
    cols = np.arange(n)[:, None] + np.asarray(offs)[None, :]
    vals[(cols < 0) | (cols >= n)] = 0.0
    return vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b5_twin_matches_pallas_random_offsets(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(300, 3000))
    K = int(rng.integers(3, 12))
    offs = tuple(int(d) for d in np.unique(np.concatenate([[0], rng.integers(-(n // 3), n // 3, K)])))
    vals = random_stencil(rng, n, offs)
    x = rng.standard_normal(n)

    spmv = build_pallas_stencil_spmv(offs, n, jnp.float64, interpret=True)
    packed = spmv.pack_values(vals)
    y_pallas = np.asarray(spmv(packed, jnp.asarray(x)))
    y2_pallas, dot_pallas = spmv.spmv_dot(packed, jnp.asarray(x))
    y_jax = np.asarray(JStencil(offsets=offs, vals=jnp.asarray(vals), shape=(n, n)) @ jnp.asarray(x))

    vT = pack_values(stencil_from_numpy(offs, vals))
    xt = torch.tensor(x)
    y = cuda_stencil.stencil_spmv(vT, xt, offs).numpy()
    y2, dot = cuda_stencil.stencil_spmv_dot(vT, xt, offs)
    assert_close_floor(y, y_pallas)
    assert_close_floor(y, y_jax)
    assert_close_floor(y2.numpy(), np.asarray(y2_pallas))
    np.testing.assert_allclose(float(dot), float(dot_pallas), rtol=1e-10)


@pytest.mark.parametrize(
    "offs",
    [
        (-130, -129, -128, -1, 0, 1, 128, 129, 130),
        # the slab's shape of offsets (nz = 61), with P cut to 1,040
        (-1102, -1101, -1041, -1040, -62, -61, -1, 0, 1, 61, 62, 1040, 1041, 1101, 1102),
    ],
)
def test_b6_twin_matches_streamed_pallas(offs):
    """B6's CPU form (the twin B5 and B6 share) against the streamed Pallas
    kernel on a multi-block grid (64-row blocks of 128 lanes)."""
    rng = np.random.default_rng(11)
    n = 40_000
    vals = random_stencil(rng, n, offs)
    x = rng.normal(size=n)

    spmv = build_pallas_stencil_spmv_streamed(offs, n, np.float64, block_rows=64, interpret=True)
    packed = spmv.pack_values(vals)
    y_pallas = np.asarray(spmv(jnp.asarray(packed), jnp.asarray(x)))
    y2_pallas, dot_pallas = spmv.spmv_dot(jnp.asarray(packed), jnp.asarray(x))

    vT = values_from_packed(packed, n)
    xt = torch.tensor(x)
    y = cuda_stencil.stencil_spmv_window(vT, xt, offs).numpy()
    y2, dot = cuda_stencil.stencil_spmv_window_dot(vT, xt, offs)
    assert_close_floor(y, y_pallas)
    assert_close_floor(y2.numpy(), np.asarray(y2_pallas))
    np.testing.assert_allclose(float(dot), float(dot_pallas), rtol=1e-10)


@pytest.mark.parametrize(
    "offsets, tile",
    [
        ((-113, -112, -106, -105, -8, -7, -1, 0, 1, 7, 8, 105, 106, 112, 113), 1024),  # slab dx=0.5
        ((-113, -112, -106, -105, -8, -7, -1, 0, 1, 7, 8, 105, 106, 112, 113), 64),
        ((-8663, -8662, -8602, -8601, -62, -61, -1, 0, 1, 61, 62, 8601, 8602, 8662, 8663), 1024),
        ((5, -3000, 0, 2999, -2998, 17), 100),
        ((0,), 1024),
    ],
)
def test_offset_clusters_cover_every_offset_once(offsets, tile):
    cl = offset_clusters(offsets, tile)
    members = [[d for d, c in zip(offsets, cl.cluster_of) if c == i] for i in range(len(cl.lo))]
    assert sorted(d for m in members for d in m) == sorted(offsets)
    for m, lo, span in zip(members, cl.lo, cl.span):
        assert m and lo == min(m) and span == max(m) - lo
    # clusters are ordered, more than a tile apart, and tight inside
    for i in range(len(members) - 1):
        assert min(members[i + 1]) - max(members[i]) > tile
    for m in members:
        s = sorted(m)
        assert all(b - a <= tile for a, b in zip(s, s[1:]))


def test_offset_clusters_of_the_slab_at_dx005():
    """The dx=0.05 slab's offsets form three clusters of spans 62, 124, 62
    (nz = 61 nodes, P = 8,601): 3 x (1024 + span) floats of windows."""
    nz, P = 61, 61 * 141
    offs = sorted({s * (a * P + b * nz + c) for s in (1, -1) for a in (0, 1) for b in (0, 1) for c in (0, 1)})
    assert len(offs) == 15
    cl = offset_clusters(offs, cuda_stencil.WINDOW_TILE)
    assert cl.lo == (-(P + nz + 1), -(nz + 1), P) and cl.span == (nz + 1, 2 * (nz + 1), nz + 1)


def test_values_from_packed_matches_pack_values():
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    mass, _ = jfem.assemble_mass_stiffness_stencil(jfem.functionspace(geo.mesh, ("P", 1)), 1.0)
    vals = np.asarray(mass.vals)
    n = vals.shape[0]
    packed = build_pallas_stencil_spmv(mass.offsets, n, np.float64).pack_values(vals)
    assert packed.shape[1] * packed.shape[2] > n  # lane padding to cut
    np.testing.assert_array_equal(
        values_from_packed(packed, n).numpy(), pack_values(stencil_from_numpy(mass.offsets, vals)).numpy()
    )
    with pytest.raises(ValueError):
        values_from_packed(packed, packed.shape[1] * packed.shape[2] + 1)


def test_wrappers_dispatch_by_device():
    """CPU tensors run the twins (no launch counted); other devices raise."""
    offs = (-1, 0, 1)
    vT = torch.ones(3, 8, dtype=torch.float64)
    x = torch.arange(8, dtype=torch.float64)
    before = (cuda_stencil.stencil_spmv.launches, cuda_stencil.stencil_spmv_window.launches)
    for fn in (cuda_stencil.stencil_spmv, cuda_stencil.stencil_spmv_window):
        np.testing.assert_array_equal(fn(vT, x, offs).numpy(), [1, 3, 6, 9, 12, 15, 18, 13])
    assert (cuda_stencil.stencil_spmv.launches, cuda_stencil.stencil_spmv_window.launches) == before
    meta = torch.empty(8, dtype=torch.float32, device="meta")
    for fn in (cuda_stencil.stencil_spmv, cuda_stencil.stencil_spmv_dot,
               cuda_stencil.stencil_spmv_window, cuda_stencil.stencil_spmv_window_dot):
        with pytest.raises(ValueError):
            fn(vT.float().to("meta"), meta, offs)


@pytest.fixture(scope="module")
def slab_operators():
    """The JAX package's dx=1.0 Niederer-slab mass and stiffness stencils."""
    geo = get_3D_slab_geometry(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0)
    return jfem.assemble_mass_stiffness_stencil(jfem.functionspace(geo.mesh, ("P", 1)), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
def test_kernel_matches_twin_on_card(slab_operators, cuda_device, window):
    plain, dot_form, twin, launches = (
        (cuda_stencil.stencil_spmv_window, cuda_stencil.stencil_spmv_window_dot,
         cuda_stencil.stencil_spmv_dot_twin, cuda_stencil.stencil_spmv_window)
        if window else
        (cuda_stencil.stencil_spmv, cuda_stencil.stencil_spmv_dot,
         cuda_stencil.stencil_spmv_dot_twin, cuda_stencil.stencil_spmv)
    )
    rng = np.random.default_rng(3)
    for A in slab_operators:
        T = stencil_from_numpy(A.offsets, np.asarray(A.vals), device=cuda_device, dtype=torch.float32)
        vT = pack_values(T)
        x = torch.tensor(rng.uniform(-90.0, 40.0, vT.shape[1]), dtype=torch.float32, device=cuda_device)
        count = launches.launches
        yk, dk = dot_form(vT, x, A.offsets)
        yk2 = plain(vT, x, A.offsets)
        assert launches.launches == count + 2
        yt, dt = twin(vT, x, A.offsets)
        torch.cuda.synchronize()
        scale = float(yt.abs().max())
        assert float((yk - yt).abs().max()) <= 1e-5 * scale
        assert float((yk2 - yt).abs().max()) <= 1e-5 * scale
        assert abs(float(dk) - float(dt)) <= 1e-4 * abs(float(dt))
