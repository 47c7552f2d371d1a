"""B8, the unstructured SpMV, and the ELL assembly: the port against the JAX
package in f64 on the CPU (the port on the kernel's twin).

- The port's ELL assembly (COO pipeline) against JAX's
  ``assemble_mass_stiffness`` on the LV at psize 0.8, compared as scipy
  CSR within 1e-12 relative (the two assemble in other orders).
- The CSR twin against the JAX lane-gather kernel in interpret mode, with
  ``max_planes=24`` so its COO tail is non-empty, within 1e-12 (sums in
  other orders).
- Rectangular operators, summed duplicates, dropped exact zeros, the
  shared-layout pair with ``combine``, and the device dispatch.
- The twin's fixed summation order: on the CPU bit for bit the formula it
  replaced (``index_add_`` over each entry's row, which the card runs with
  float atomics), empty rows included; on the card, the same bits run
  after run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as j_lv
from fenicsx_beat_tpu.ops.amg import operator_to_csr as j_to_csr
from fenicsx_beat_tpu.ops.pallas_ell import LaneGatherMatrix
from fenicsx_beat_tpu.ops.sparse import ell_spmv as j_ell_spmv
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.ops import cuda_ell
from fenicsx_beat_tpu_torch.ops.cuda_ell import CSRMatrix, pack_csr
from fenicsx_beat_tpu_torch.ops.sparse import (
    ELLMatrix,
    StencilMatrix,
    coo_to_ell,
    ell_to_stencil,
    operator_to_csr,
)

RTOL = 1e-12  # f64, other summation orders


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def lv_operators():
    """Both packages' (mass, stiffness) of the LV at psize 0.8, with the
    Niederer-like anisotropic tensor of its fibre field."""
    jg, tg = j_lv(psize_ref=0.8, cache=False), get_lv_ellipsoid_geometry(psize_ref=0.8)
    f0 = tg.f0[tg.mesh.cells].mean(axis=1)
    f0 /= np.linalg.norm(f0, axis=1, keepdims=True)
    Mc = 1e-3 * np.eye(3)[None] + 2e-3 * np.einsum("ci,cj->cij", f0, f0)
    jV, tV = jfem.functionspace(jg.mesh, ("P", 1)), tfem.functionspace(tg.mesh, ("P", 1))
    return jfem.assemble_mass_stiffness(jV, Mc), tfem.assemble_mass_stiffness(tV, Mc), tV


def _random_csr(n_rows, n_cols, nnz_per_row, band=None, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    if band is None:
        cols = rng.integers(0, n_cols, size=rows.size)
    else:
        cols = np.clip(rows + rng.integers(-band, band, size=rows.size), 0, n_cols - 1)
    return sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(n_rows, n_cols))


@pytest.mark.parametrize("which", [0, 1], ids=["mass", "stiffness"])
def test_ell_assembly_matches_jax_as_csr(lv_operators, which):
    jpair, tpair, _ = lv_operators
    J, T = j_to_csr(jpair[which]), operator_to_csr(tpair[which])
    J.eliminate_zeros()
    T.eliminate_zeros()
    assert isinstance(tpair[which], ELLMatrix) and tpair[which].has_tail  # the apex rows spill
    assert J.shape == T.shape and J.nnz == T.nnz
    np.testing.assert_array_equal(J.indptr, T.indptr)
    np.testing.assert_array_equal(J.indices, T.indices)
    assert abs(J - T).max() <= RTOL * abs(J).max()
    np.testing.assert_allclose(tpair[which].diagonal(), J.diagonal(), rtol=RTOL, atol=0)


def test_auto_assembly_picks_stencil_or_ell(lv_operators):
    """Structured slab -> stencil pair (and its ELL converts to the same
    stencil); the LV -> ELL pair."""
    geo = get_3D_slab_geometry(dx=1.0, Lx=4.0, Ly=3.0, Lz=2.0)
    V = tfem.functionspace(geo.mesh, ("P", 1))
    m_st, k_st = tfem.assemble_mass_stiffness_auto(V, 1.0)
    assert isinstance(m_st, StencilMatrix) and isinstance(k_st, StencilMatrix)
    m_ell, _ = tfem.assemble_mass_stiffness(V, 1.0)
    conv = ell_to_stencil(m_ell)
    assert conv is not None
    assert abs(operator_to_csr(conv) - operator_to_csr(m_st)).max() <= RTOL * float(m_st.vals.abs().max())
    _, _, tV = lv_operators
    m_lv, k_lv = tfem.assemble_mass_stiffness_auto(tV, 1.0)
    assert isinstance(m_lv, ELLMatrix) and isinstance(k_lv, ELLMatrix)


def test_ell_spmv_and_combine_match_jax(lv_operators):
    (jm, jk), (tm, tk), tV = lv_operators
    x = np.random.default_rng(3).standard_normal(tk.shape[1])
    for t_op, j_op in ((tk, jk), (tm.combine(1.0, tk, 0.025), jm.combine(1.0, jk, 0.025))):
        np.testing.assert_allclose(
            (t_op @ torch.tensor(x)).numpy(), np.asarray(j_ell_spmv(j_op, jnp.asarray(x))),
            rtol=RTOL, atol=1e-13,
        )
    # the assembly's layout (the native kit's bounded rows and COO tail) is
    # the JAX package's own, and coo_to_ell of the raw triplets gives the
    # same operator
    for t_op, j_op in ((tm, jm), (tk, jk)):
        for name in ("cols", "tail_rows", "tail_cols"):
            np.testing.assert_array_equal(getattr(t_op, name), np.asarray(getattr(j_op, name)))
    rows, cols, mvals, _, shape = tfem.assemble_mass_stiffness_coo(tV, 1.0)
    one = coo_to_ell(rows, cols, mvals, shape)
    mass1 = tfem.assemble_mass_stiffness(tV, 1.0)[0]
    np.testing.assert_allclose(operator_to_csr(one).toarray(), operator_to_csr(mass1).toarray(), rtol=RTOL, atol=1e-16)


def test_twin_matches_lane_gather_with_tail():
    """The production shape of the JAX test: RCM-ordered LV stiffness whose
    welded-apex rows overflow 24 pages into the COO tail."""
    from fenicsx_beat_tpu.native import rcm_ordering
    from fenicsx_beat_tpu.parallel.solver import ell_adjacency

    geo = j_lv(psize_ref=0.55, cache=False)
    V = jfem.functionspace(geo.mesh, ("P", 1))
    mass, K = jfem.assemble_mass_stiffness(V, 1.0)
    indptr, ucols = ell_adjacency(mass)
    perm = rcm_ordering(indptr, ucols).astype(np.int64)
    iperm = np.empty(V.ndofs, dtype=np.int64)
    iperm[perm] = np.arange(V.ndofs)
    Kc = j_to_csr(K).tocoo()
    Kp = sp.csr_matrix((Kc.data, (iperm[Kc.row], iperm[Kc.col])), shape=K.shape)
    L = LaneGatherMatrix.from_operator(Kp, max_planes=24, interpret=True)
    assert L.has_tail
    x = np.random.default_rng(0).standard_normal(V.ndofs)
    ref = np.asarray(L.to_device() @ jnp.asarray(x))
    C = CSRMatrix.from_operator(Kp)
    np.testing.assert_allclose(cuda_ell.csr_spmv(C, torch.tensor(x)).numpy(), ref, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(C.diagonal().numpy(), np.asarray(L.diagonal()), rtol=0, atol=0)
    # a JAX ELL matrix whose COO tail is non-empty gives the same y
    assert K.has_tail
    CK = CSRMatrix.from_operator(K)
    np.testing.assert_allclose(
        cuda_ell.csr_spmv(CK, torch.tensor(x)).numpy(), np.asarray(j_ell_spmv(K, jnp.asarray(x))),
        rtol=RTOL, atol=1e-12,
    )


def test_rectangular_operator():
    A = sp.random(900, 2100, density=0.003, random_state=3, format="csr")
    x = np.random.default_rng(2).standard_normal(2100)
    C = CSRMatrix.from_operator(A)
    assert C.shape == (900, 2100) and C.diagonal() is None
    y = cuda_ell.csr_spmv(C, torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=RTOL, atol=1e-13)
    L = LaneGatherMatrix.from_operator(A, interpret=True).to_device()
    np.testing.assert_allclose(y, np.asarray(L @ jnp.asarray(x)), rtol=RTOL, atol=1e-13)


def test_pack_sums_duplicates_and_drops_exact_zeros():
    rows = np.array([0, 0, 0, 1, 1, 1])
    cols = np.array([1, 1, 2, 0, 2, 2])
    vals = np.array([[2.0, 3.0, 1.0, 4.0, 0.0, 0.0],  # (1, 2) is zero in both sets: dropped
                     [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]])  # (0, 2) zero here, kept from the first
    indptr, ucols, pvals = pack_csr(rows, cols, vals, (2, 3))
    np.testing.assert_array_equal(indptr, [0, 2, 3])
    np.testing.assert_array_equal(ucols, [1, 2, 0])
    np.testing.assert_array_equal(pvals, [[5.0, 1.0, 4.0], [1.0, 0.0, 0.0]])
    A = sp.csr_matrix((vals[0], (rows, cols)), shape=(2, 3))
    y = cuda_ell.csr_spmv(CSRMatrix.from_operator(A), torch.tensor([1.0, 10.0, 100.0]))
    np.testing.assert_allclose(y.numpy(), [150.0, 4.0])


def test_pair_combine_matches_lane_gather():
    """Mass/stiffness-like pairs with different exact zeros, packed as one
    layout: ``combine`` and the diagonal work on values alone."""
    rng = np.random.default_rng(4)
    n = 1500
    base = _random_csr(n, n, 6, band=100, seed=5).tocoo()
    da, db = base.data.copy(), rng.standard_normal(base.data.size)
    da[::7] = 0.0
    db[3::7] = 0.0
    A = sp.csr_matrix((da, (base.row, base.col)), shape=(n, n))
    B = sp.csr_matrix((db, (base.row, base.col)), shape=(n, n))
    Ca, Cb = CSRMatrix.from_operator_pair(A, B)
    assert Ca.indptr is Cb.indptr and Ca.cols is Cb.cols
    La, Lb = LaneGatherMatrix.from_operator_pair(A, B, interpret=True)
    Lc = La.combine(2.0, Lb, -0.3).to_device()
    C = Ca.combine(2.0, Cb, -0.3)
    x = rng.standard_normal(n)
    y = cuda_ell.csr_spmv(C, torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, (2.0 * A - 0.3 * B) @ x, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(y, np.asarray(Lc @ jnp.asarray(x)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(C.diagonal().numpy(), np.asarray(Lc.diagonal()), rtol=RTOL, atol=1e-14)


def test_device_dispatch_on_the_cpu():
    """A CPU tensor runs the twin and launches nothing; ``to`` moves values
    and diagonal to the requested dtype and keeps int32 indices."""
    A = _random_csr(300, 300, 5, band=30, seed=8)
    C = CSRMatrix.from_operator(A).to("cpu", torch.float32)
    assert C.vals.dtype == torch.float32 and C.diag.dtype == torch.float32
    assert C.indptr.dtype == torch.int32 and C.cols.dtype == torch.int32
    before = cuda_ell.csr_spmv.launches
    x = torch.tensor(np.random.default_rng(1).standard_normal(300), dtype=torch.float32)
    y = cuda_ell.csr_spmv(C, x)
    assert cuda_ell.csr_spmv.launches == before
    assert torch.equal(y, cuda_ell.csr_spmv_twin(C, x))
    np.testing.assert_allclose(y.numpy(), A @ x.double().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(cuda_device, lv_operators):
    _, (mass, stiff), _ = lv_operators
    Cm, Ck = (C.to(cuda_device, torch.float32) for C in CSRMatrix.from_operator_pair(mass, stiff))
    A = Cm.combine(1.0, Ck, 0.025)
    x = torch.tensor(np.random.default_rng(6).uniform(-90, 40, A.shape[1]), dtype=torch.float32,
                     device=cuda_device)
    before = cuda_ell.csr_spmv.launches
    yk = cuda_ell.csr_spmv(A, x)
    assert cuda_ell.csr_spmv.launches == before + 1
    yt = cuda_ell.csr_spmv_twin(A, x)
    torch.cuda.synchronize()
    assert float((yk - yt).abs().max()) <= 1e-4 * float(yt.abs().max())
    with pytest.raises(TypeError):
        cuda_ell.csr_spmv(A, x.double())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_twin_on_the_cpu_is_the_index_add_formula(dtype):
    A = _random_csr(2000, 1500, 9, band=400, seed=11).tolil()
    A[7, :] = 0.0  # an empty row, and a very long one
    A[9, :1200] = np.random.default_rng(12).standard_normal(1200)
    C = CSRMatrix.from_operator(A.tocsr()).to("cpu", dtype)
    assert int(C.indptr[8] - C.indptr[7]) == 0 and int(C.indptr[10] - C.indptr[9]) >= 1200
    x = torch.tensor(np.random.default_rng(13).standard_normal(1500) * 1e3, dtype=dtype)
    rows = torch.repeat_interleave(torch.arange(2000), (C.indptr[1:] - C.indptr[:-1]).long())
    old = torch.zeros(2000, dtype=dtype).index_add_(0, rows, C.vals * torch.index_select(x, 0, C.cols.long()))
    assert torch.equal(cuda_ell.csr_spmv_twin(C, x), old)


@pytest.mark.cuda
def test_twin_repeats_its_bits_on_card(cuda_device, lv_operators):
    _, (mass, stiff), _ = lv_operators
    Cm, Ck = (C.to(cuda_device, torch.float32) for C in CSRMatrix.from_operator_pair(mass, stiff))
    A = Cm.combine(1.0, Ck, 0.025)
    x = torch.tensor(np.random.default_rng(14).uniform(-90, 40, A.shape[1]), dtype=torch.float32,
                     device=cuda_device)
    first = cuda_ell.csr_spmv_twin(A, x)
    assert all(torch.equal(first, cuda_ell.csr_spmv_twin(A, x)) for _ in range(20))
