"""The port's SA-AMG (``fenicsx_beat_tpu_torch/ops/amg.py``) against the JAX
package's ``ops/amg.py``, f64 on the CPU (every product on B8's twin).

The cases of ``tests/test_amg.py``, each side built by its own package from
the same numbers: the aggregates and every level's sparsity equal, values,
``dinv``, ``lmax`` and the dense bottom inverse within 1e-12 relative; one
V-cycle on a seeded vector within 1e-10 relative; PCG iterations equal to
JAX's within 1 on the LV stiffness, SPD (Dirichlet-masked) and
semidefinite, across refinements; the V-cycle symmetric and positive; the
small operator's exact dense solve; the float32 hierarchy; the disk cache
round trip bit for bit under a private ``XDG_CACHE_HOME``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu.conductivities import as_cell_tensors as j_cells
from fenicsx_beat_tpu.conductivities import conductivity_tensor as j_tensor
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as j_lv
from fenicsx_beat_tpu.ops import amg as jamg
from fenicsx_beat_tpu.ops.cg import cg as j_cg
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors as t_cells
from fenicsx_beat_tpu_torch.conductivities import conductivity_tensor as t_tensor
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as t_lv
from fenicsx_beat_tpu_torch.ops import amg as tamg
from fenicsx_beat_tpu_torch.ops import cuda_ell
from fenicsx_beat_tpu_torch.ops.cg import cg as t_cg

CPU = torch.device("cpu")
SIDES = {
    "jax": (jmesh, jfem, j_lv, j_tensor, j_cells),
    "port": (tmesh, tfem, t_lv, t_tensor, t_cells),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# operators, built by each package from the same numbers
# ----------------------------------------------------------------------
def lv_stiffness(side, psize, aniso=False):
    _, fem, lv, tensor, cells = SIDES[side]
    geo = lv(psize_ref=psize, cache=False)
    V = fem.functionspace(geo.mesh, ("P", 1))
    if not aniso:
        return fem.assemble_mass_stiffness(V, 1.0)[1]
    # the bidomain extracellular operator K(M_i) + K(M_e) along the fibers
    Mi = cells(tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0), geo.mesh)
    Me = cells(tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0), geo.mesh)
    _, Ki = fem.assemble_mass_stiffness(V, Mi)
    _, Ke = fem.assemble_mass_stiffness(V, Me)
    return Ki.combine(1.0, Ke, 1.0)


def hetero_box(side):
    """Per-cell coefficient jump across x = 0.5 on a structured box (the
    stencil-format input: the DCT declines there)."""
    mm, fem, *_ = SIDES[side]
    m = mm.create_box(None, ((0, 0, 0), (1, 1, 1)), (12, 12, 12))
    V = fem.functionspace(m, ("P", 1))
    Mc = np.tile(np.eye(3), (m.num_cells, 1, 1))
    Mc[m.coords[m.cells].mean(axis=1)[:, 0] < 0.5] *= 10.0
    K = fem.assemble_mass_stiffness_auto(V, Mc)[1]
    assert hasattr(K, "offsets")
    return K


def masked_square(side, n=30):
    """``D K D`` of the unit square's Laplacian with x = 0 and x = 1 masked
    (utils.laplace_solve's matrix): decoupled zero rows."""
    mm, fem, *_ = SIDES[side]
    m = mm.create_unit_square(None, n, n)
    V = fem.functionspace(m, ("P", 1))
    K = fem.assemble_mass_stiffness(V, 1.0)[1]
    free = ~((m.coords[:, 0] < 1e-12) | (m.coords[:, 0] > 1 - 1e-12))
    D = sp.diags(free.astype(float))
    to_csr = jamg.operator_to_csr if side == "jax" else tamg.operator_to_csr
    return (D @ to_csr(K) @ D).tocsr(), K, free


def shifted_square(side, n=9):
    mm, fem, *_ = SIDES[side]
    m = mm.create_unit_square(None, n, n)
    M, K = fem.assemble_mass_stiffness(fem.functionspace(m, ("P", 1)), 1.0)
    return K.combine(1.0, M, 0.5)  # definite, still elliptic


# name -> (operator builder(side), build_amg options)
CASES = {
    "lv_semidefinite": (lambda s: lv_stiffness(s, 0.8), dict(semidefinite=True)),
    "lv_aniso_bidomain_opts": (lambda s: lv_stiffness(s, 0.7, aniso=True),
                               dict(semidefinite=True, strength_theta=(0.15, 0.05), omega=0.0, coarse_n=150)),
    "lv_two_passes": (lambda s: lv_stiffness(s, 0.8),
                      dict(semidefinite=True, omega=(0.0, 4 / 3), agg_passes=(2, 1), coarse_n=60)),
    "hetero_stencil": (hetero_box, dict(semidefinite=True)),
    "masked_dirichlet": (lambda s: masked_square(s)[0], dict(semidefinite=False)),
}


def csr_of(M, to_csr):
    M = M.tocsr() if sp.issparse(M) else to_csr(M)
    M = M.tocsr(copy=True)
    M.sum_duplicates()
    M.sort_indices()
    return M


def assert_csr_close(a, b, what):
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=what)
    np.testing.assert_array_equal(a.indices, b.indices, err_msg=what)
    scale = np.abs(a.data).max()
    assert np.abs(np.asarray(b.data, np.float64) - a.data).max() <= 1e-12 * scale, what


@pytest.mark.parametrize("case", sorted(CASES))
def test_hierarchy_equals_jax(case):
    build, opts = CASES[case]
    jh = jamg.build_amg(build("jax"), dtype=np.float64, **opts)
    th = tamg.build_amg(build("port"), dtype=np.float64, **opts)
    assert th.n_levels == jh.n_levels >= 2, (th.n_levels, jh.n_levels)
    assert th.degree == jh.degree and th.lmin_frac == jh.lmin_frac
    for k, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        for name in ("A", "P", "R"):
            assert_csr_close(csr_of(getattr(jl, name), jamg.operator_to_csr),
                             csr_of(getattr(tl, name), tamg.operator_to_csr), f"level {k} {name}")
        np.testing.assert_allclose(tl.dinv, jl.dinv, rtol=1e-12, atol=0)
        assert float(tl.lmax) == pytest.approx(float(jl.lmax), rel=1e-12)
    ci_j, ci_t = np.asarray(jh.coarse_inv), np.asarray(th.coarse_inv)
    assert np.abs(ci_t - ci_j).max() <= 1e-12 * np.abs(ci_j).max()


@pytest.mark.parametrize("theta", [0.05, 0.15])
def test_aggregates_equal_jax(theta):
    """The seeded MIS aggregation on the same strength graph: the same
    aggregate of every node, the same count."""
    K = tamg.operator_to_csr(lv_stiffness("port", 0.8, aniso=True))
    S_t = tamg._strength_graph(K, theta)
    S_j = jamg._strength_graph(K, theta)
    assert (S_t != S_j).nnz == 0
    offdiag = K.copy()
    offdiag.setdiag(0.0)
    offdiag.eliminate_zeros()
    active = np.diff(offdiag.indptr) > 0
    agg_t, n_t = tamg._aggregate(S_t, active)
    agg_j, n_j = jamg._aggregate(S_j, active)
    assert n_t == n_j > 0
    np.testing.assert_array_equal(agg_t, agg_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vcycle_equals_jax(case):
    build, opts = CASES[case]
    jh = jamg.build_amg(build("jax"), dtype=np.float64, **opts).to_device()
    th = tamg.build_amg(build("port"), dtype=np.float64, **opts).to_device(CPU)
    n = th.levels[0].dinv.shape[0]
    r = np.random.default_rng(7).standard_normal(n)
    zj = np.asarray(jamg.amg_apply(jh, jnp.asarray(r)))
    before = cuda_ell.csr_spmv.launches
    zt = tamg.amg_apply(th, torch.as_tensor(r)).numpy()
    assert cuda_ell.csr_spmv.launches == before  # the CPU runs B8's twin
    assert np.abs(zt - zj).max() <= 1e-10 * np.abs(zj).max()


# ----------------------------------------------------------------------
# PCG with the V-cycle, each package on its own operator
# ----------------------------------------------------------------------
def jax_pcg_iters(K, semidefinite, precond, rtol=1e-8, **amg_kwargs):
    n = K.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    if semidefinite:
        b -= b.mean()
    Kd = (jamg._csr_to_ell(K.tocsr(), np.float64) if sp.issparse(K) else K).to_device()
    defl = (lambda y: y - jnp.mean(y)) if semidefinite else (lambda y: y)
    if precond == "amg":
        hd = jamg.build_amg(K, dtype=np.float64, semidefinite=semidefinite, **amg_kwargs).to_device()
        kw = dict(precond=lambda r: defl(jamg.amg_apply(hd, r)))
    else:
        d = Kd.diagonal()
        kw = dict(precond_diag=jnp.where(d != 0, d, 1.0))
    _, info = j_cg(lambda x: defl(Kd @ defl(x)), jnp.asarray(b), rtol=rtol, atol=0.0, maxiter=5000, **kw)
    assert bool(info.converged)
    return int(info.iterations)


def port_pcg_iters(K, semidefinite, precond, rtol=1e-8, **amg_kwargs):
    """The JAX gate's ``_pcg_iters`` on the port: CG on B8's twin, the
    iterate checked against the system."""
    n = K.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    if semidefinite:
        b -= b.mean()
    Kc = cuda_ell.CSRMatrix.from_operator(K)

    def defl(y):
        return y - y.mean() if semidefinite else y

    def matvec(x):
        return defl(Kc @ defl(x))

    if precond == "amg":
        hd = tamg.build_amg(K, dtype=np.float64, semidefinite=semidefinite, **amg_kwargs).to_device(CPU)
        kw = dict(precond=lambda r: defl(tamg.amg_apply(hd, r)))
    else:
        d = Kc.diagonal()
        kw = dict(precond_diag=torch.where(d != 0, d, 1.0))
    bt = torch.as_tensor(b)
    x, info = t_cg(matvec, bt, rtol=rtol, atol=0.0, maxiter=5000, **kw)
    assert info.converged
    assert float(torch.linalg.norm(matvec(x) - bt)) <= 1.1 * rtol * float(torch.linalg.norm(bt))
    return info.iterations


def test_mesh_independent_iterations_unstructured_lv():
    """The JAX gate on the port: on the LV (semidefinite) AMG-PCG counts
    stay near-flat over three refinements while Jacobi's grow; every count
    equal to JAX's within 1."""
    amg_its, jac_its = [], []
    for ps in (1.2, 0.8, 0.55):
        Kt, Kj = lv_stiffness("port", ps), lv_stiffness("jax", ps)
        for precond, its in (("amg", amg_its), ("jacobi", jac_its)):
            it_t = port_pcg_iters(Kt, True, precond)
            assert abs(it_t - jax_pcg_iters(Kj, True, precond)) <= 1, (ps, precond)
            its.append(it_t)
    assert jac_its[-1] > 1.3 * jac_its[0]
    assert max(amg_its) < 30 and amg_its[2] <= amg_its[1] + 5
    assert max(amg_its) * 3 < min(jac_its)


@pytest.mark.parametrize("semidefinite", [True, False])
def test_pcg_iterations_equal_jax_on_psize03_lv(semidefinite):
    """The psize 0.3 LV stiffness (9,780 nodes): semidefinite as it stands,
    and SPD with the ENDO and EPI dofs masked (laplace_solve's matrix);
    the port's AMG-PCG iterations equal JAX's within 1."""
    if semidefinite:
        Kt, Kj = lv_stiffness("port", 0.3), lv_stiffness("jax", 0.3)
    else:
        geo = t_lv(psize_ref=0.3, cache=False)
        V = tfem.functionspace(geo.mesh, ("P", 1))
        bc = np.concatenate([tfem.locate_dofs_topological(V, 2, geo.ffun.find(m)) for m in (6, 7)])
        free = np.ones(V.ndofs)
        free[bc] = 0.0
        D = sp.diags(free)
        Kt = (D @ tamg.operator_to_csr(lv_stiffness("port", 0.3)) @ D).tocsr()
        Kj = (D @ jamg.operator_to_csr(lv_stiffness("jax", 0.3)) @ D).tocsr()
        Kt.setdiag(np.where(free > 0, Kt.diagonal(), 1.0))  # identity on the masked rows
        Kj.setdiag(np.where(free > 0, Kj.diagonal(), 1.0))
    it_t = port_pcg_iters(Kt, semidefinite, "amg")
    it_j = jax_pcg_iters(Kj, semidefinite, "amg")
    assert abs(it_t - it_j) <= 1 and it_t < 60


def test_dirichlet_masked_rows_terminate_and_solve():
    """The masked solve's hierarchy leaves the decoupled rows off the
    coarse grids, and PCG on the masked operator matches a dense solve."""
    A, K, free = masked_square("port")
    h = tamg.build_amg(A, dtype=np.float64, semidefinite=False)
    assert h.coarse_inv.shape[0] < free.sum()
    hd = h.to_device(CPU)
    b = np.where(free, np.random.default_rng(3).standard_normal(A.shape[0]), 0.0)
    Kc = cuda_ell.CSRMatrix.from_operator(K)
    fr = torch.as_tensor(free)

    def matvec(v):
        return torch.where(fr, Kc @ torch.where(fr, v, 0.0), 0.0)

    x, info = t_cg(matvec, torch.as_tensor(b), precond=lambda r: tamg.amg_apply(hd, r), rtol=1e-10, atol=0.0,
                   maxiter=200)
    assert info.converged
    x_dense = np.zeros(A.shape[0])
    x_dense[free] = np.linalg.solve(A.todense()[np.ix_(free, free)], b[free])
    np.testing.assert_allclose(x.numpy(), x_dense, rtol=1e-7, atol=1e-9)


def test_vcycle_is_symmetric_positive():
    """Equal pre- and post-smoothing and a zero start: the V-cycle is a
    fixed SPD operator (three levels: coarse_n 20 on 100 dofs)."""
    h = tamg.build_amg(shifted_square("port"), dtype=np.float64, semidefinite=False, coarse_n=20)
    assert h.n_levels >= 3
    h = h.to_device(CPU)
    n = h.levels[0].dinv.shape[0]
    Z = torch.stack([tamg.amg_apply(h, torch.eye(n, dtype=torch.float64)[i]) for i in range(n)]).numpy()
    np.testing.assert_allclose(Z, Z.T, rtol=1e-10, atol=1e-12)
    assert np.linalg.eigvalsh(0.5 * (Z + Z.T)).min() > 0


def test_small_operator_is_exact_dense_solve():
    m = tmesh.create_unit_square(None, 6, 6)
    K = tfem.assemble_mass_stiffness(tfem.functionspace(m, ("P", 1)), 1.0)[1]
    h = tamg.build_amg(K, dtype=np.float64, semidefinite=True)
    assert h.n_levels == 1
    assert port_pcg_iters(K, True, "amg") <= 2


def test_float32_hierarchy():
    """dtype float32 (numpy or torch) stores float32 values and bottom
    inverse, equal to the float64 build's rounded, and preconditions a
    float32 PCG on B8's twin to 1e-5."""
    K = lv_stiffness("port", 0.9)
    h64 = tamg.build_amg(K, dtype=np.float64, semidefinite=True)
    for dtype in (np.float32, torch.float32):
        h = tamg.build_amg(K, dtype=dtype, semidefinite=True)
        assert h.levels[0].dinv.dtype == np.float32 and h.coarse_inv.dtype == np.float32
        assert h.levels[0].P.dtype == np.float32
        np.testing.assert_array_equal(h.coarse_inv, h64.coarse_inv.astype(np.float32))
    hd = h.to_device(CPU, torch.float32)
    assert hd.coarse_inv.dtype == torch.float32 and hd.levels[0].P.vals.dtype == torch.float32
    Kc = cuda_ell.CSRMatrix.from_operator(K).to(CPU, torch.float32)
    b = np.random.default_rng(0).standard_normal(K.shape[0]).astype(np.float32)
    bt = torch.as_tensor(b - b.mean())

    def defl(y):
        return y - y.mean()

    x, info = t_cg(lambda v: defl(Kc @ defl(v)), bt, precond=lambda r: defl(tamg.amg_apply(hd, r)),
                   rtol=1e-5, atol=0.0, maxiter=100)
    assert info.converged and x.dtype == torch.float32


def test_amg_hierarchy_disk_cache_roundtrip(tmp_path, monkeypatch):
    """``cache_key`` stores the whole hierarchy under the port's own cache
    directory and a second build reads it back: every level, transfer,
    bound and the bottom inverse bit for bit, the same V-cycle bits."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    n1 = 30
    L1 = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n1, n1))
    A = (sp.kron(sp.eye(n1), L1) + sp.kron(L1, sp.eye(n1))).tocsr()
    h1 = tamg.build_amg(A, dtype=np.float64, cache_key="test")
    slots = list((tmp_path / "fenicsx_beat_tpu_torch" / "amg").glob("*.npz"))
    assert len(slots) == 1
    h2 = tamg.build_amg(A, dtype=np.float64, cache_key="test")
    assert h2.n_levels == h1.n_levels >= 2
    for a, b in zip(h1.levels, h2.levels):
        for name in ("P", "R") + (("A",) if a is not h1.levels[0] else ()):
            ma, mb = getattr(a, name), getattr(b, name)
            assert np.array_equal(ma.indptr, mb.indptr) and np.array_equal(ma.indices, mb.indices)
            assert np.array_equal(ma.data, mb.data)
        assert np.array_equal(a.dinv, b.dinv) and float(a.lmax) == float(b.lmax)
    assert h2.levels[0].A is A  # level 0 is the caller's operator
    assert np.array_equal(h1.coarse_inv, h2.coarse_inv)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(A.shape[0]))
    assert torch.equal(tamg.amg_apply(h1.to_device(CPU), r), tamg.amg_apply(h2.to_device(CPU), r))
    # another option, another slot
    tamg.build_amg(A, dtype=np.float64, cache_key="test", degree=3)
    assert len(list(slots[0].parent.glob("*.npz"))) == 2


def test_apply_needs_the_device_hierarchy():
    h = tamg.build_amg(shifted_square("port"), dtype=np.float64, coarse_n=20)
    with pytest.raises(TypeError, match="to_device"):
        tamg.amg_apply(h, torch.zeros(h.levels[0].dinv.shape[0], dtype=torch.float64))
