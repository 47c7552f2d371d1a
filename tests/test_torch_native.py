"""The port's native host kit (``fenicsx_beat_tpu_torch/native``) against the
JAX package's kit (``fenicsx_beat_tpu.native``) and against its own numpy
twins, on the same seeded inputs.

- Integer outputs (unique rows, ELL columns and counts, stencil offsets,
  permutations, located cells) equal.
- Floats against JAX's kit equal bit for bit (the same C++ arithmetic
  built by the same g++); against the twins within JAX's
  ``tests/test_native.py`` tolerances (rtol 1e-12 to 1e-13, other
  summation orders).
- The ``"too_wide"`` decline and the degenerate-cell refusals.
- A build that fails raises with the compiler's output: no numpy fallback.
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import native as jnat
from fenicsx_beat_tpu_torch import fem, native
from fenicsx_beat_tpu_torch import mesh as meshmod
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {
    "square": lambda: meshmod.create_unit_square(None, 9, 5),
    "slab": lambda: get_3D_slab_geometry(None, dx=0.5, Lx=6.0, Ly=3.0, Lz=2.0).mesh,
    "lv": lambda: get_lv_ellipsoid_geometry(psize_ref=0.8).mesh,
}


def cell_tensors(m, kind: str, seed: int = 7):
    g = m.gdim
    if kind == "broadcast":
        return fem._broadcast_cell_tensor(0.3, m.num_cells, g)
    A = np.random.default_rng(seed).standard_normal((m.num_cells, g, g))
    return A @ np.transpose(A, (0, 2, 1)) + 2 * np.eye(g)


def assert_same(kit, jax_out, twin, rtol=1e-12, atol=1e-15):
    """Integers equal everywhere; floats equal to JAX's kit, near the twin."""
    for a, b, c in zip(kit, jax_out, twin):
        a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
        np.testing.assert_array_equal(a, b)
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, c)
        else:
            np.testing.assert_allclose(a, c, rtol=rtol, atol=atol)


def test_unique_rows():
    rows = np.sort(np.random.default_rng(0).integers(0, 50, size=(2000, 3)), axis=1).astype(np.int32)
    got = native.unique_rows(rows)
    np.testing.assert_array_equal(got, jnat.unique_rows(rows))
    np.testing.assert_array_equal(got, native.unique_rows_twin(rows))


@pytest.mark.parametrize("width", [None, 4, 40])
def test_coo_to_ell_arrays(width):
    rng = np.random.default_rng(1)
    n, nnz = 40, 500
    rows, cols, vals = rng.integers(0, n, nnz), rng.integers(0, n, nnz), rng.standard_normal(nnz)
    kit = native.coo_to_ell_arrays(rows, cols, vals, (n, n), width)
    twin = native.coo_to_ell_arrays_twin(rows, cols, vals, (n, n), width)
    ref = jnat.coo_to_ell_arrays(rows, cols, vals, (n, n), width)
    assert kit[2] == ref[2] == twin[2] == 16  # the widest row, whatever the guess
    assert_same((kit[0], kit[1], kit[3]), (ref[0], ref[1], ref[3]), (twin[0], twin[1], twin[3]))
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    recon = np.zeros((n, n))
    np.add.at(recon, (np.repeat(np.arange(n), kit[2]), kit[0].ravel()), kit[1].ravel())
    np.testing.assert_allclose(recon, dense, atol=1e-12)


def _graph(kind: str):
    """CSR adjacency: a ring with random chords, or a unit square's P1 graph."""
    if kind == "ring":
        rng, n = np.random.default_rng(2), 200
        edges = {(i, (i + 1) % n) for i in range(n)}
        for a, b in rng.integers(0, n, (50, 2)):
            if a != b:
                edges.add((min(a, b), max(a, b)))
        a, b = np.array(sorted(edges)).T
    else:
        m = meshmod.create_unit_square(None, 12, 9)
        a, b = m.entities(1).T
        n = m.num_vertices
    import scipy.sparse as sp

    A = sp.csr_matrix((np.ones(2 * a.size), (np.r_[a, b], np.r_[b, a])), shape=(n, n))
    A.sort_indices()
    return A.indptr.astype(np.int64), A.indices.astype(np.int32), np.stack([a, b])


@pytest.mark.parametrize("kind", ["ring", "square"])
def test_rcm_ordering(kind):
    indptr, indices, edges = _graph(kind)
    perm = native.rcm_ordering(indptr, indices)
    np.testing.assert_array_equal(perm, jnat.rcm_ordering(indptr, indices))
    np.testing.assert_array_equal(perm, native.rcm_ordering_twin(indptr, indices))
    n = indptr.size - 1
    assert sorted(perm.tolist()) == list(range(n))
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    assert np.abs(inv[edges[0]] - inv[edges[1]]).max() <= np.abs(edges[0] - edges[1]).max()


@pytest.mark.parametrize("name", ["interval", "square", "slab"])
def test_p1_geometry(name):
    m = meshmod.create_interval(None, 40) if name == "interval" else MESHES[name]()
    kit = native.p1_geometry(m.coords, m.cells, m.tdim)
    assert_same(kit, jnat.p1_geometry(m.coords, m.cells, m.tdim), native.p1_geometry_twin(m.coords, m.cells, m.tdim))
    # the port's cell geometry is the kit's
    geom = fem.cell_geometry(m)
    np.testing.assert_array_equal(geom.grads, kit[2])
    np.testing.assert_array_equal(geom.inv_edges, kit[2][:, 1:, :])


@pytest.mark.parametrize("fn", ["p1_geometry", "p1_stencil_tables_direct"])
def test_degenerate_cell_raises(fn):
    m = meshmod.create_unit_square(None, 3, 3)
    coords = m.coords.copy()
    coords[m.cells[0, 1]] = coords[m.cells[0, 0]]
    Mc = fem._broadcast_cell_tensor(1.0, m.num_cells, m.gdim)
    args = (coords, m.cells, m.tdim) if fn == "p1_geometry" else (coords, m.cells, Mc, 64, m.num_vertices)
    for f in (getattr(native, fn), getattr(native, f"{fn}_twin"), getattr(jnat, fn)):
        with pytest.raises(np.linalg.LinAlgError):
            f(*args)


@pytest.mark.parametrize("kind", ["broadcast", "per_cell"])
def test_p1_stencil_tables(kind):
    m = meshmod.create_unit_square(None, 8, 6)
    V = fem.functionspace(m, ("P", 1))
    cd = V.cell_dofs.astype(np.int64)
    geom = native.p1_geometry_twin(m.coords, m.cells, 2)
    Mc, base = cell_tensors(m, kind), fem._p1_mass_base(2)
    args = (cd, geom[1], geom[2], Mc, base, 64, V.ndofs)
    kit = native.p1_stencil_tables(*args)
    assert_same(kit, jnat.p1_stencil_tables(*args), native.p1_stencil_tables_twin(*args), rtol=1e-12, atol=1e-14)
    # an unstructured numbering declines
    perm = np.random.default_rng(7).permutation(m.num_vertices).astype(np.int64)
    wide = (perm[cd], geom[1], geom[2], Mc, base, 8, V.ndofs)
    assert native.p1_stencil_tables(*wide) == native.p1_stencil_tables_twin(*wide) == "too_wide"
    assert jnat.p1_stencil_tables(*wide) == "too_wide"


@pytest.mark.parametrize("name", ["square", "slab"])
@pytest.mark.parametrize("kind", ["broadcast", "per_cell"])
def test_p1_stencil_tables_direct(name, kind):
    m = MESHES[name]()
    Mc = cell_tensors(m, kind, seed=11)
    args = (m.coords, m.cells, Mc, 64, m.num_vertices)
    kit = native.p1_stencil_tables_direct(*args, want_volumes=True)
    ref = jnat.p1_stencil_tables_direct(*args, want_volumes=True)
    twin = native.p1_stencil_tables_direct_twin(*args, want_volumes=True)
    assert_same(kit, ref, twin, rtol=1e-12, atol=1e-14)
    # and the port's stencil assembly is the kit's tables
    mass, stiff = fem.assemble_mass_stiffness_stencil(fem.functionspace(m, ("P", 1)), Mc)
    np.testing.assert_array_equal(np.asarray(mass.offsets), kit[0])
    np.testing.assert_array_equal(mass.vals.numpy(), kit[1])
    np.testing.assert_array_equal(stiff.vals.numpy(), kit[2])


def test_p1_stencil_tables_direct_too_wide():
    m = get_lv_ellipsoid_geometry(psize_ref=0.8).mesh
    args = (m.coords, m.cells, cell_tensors(m, "broadcast"), 64, m.num_vertices)
    assert native.p1_stencil_tables_direct(*args) == native.p1_stencil_tables_direct_twin(*args) == "too_wide"
    assert jnat.p1_stencil_tables_direct(*args) == "too_wide"


@pytest.mark.parametrize("case", ["lv", "lv_per_cell", "square_width3"])
def test_p1_ell_tables_direct(case):
    m = MESHES["square" if case == "square_width3" else "lv"]()
    Mc = cell_tensors(m, "per_cell" if case == "lv_per_cell" else "broadcast")
    width = 3 if case == "square_width3" else None
    args = (m.coords, m.cells, Mc, m.num_vertices, width)
    kit, ref, twin = native.p1_ell_tables_direct(*args), jnat.p1_ell_tables_direct(*args), \
        native.p1_ell_tables_direct_twin(*args)
    assert_same(kit[:4], ref[:4], twin[:4], rtol=1e-12, atol=1e-15)
    assert kit[4] is not None  # the apex rows (width 32) or most rows (width 3) spilled
    assert_same(kit[4], ref[4], twin[4], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", ["square", "slab", "lv"])
def test_locate_points(name):
    m = MESHES[name]()
    rng = np.random.default_rng(5)
    lo, hi = m.coords.min(axis=0), m.coords.max(axis=0)
    pts = np.vstack([rng.uniform(lo, hi, size=(12, m.gdim)), m.coords[0], m.coords[-1],
                     np.full(m.gdim, 99.0)])
    got = native.locate_points(m.coords, m.cells, pts)
    np.testing.assert_array_equal(got, jnat.locate_points(m.coords, m.cells, pts))
    np.testing.assert_array_equal(got, native.locate_points_twin(m.coords, m.cells, pts))
    np.testing.assert_array_equal(got, fem._locate_cells(m, pts))
    assert got[-1] == -1 and (got[-3:-1] >= 0).all()
    if name != "lv":  # boxes fill the slab: every sampled point inside
        assert (got[:12] >= 0).all()


def test_unsupported_shapes_raise():
    m = meshmod.create_interval(None, 8)
    with pytest.raises(ValueError):
        native.locate_points(m.coords, m.cells, m.coords[:2])
    with pytest.raises(ValueError):
        native.p1_ell_tables_direct(m.coords, m.cells, np.ones((m.num_cells, 1, 1)), m.num_vertices)


@pytest.mark.parametrize("how", ["source", "compiler"])
def test_failed_build_raises(how, tmp_path, monkeypatch):
    """No fallback: a source g++ refuses, or no g++ at all, raises."""
    if how == "source":
        bad = tmp_path / "beatkit.cpp"
        bad.write_text('extern "C" int broken( { return 0; }\n')
        monkeypatch.setattr(native, "_SRC", bad)
    else:
        monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    native.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            native.unique_rows(np.zeros((2, 2), dtype=np.int32))
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native.library.cache_clear()
