"""Point location (``fem._locate_cells``): the cells whose padded bounding
box holds a point are the only ones it tests, and it returns what a
barycentric sweep over every cell returns (the lowest-index cell that holds
the point, -1 outside) on points in cells, on shared vertices and edges, at
the tolerance's edge and outside; and ``evaluate_function`` on it equals
the JAX package's at interior points."""

import numpy as np
import pytest
import torch

import fenicsx_beat_tpu.fem as jfem
import fenicsx_beat_tpu.mesh as jmesh
from fenicsx_beat_tpu_torch import fem, mesh as tmesh


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep(m, points, tol):
    """The lowest-index cell holding each point, by the barycentric test
    over every cell, with no bounding-box filter."""
    geom = fem.cell_geometry(m, np.arange(m.num_cells))
    x0 = m.coords[m.cells[:, 0]]
    out = np.full(len(points), -1, dtype=np.int64)
    for i, p in enumerate(points):
        xi = np.einsum("cg,cig->ci", p[None, :] - x0, geom.inv_edges)
        ok = (xi >= -tol).all(axis=1) & (1.0 - xi.sum(axis=1) >= -tol)
        hits = np.nonzero(ok)[0]
        if hits.size:
            out[i] = hits[0]
    return out


def meshes():
    box = tmesh.create_box(None, ((0.0, 0.0, 0.0), (2.0, 1.5, 1.0)), (6, 4, 3))
    skew = tmesh.create_box(None, ((0.0, 0.0, 0.0), (2.0, 1.5, 1.0)), (6, 4, 3))
    rng = np.random.default_rng(3)
    inner = np.all((skew.coords > 1e-9) & (skew.coords < np.array([2.0, 1.5, 1.0]) - 1e-9), axis=1)
    skew.coords[inner] += rng.uniform(-0.05, 0.05, (int(inner.sum()), 3))
    return {"box": box, "skewed box": skew, "unit square": tmesh.create_unit_square(None, 7, 5)}


def probe_points(m, rng):
    """Random points in and around the mesh, vertices (shared by many
    cells), edge midpoints and points just outside a boundary face."""
    lo, hi = m.coords.min(axis=0), m.coords.max(axis=0)
    span = hi - lo
    inside = rng.uniform(lo, hi, (60, m.gdim))
    around = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (40, m.gdim))
    verts = m.coords[rng.integers(0, m.coords.shape[0], 40)]
    c = m.cells[rng.integers(0, m.num_cells, 40)]
    mids = 0.5 * (m.coords[c[:, 0]] + m.coords[c[:, 1]])
    edge = np.tile(0.5 * (lo + hi), (4, 1))
    edge[:, 0] = [lo[0] - 1e-12, lo[0] - 1e-9, hi[0] + 1e-12, hi[0] + 1e-9]
    return np.concatenate([inside, around, verts, mids, edge])


@pytest.mark.parametrize("tol", [1e-10, 1e-8])
@pytest.mark.parametrize("name", ["box", "skewed box", "unit square"])
def test_locate_cells_equals_the_sweep_over_every_cell(name, tol):
    m = meshes()[name]
    pts = probe_points(m, np.random.default_rng(11))
    got = fem._locate_cells(m, pts, tol=tol)
    want = sweep(m, pts, tol)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 100 and (got < 0).sum() > 10  # both kinds of point were asked


def test_evaluate_function_equals_jax_at_interior_points():
    box = tmesh.create_box(None, ((0.0, 0.0, 0.0), (2.0, 1.5, 1.0)), (6, 4, 3))
    jbox = jmesh.create_box(None, ((0.0, 0.0, 0.0), (2.0, 1.5, 1.0)), (6, 4, 3))
    np.testing.assert_array_equal(box.coords, np.asarray(jbox.coords))
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(box.coords.shape[0])
    u = fem.Function(fem.functionspace(box, ("P", 1)))
    u.x.array[:] = vals
    ju = jfem.Function(jfem.functionspace(jbox, ("P", 1)))
    ju.x.array[:] = vals
    pts = rng.uniform([0.01, 0.01, 0.01], [1.99, 1.49, 0.99], (50, 3))
    np.testing.assert_allclose(fem.evaluate_function(u, pts), np.asarray(jfem.evaluate_function(ju, pts)),
                               rtol=0, atol=1e-12)
