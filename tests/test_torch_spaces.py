"""The port's function spaces beyond P1 (``fenicsx_beat_tpu_torch.fem``,
``utils``, ``geometry``, ``stimulation``) against the JAX package's, on
the same meshes and seeded numpy inputs, in float64 on the CPU.

- the quadrature rules, bit for bit, at degrees 2, 4 and 8 in 2-D and 3-D;
- spaces on unit squares and cubes (N = 2-3) and on the 2-D slab, for P1-P3,
  DG0-DG2, Quadrature 2 and 4, scalar and blocked (dim 2 and 3): ``ndofs``,
  ``cell_dofs`` and ``dof_owner_cell`` equal, dof coordinates within
  1e-12;
- the elements' ``tabulate`` and ``tabulate_grad`` at random points (P4
  through Silvester's form), embedded-mesh geometry;
- mass and stiffness (dense, scalar and per-cell anisotropic M) within
  1e-12 of the largest entry, the operator route the JAX ``BaseModel``
  takes, and the guards on Quadrature and blocked spaces;
- facet dofs, Dirichlet dofs and facet quadrature tables; point
  evaluation tables and ``evaluate_function``, points on shared faces
  included;
- every transfer matrix among {P1, P2, DG0, DG1, Quadrature_2}, its
  product on B8's twin and ``local_project``, blocked spaces component by
  component;
- ``generate_random_activation`` on DG0 (JAX ``tests/test_stimulation.py``).

The JAX package's mass-lumped L2 transfer from a Quadrature space divides
only the ELL body of its matrix by the lumped weights, not the rows that
spill into its COO tail (``fenicsx_beat_tpu/fem.py:1602``: ``with_values``
keeps the tail): on the unit cube at N=2 its Quadrature_2 -> P2 matrix has
a row summing to 1.51.  The port divides every row; its reference here is
JAX's matrix with the tail divided too (ROADMAP Queue C).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import fenicsx_beat_tpu as jbeat
import fenicsx_beat_tpu_torch as tbeat
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import geometry as jgeo
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import utils as jutils
from fenicsx_beat_tpu.ops import quadrature as jquad
from fenicsx_beat_tpu.ops.sparse import ell_to_stencil as jell_to_stencil
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import geometry as tgeo
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import utils as tutils
from fenicsx_beat_tpu_torch.ops import quadrature as tquad
from fenicsx_beat_tpu_torch.ops.cuda_ell import LONG_ROW, CSRMatrix, csr_spmv
from fenicsx_beat_tpu_torch.ops.sparse import StencilMatrix

RTOL = 1e-12
ELEMENTS = [("P", 1), ("P", 2), ("P", 3), ("DG", 0), ("DG", 1), ("DG", 2), ("Quadrature", 2), ("Quadrature", 4)]
LAGRANGE = [e for e in ELEMENTS if e[0] != "Quadrature"]
TRANSFER = [("P", 1), ("P", 2), ("DG", 0), ("DG", 1), ("Quadrature", 2)]
MESHES = {
    "square3": lambda m: m.create_unit_square(None, 3, 3),
    "cube2": lambda m: m.create_unit_cube(None, 2, 2, 2),
}


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


def meshes(name):
    if name == "slab2d":
        return (jgeo.get_2D_slab_geometry(dx=0.25, Lx=1.0, Ly=0.5).mesh,
                tgeo.get_2D_slab_geometry(dx=0.25, Lx=1.0, Ly=0.5).mesh)
    return MESHES[name](jmesh), MESHES[name](tmesh)


def assert_close(port, ref, rtol=RTOL):
    """Equal within ``rtol`` of the reference's largest magnitude."""
    port, ref = np.asarray(port, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1e-300)
    assert np.abs(port - ref).max(initial=0.0) <= rtol * scale


def dense_jax(A):
    """Dense form of a JAX ELL matrix (its COO tail included)."""
    n, m = A.shape
    D = np.zeros((n, m))
    cols = np.asarray(A.cols)
    np.add.at(D, (np.repeat(np.arange(n), cols.shape[1]), cols.ravel()), np.asarray(A.vals).ravel())
    if A.has_tail:
        np.add.at(D, (np.asarray(A.tail_rows), np.asarray(A.tail_cols)), np.asarray(A.tail_vals))
    return D


def dense_port(A):
    if isinstance(A, CSRMatrix):
        return sp.csr_matrix((A.vals.numpy(), A.cols.numpy(), A.indptr.numpy()), shape=A.shape).toarray()
    return dense_jax(A)


def jax_transfer_dense(Vs, Vt):
    """JAX's transfer matrix, dense; a lumped L2 transfer's tail rows
    divided by their lumped weights as its body's are (the docstring's
    reference fault)."""
    T = jfem.build_transfer_matrix(Vs, Vt)
    D = dense_jax(T)
    if Vs.element.family == "Quadrature" and T.has_tail:
        pts, wts = jquad.simplex_rule(Vs.mesh.tdim, Vs.element.degree)
        geom = jfem.cell_geometry(Vs.mesh)
        W = (geom.volume * np.prod(np.arange(1, Vs.mesh.tdim + 1)))[:, None] * wts[None, :]
        den = np.zeros(Vt.ndofs)
        np.add.at(den, Vt.cell_dofs.ravel(), np.einsum("cq,qd->cd", W, Vt.element.tabulate(Vs.mesh.tdim, pts)).ravel())
        rows, cols = np.asarray(T.tail_rows), np.asarray(T.tail_cols)
        np.add.at(D, (rows, cols), np.asarray(T.tail_vals) * (1.0 / den[rows] - 1.0))
    return D


@pytest.mark.parametrize("tdim", [2, 3])
@pytest.mark.parametrize("degree", [2, 4, 8])
def test_simplex_rule_matches_jax(tdim, degree):
    jp, jw = jquad.simplex_rule(tdim, degree)
    tp, tw = tquad.simplex_rule(tdim, degree)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("shape", [None, (2,), (3,)])
@pytest.mark.parametrize("element", ELEMENTS, ids=lambda e: f"{e[0]}{e[1]}")
@pytest.mark.parametrize("mesh_name", ["square3", "cube2", "slab2d"])
def test_space_matches_jax(mesh_name, element, shape):
    jm, tm = meshes(mesh_name)
    jV, tV = jfem.functionspace(jm, element, shape=shape), tfem.functionspace(tm, element, shape=shape)
    assert tV.ndofs == jV.ndofs and tV.block_size == jV.block_size and tV.value_shape == jV.value_shape
    np.testing.assert_array_equal(tV.cell_dofs, jV.cell_dofs)
    np.testing.assert_array_equal(tV.dof_owner_cell, jV.dof_owner_cell)
    assert_close(tV.dof_coords, jV.dof_coords)
    assert tV.scalar_space.ndofs == jV.scalar_space.ndofs
    assert (tV.element.family_name, tV.element.discontinuous) == (jV.element.family_name, jV.element.discontinuous)


@pytest.mark.parametrize("tdim", [2, 3])
@pytest.mark.parametrize("element", LAGRANGE + [("P", 4), ("DG", 3)], ids=lambda e: f"{e[0]}{e[1]}")
def test_tabulation_matches_jax(element, tdim):
    rng = np.random.default_rng(12)
    pts = rng.dirichlet(np.ones(tdim + 1), size=17)[:, 1:]
    jel, tel = jfem.Element(*element), tfem.Element(*element)
    assert tel.ndofs_per_cell(tdim) == jel.ndofs_per_cell(tdim)
    assert_close(tel.dof_ref_points(tdim), jel.dof_ref_points(tdim))
    assert_close(tel.tabulate(tdim, pts), jel.tabulate(tdim, pts))
    assert_close(tel.tabulate_grad(tdim, pts), jel.tabulate_grad(tdim, pts))
    tV = tfem.functionspace(meshes("cube2" if tdim == 3 else "square3")[1], element)
    assert_close(tutils.interpolation_points(tV), jel.dof_ref_points(tdim))


@pytest.mark.parametrize("tdim, gdim", [(1, 2), (2, 3), (1, 3)])
def test_embedded_cell_geometry_matches_jax(tdim, gdim):
    rng = np.random.default_rng(3)
    coords = rng.standard_normal((9, gdim))
    cells = np.array([rng.choice(9, tdim + 1, replace=False) for _ in range(7)], dtype=np.int32)
    ct = {1: "interval", 2: "triangle"}[tdim]
    jm = jmesh.Mesh(coords=coords, cells=cells, cell_type=getattr(jmesh.CellType, ct))
    tm = tmesh.Mesh(coords=coords.copy(), cells=cells.copy(), cell_type=getattr(tmesh.CellType, ct))
    jg, tg = jfem.cell_geometry(jm), tfem.cell_geometry(tm)
    for name in ("edges", "volume", "grads", "inv_edges"):
        assert_close(getattr(tg, name), getattr(jg, name))


def conductivities(mesh, kind):
    if kind == "scalar":
        return 0.37
    rng = np.random.default_rng(5)
    g = mesh.gdim
    L = rng.standard_normal((mesh.num_cells, g, g))
    return np.einsum("cij,ckj->cik", L, L) + 0.1 * np.eye(g)


@pytest.mark.parametrize("kind", ["scalar", "anisotropic"])
@pytest.mark.parametrize("element", LAGRANGE, ids=lambda e: f"{e[0]}{e[1]}")
@pytest.mark.parametrize("mesh_name", ["square3", "cube2"])
def test_mass_stiffness_match_jax(mesh_name, element, kind):
    jm, tm = meshes(mesh_name)
    jV, tV = jfem.functionspace(jm, element), tfem.functionspace(tm, element)
    M = conductivities(tm, kind)
    jr, tr = jfem.assemble_mass_stiffness_coo(jV, M), tfem.assemble_mass_stiffness_coo(tV, M)
    for k in (2, 3):
        jd = sp.coo_matrix((jr[k], (jr[0], jr[1])), shape=jr[4]).toarray()
        assert_close(sp.coo_matrix((tr[k], (tr[0], tr[1])), shape=tr[4]).toarray(), jd)
        assert_close(dense_port(tfem.assemble_mass_stiffness(tV, M)[k - 2]), jd)
    # the route: JAX's BaseModel takes the ELL pair, or its stencil form
    jmass, jstiff = jfem.assemble_mass_stiffness(jV, M)
    jst = (jell_to_stencil(jmass), jell_to_stencil(jstiff))
    jax_stencil = None not in jst and jst[0].offsets == jst[1].offsets
    tmass, _ = tfem.assemble_mass_stiffness_auto(tV, M)
    assert isinstance(tmass, StencilMatrix) == jax_stencil


def test_route_and_csr_packing_of_p2():
    """P2 operators stay ELL (their rows hold 10-65 entries, no global
    stencil), pack into one CSR group equal to the sorting path's, and the
    theta system runs the unstructured branch; P1 on the same mesh is a
    stencil."""
    from fenicsx_beat_tpu_torch.benchmarks.niederer import niederer_setup
    from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors
    from fenicsx_beat_tpu_torch.ops.cuda_ell import _pack_ell_group
    from fenicsx_beat_tpu_torch.ops.sparse import operator_to_csr
    from fenicsx_beat_tpu_torch.theta_system import ThetaSystem

    mesh, M, _, _ = niederer_setup(1.0)
    Mc = as_cell_tensors(M, mesh)
    mass, stiff = tfem.assemble_mass_stiffness_auto(tfem.functionspace(mesh, ("P", 2)), Mc)
    assert not isinstance(mass, StencilMatrix)
    assert isinstance(tfem.assemble_mass_stiffness_auto(tfem.functionspace(mesh, ("P", 1)), Mc)[0], StencilMatrix)
    pair = CSRMatrix.from_operator_pair(mass, stiff)
    assert _pack_ell_group((mass, stiff)) is not None  # no COO tail: read in place
    generic = CSRMatrix.from_operator_pair(operator_to_csr(mass), operator_to_csr(stiff))
    for A, B in zip(pair, generic):
        for name in ("indptr", "cols", "vals", "diag", "long_rows"):
            assert torch.equal(getattr(A, name), getattr(B, name)), name
    system = ThetaSystem(mass, stiff, 1.0, 0.5, 1e-8, 1e-12, 100, torch.device("cpu"), torch.float64)
    assert not system.structured and system.mass.long_rows.numel() > 0


def test_pde_assembly_raises_as_in_jax():
    jm, tm = meshes("square3")
    for el, shape, msg in ((("Quadrature", 2), None, "Quadrature"), (("P", 1), (2,), "blocked")):
        for fem_, m in ((jfem, jm), (tfem, tm)):
            with pytest.raises(NotImplementedError, match=msg):
                fem_.assemble_mass_stiffness(fem_.functionspace(m, el, shape=shape), 1.0)
        with pytest.raises(NotImplementedError, match=msg):
            tfem.assemble_mass_stiffness_auto(tfem.functionspace(tm, el, shape=shape), 1.0)


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("mesh_name", ["square3", "cube2"])
def test_facets_and_bcs_match_jax(mesh_name, degree):
    jm, tm = meshes(mesh_name)
    jV, tV = jfem.functionspace(jm, ("P", degree)), tfem.functionspace(tm, ("P", degree))
    facets = tm.exterior_facets()
    np.testing.assert_array_equal(facets, jm.exterior_facets())
    fverts = tm.entities(tm.tdim - 1)[facets]
    np.testing.assert_array_equal(tfem._facet_dofs(tV, fverts), jfem._facet_dofs(jV, fverts))
    for dim in (0, 1, tm.tdim - 1):
        ents = np.arange(0, tm.num_entities(dim), 3)
        np.testing.assert_array_equal(tfem.locate_dofs_topological(tV, dim, ents),
                                      jfem.locate_dofs_topological(jV, dim, ents))
    jq, tq = jfem.facet_quadrature(jV, facets, degree=4), tfem.facet_quadrature(tV, facets, degree=4)
    for name in ("X", "W", "N"):
        assert_close(getattr(tq, name), np.asarray(getattr(jq, name)))
    np.testing.assert_array_equal(tq.dofs, np.asarray(jq.dofs))
    assert_close(tq.assemble_load_host(), jq.assemble_load_host())


@pytest.mark.parametrize("element", [("P", 1), ("P", 2), ("P", 3), ("DG", 0), ("DG", 1)], ids=lambda e: f"{e[0]}{e[1]}")
@pytest.mark.parametrize("mesh_name", ["square3", "cube2"])
def test_point_evaluation_matches_jax(mesh_name, element):
    jm, tm = meshes(mesh_name)
    rng = np.random.default_rng(7)
    jV, tV = jfem.functionspace(jm, element), tfem.functionspace(tm, element)
    # random points, and mesh vertices and edge midpoints (points on shared faces)
    pts = np.concatenate([rng.uniform(0, 1, (6, tm.gdim)), tm.coords[::4], tm.coords[tm.entities(1)[::5]].mean(axis=1)])
    jd, jw = jfem.point_evaluation_tables(jV, pts)
    td, tw = tfem.point_evaluation_tables(tV, pts)
    np.testing.assert_array_equal(td, jd)
    assert_close(tw, jw)
    vals = rng.standard_normal(tV.ndofs)
    ju, tu = jfem.Function(jV), tfem.Function(tV)
    ju.x.array[:] = vals
    tu.x.array[:] = vals
    assert_close(tu.eval(pts), ju.eval(pts))
    # blocked: component by component
    jB, tB = jfem.functionspace(jm, element, shape=(2,)), tfem.functionspace(tm, element, shape=(2,))
    jb, tb = jfem.Function(jB), tfem.Function(tB)
    bvals = rng.standard_normal(tB.ndofs)
    jb.x.array[:] = bvals
    tb.x.array[:] = bvals
    assert_close(tfem.evaluate_function(tb, pts), jfem.evaluate_function(jb, pts))


@pytest.mark.parametrize("target", TRANSFER, ids=lambda e: f"{e[0]}{e[1]}")
@pytest.mark.parametrize("source", TRANSFER, ids=lambda e: f"{e[0]}{e[1]}")
@pytest.mark.parametrize("mesh_name", ["square3", "cube2"])
def test_transfer_matches_jax(mesh_name, source, target):
    """T, its product on B8's twin (``Function.interpolate``) and
    ``local_project`` against JAX's, on seeded source values."""
    jm, tm = meshes(mesh_name)
    jVs, jVt = jfem.functionspace(jm, source), jfem.functionspace(jm, target)
    tVs, tVt = tfem.functionspace(tm, source), tfem.functionspace(tm, target)
    if source == target == ("Quadrature", 2):  # no pointwise basis to evaluate, in either package
        for fem_, Vs, Vt in ((jfem, jVs, jVt), (tfem, tVs, tVt)):
            with pytest.raises(TypeError, match="no pointwise basis"):
                fem_.build_transfer_matrix(Vs, Vt)
        return
    T = tfem.build_transfer_matrix(tVs, tVt)
    assert T.shape == (tVt.ndofs, tVs.ndofs) and tfem.build_transfer_matrix(tVs, tVt) is T
    D = jax_transfer_dense(jVs, jVt)
    assert_close(dense_port(T), D)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(tVs.ndofs)
    ju, tu = jfem.Function(jVs), tfem.Function(tVs)
    ju.x.array[:] = x
    tu.x.array[:] = x
    tv = tfem.Function(tVt)
    tv.interpolate(tu, device="cpu")
    assert_close(tv.x.array, D @ x)
    jp = jutils.local_project(ju, jVt)
    tp = tutils.local_project(tu, tVt, device="cpu")
    ref = jp.x.array if not (source[0] == "Quadrature" and jfem.build_transfer_matrix(jVs, jVt).has_tail) else D @ x
    assert_close(tp.x.array, ref)


@pytest.mark.parametrize("bs", [2, 3])
def test_blocked_interpolation_matches_jax(bs):
    jm, tm = meshes("cube2")
    rng = np.random.default_rng(2)
    src = rng.standard_normal(tfem.functionspace(tm, ("P", 2), shape=(bs,)).ndofs)
    out = {}
    for side, fem_, m, kw in (("jax", jfem, jm, {}), ("port", tfem, tm, {"device": "cpu"})):
        u = fem_.Function(fem_.functionspace(m, ("P", 2), shape=(bs,)))
        u.x.array[:] = src
        v = fem_.Function(fem_.functionspace(m, ("DG", 1), shape=(bs,)))
        v.interpolate(u, **kw)
        w = fem_.Function(fem_.functionspace(m, ("P", 1), shape=(bs,)))
        w.interpolate(lambda x: np.stack([x[0] + k * x[1] for k in range(bs)]))
        out[side] = (v.x.array.copy(), w.x.array.copy())
    for a, b in zip(out["port"], out["jax"]):
        assert_close(a, b)
    with pytest.raises(ValueError, match="component"):
        tfem.Function(tfem.functionspace(tm, ("P", 1))).interpolate(
            tfem.Function(tfem.functionspace(tm, ("P", 1), shape=(bs,))), device="cpu")


@pytest.mark.parametrize("space", ["P_2", "DG_1", "Quadrature_4", "CG_3", "dP_0"])
@pytest.mark.parametrize("dim", [1, 3])
def test_space_from_string_matches_jax(space, dim):
    jm, tm = meshes("cube2")
    jV, tV = jutils.space_from_string(space, jm, dim=dim), tutils.space_from_string(space, tm, dim=dim)
    assert (tV.ndofs, tV.block_size) == (jV.ndofs, jV.block_size)
    assert (tV.element.family, tV.element.degree) == (jV.element.family, jV.element.degree)
    np.testing.assert_array_equal(tV.cell_dofs, jV.cell_dofs)


def test_transfer_with_long_rows_is_one_csr_group():
    """Quadrature_2 -> P1 on the unit cube: rows of up to 8 x 24 entries,
    beyond B8's LONG_ROW, found from indptr; P1 -> Quadrature_2 has 4 a row
    and no long row; the transfer operator is kept per device and dtype."""
    _, tm = meshes("cube2")
    Q, P = tfem.functionspace(tm, ("Quadrature", 2)), tfem.functionspace(tm, ("P", 1))
    TqP, TPq = tfem.build_transfer_matrix(Q, P), tfem.build_transfer_matrix(P, Q)
    assert TqP.long_rows.numel() > 0 and int(TqP.long_rows.max()) < P.ndofs
    assert int(np.diff(TqP.indptr.numpy()).max()) > LONG_ROW
    assert TPq.long_rows.numel() == 0 and int(np.diff(TPq.indptr.numpy()).max()) == 4
    d = tfem.transfer_operator(Q, P, torch.device("cpu"), torch.float32)
    assert d.vals.dtype == torch.float32 and tfem.transfer_operator(Q, P, torch.device("cpu"), torch.float32) is d
    x = torch.ones(Q.ndofs, dtype=torch.float64)
    np.testing.assert_allclose(csr_spmv(TqP, x).numpy(), 1.0, rtol=1e-13)  # lumped L2 keeps constants


def test_2d_slab_geometry_matches_jax():
    for kw in ({}, {"dx": 0.2, "Lx": 2.0, "Ly": 0.6, "transverse": True}):
        jg, tg = jgeo.get_2D_slab_geometry(**kw), tgeo.get_2D_slab_geometry(**kw)
        np.testing.assert_array_equal(tg.mesh.coords, jg.mesh.coords)
        np.testing.assert_array_equal(tg.mesh.cells, jg.mesh.cells)
        np.testing.assert_array_equal(tg.f0, jg.f0)
        np.testing.assert_array_equal(tg.s0, jg.s0)
        assert tg.n0 is None and jg.n0 is None
    np.testing.assert_array_equal(tgeo.get_2D_slab_mesh(dx=0.5).cells, jgeo.get_2D_slab_mesh(dx=0.5).cells)


def test_random_activation_on_dg0_as_in_jax():
    """JAX ``tests/test_stimulation.py:206-235`` on the port: the pattern
    interpolated into DG0 at the cell midpoints, on and off in time, equal
    to JAX's field."""
    points = np.array([[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]])
    delays = np.array([1.0, 3.0])
    fields = {}
    for side, pkg, fem_, mm in (("jax", jbeat, jfem, jmesh), ("port", tbeat, tfem, tmesh)):
        domain = mm.create_unit_cube(None, 4, 4, 4)
        expr = pkg.stimulation.generate_random_activation(
            mesh=domain, time=fem_.Constant(0.0), points=points, delays=delays, stim_start=0.0,
            stim_duration=1.0, stim_amplitude=5.0, tol=0.2)
        f = fem_.Function(fem_.functionspace(domain, ("DG", 0)))
        rows = []
        for t in (0.5, 1.5, 3.5, 4.5):
            f.interpolate(lambda x: np.asarray(expr(x, t)))
            rows.append(f.x.array.copy())
        fields[side] = np.array(rows)
    np.testing.assert_array_equal(fields["port"], fields["jax"])
    assert np.all(fields["port"][0] == 0.0) and fields["port"][1].max() == 5.0 and fields["port"][1].min() == 0.0
