"""Host layer of the PyTorch port against the JAX package (numpy, f64).

Mesh, geometry, conductivities, stencil operator values, the stimulus
unit load and the probe tables of the Niederer slab at dx=1.0.  Integer
arrays must be equal.  Float arrays agree within rtol 1e-12 plus an
absolute floor of 1e-12 * max|value|: the port takes the numpy branches
where the JAX package may use its native C++ kit, so entries near zero
can differ in summation order.
"""

import numpy as np
import pytest

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu.conductivities import as_cell_tensors as j_cell_tensors
from fenicsx_beat_tpu.conductivities import default_conductivities as j_default_cond
from fenicsx_beat_tpu.conductivities import define_conductivity_tensor as j_cond_tensor
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as j_slab
from fenicsx_beat_tpu.mesh import locate_entities as j_locate
from fenicsx_beat_tpu.mesh import meshtags as j_meshtags
from fenicsx_beat_tpu.stimulation import define_stimulus as j_define_stimulus
from fenicsx_beat_tpu.units import ureg as j_ureg
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors as t_cell_tensors
from fenicsx_beat_tpu_torch.conductivities import default_conductivities as t_default_cond
from fenicsx_beat_tpu_torch.conductivities import define_conductivity_tensor as t_cond_tensor
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry as t_slab
from fenicsx_beat_tpu_torch.mesh import locate_entities as t_locate
from fenicsx_beat_tpu_torch.mesh import meshtags as t_meshtags
from fenicsx_beat_tpu_torch.stimulation import define_stimulus as t_define_stimulus
from fenicsx_beat_tpu_torch.units import ureg as t_ureg

DX = 1.0
SLAB = dict(dx=DX, Lx=20.0, Ly=7.0, Lz=3.0)


def assert_close_floor(actual, desired, rtol=1e-12):
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    floor = 1e-12 * max(np.abs(desired).max(), 1e-300)
    np.testing.assert_allclose(actual, desired, rtol=rtol, atol=floor)


def _s1(mesh, locate):
    L, tol = 1.5, 1e-10
    return locate(
        mesh, mesh.tdim,
        lambda x: np.logical_and(np.logical_and(x[0] <= L + tol, x[1] <= L + tol), x[2] <= L + tol),
    )


@pytest.fixture(scope="module")
def slabs():
    return j_slab(None, **SLAB), t_slab(None, **SLAB)


def test_mesh_and_geometry_equal(slabs):
    jg, tg = slabs
    np.testing.assert_array_equal(tg.mesh.cells, jg.mesh.cells)
    np.testing.assert_array_equal(tg.mesh.coords, jg.mesh.coords)
    assert tg.mesh.num_vertices == 21 * 8 * 4
    for name in ("f0", "s0", "n0"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))


@pytest.mark.parametrize("dim", [1, 2])
def test_mesh_entities_equal(slabs, dim):
    """Edge and face enumeration: numpy unique rows vs the native kit."""
    jg, tg = slabs
    np.testing.assert_array_equal(tg.mesh.entities(dim), jg.mesh.entities(dim))


def test_s1_cells_equal(slabs):
    jg, tg = slabs
    np.testing.assert_array_equal(_s1(tg.mesh, t_locate), _s1(jg.mesh, j_locate))


def test_conductivity_tensors_equal(slabs):
    jg, tg = slabs
    jc, tc = j_default_cond("Niederer"), t_default_cond("Niederer")
    jM = j_cell_tensors(j_cond_tensor(f0=jg.f0, **jc), jg.mesh)
    tM = t_cell_tensors(t_cond_tensor(f0=tg.f0, **tc), tg.mesh)
    np.testing.assert_array_equal(tM, jM)
    assert t_ureg("uF/cm**2").to("uF/mm**2").magnitude == j_ureg("uF/cm**2").to("uF/mm**2").magnitude


def test_stencil_operators_match(slabs):
    jg, tg = slabs
    jM = j_cell_tensors(j_cond_tensor(f0=jg.f0, **j_default_cond("Niederer")), jg.mesh)
    tM = t_cell_tensors(t_cond_tensor(f0=tg.f0, **t_default_cond("Niederer")), tg.mesh)
    jmass, jstiff = jfem.assemble_mass_stiffness_stencil(jfem.functionspace(jg.mesh, ("P", 1)), jM)
    tmass, tstiff = tfem.assemble_mass_stiffness_stencil(tfem.functionspace(tg.mesh, ("P", 1)), tM)
    assert tmass.offsets == jmass.offsets and tstiff.offsets == jstiff.offsets
    assert len(tmass.offsets) == 15
    assert_close_floor(tmass.vals.numpy(), np.asarray(jmass.vals))
    assert_close_floor(tstiff.vals.numpy(), np.asarray(jstiff.vals))


def test_stimulus_unit_load_matches(slabs):
    jg, tg = slabs
    chi_j = j_default_cond("Niederer")["chi"]
    chi_t = t_default_cond("Niederer")["chi"]
    js = j_define_stimulus(
        mesh=jg.mesh, chi=chi_j, time=jfem.Constant(0.0),
        subdomain_data=j_meshtags(jg.mesh, 3, _s1(jg.mesh, j_locate), 1), marker=1,
        mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    ts = t_define_stimulus(
        mesh=tg.mesh, chi=chi_t, time=tfem.Constant(0.0),
        subdomain_data=t_meshtags(tg.mesh, 3, _s1(tg.mesh, t_locate), 1), marker=1,
        mesh_unit="mm", amplitude=50_000.0, duration=2.0,
    )
    assert ts.expr.amplitude == js.expr.amplitude
    assert (ts.expr.start, ts.expr.duration) == (js.expr.start, js.expr.duration)
    jq = jfem.cell_quadrature(jfem.functionspace(jg.mesh, ("P", 1)), js.dz.entities(), degree=4)
    tq = tfem.cell_quadrature(tfem.functionspace(tg.mesh, ("P", 1)), ts.dz.entities(), degree=4)
    np.testing.assert_array_equal(tq.dofs, np.asarray(jq.dofs))
    assert_close_floor(tq.assemble_load_host(), jq.assemble_load_host())


def test_probe_tables_match(slabs):
    jg, tg = slabs
    pts = np.array(list(jnied.benchmark_points().values()))
    assert np.array_equal(pts, np.array(list(tnied.benchmark_points().values())))
    jd, jw = jfem.point_evaluation_tables(jfem.functionspace(jg.mesh, ("P", 1)), pts)
    td, tw = tfem.point_evaluation_tables(tfem.functionspace(tg.mesh, ("P", 1)), pts)
    np.testing.assert_array_equal(td, np.asarray(jd))
    assert_close_floor(tw, np.asarray(jw))


def test_published_table_carried_over():
    assert tnied.PUBLISHED_ACTIVATION_TIMES == jnied.PUBLISHED_ACTIVATION_TIMES
    assert tnied.POINT_NAMES == jnied.POINT_NAMES


def test_unported_elements_raise(slabs):
    """P2 and DG0 spaces on the slab are the JAX package's; what raises is
    what JAX raises: PDE assembly on Quadrature and blocked spaces."""
    jg, tg = slabs
    for el in (("P", 2), ("DG", 0)):
        tV, jV = tfem.functionspace(tg.mesh, el), jfem.functionspace(jg.mesh, el)
        assert tV.ndofs == jV.ndofs
        np.testing.assert_array_equal(tV.cell_dofs, jV.cell_dofs)
    with pytest.raises(NotImplementedError, match="Quadrature"):
        tfem.assemble_mass_stiffness(tfem.functionspace(tg.mesh, ("Quadrature", 2)), 1.0)
    with pytest.raises(NotImplementedError, match="blocked"):
        tfem.assemble_mass_stiffness(tfem.functionspace(tg.mesh, ("P", 1, (3,))), 1.0)
