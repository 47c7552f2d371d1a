"""The port's ``io.py`` against the JAX package's on the same files.

- ``read_msh`` on JAX's ``tests/test_io.py`` files (ASCII 2.2 and 4.1,
  binary 4.1, physical names) and on tetrahedral files written by
  ``chip_smoke.py``'s binary 4.1 writer and an ASCII twin of it: the same
  coordinates, cells, cell tags and facet tags in both packages, and the
  arrays written; the embedded-surface and binary-2.2 refusals in both.
- ``VTUWriter``: the same bytes as JAX's writer for the same mesh and
  float32 values (numpy arrays and torch tensors, one field, several, a
  vector field), the ``.pvd`` too.
- ``write_mesh``/``read_mesh`` and checkpoints cross between the packages.
"""

import numpy as np
import pytest
import torch
from test_io import MSH22, MSH22_NAMED, MSH41, _msh41_binary_bytes

from chip_smoke import write_msh41_binary
from fenicsx_beat_tpu import io as jio
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu_torch import io as tio
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab_tags():
    """A 3-D slab with two cell tags in runs along the cell order."""
    m = get_3D_slab_geometry(None, dx=0.5, Lx=3.0, Ly=1.5, Lz=1.0).mesh
    x = m.coords[m.cells].mean(axis=1)
    return m, np.where(x[:, 0] < 1.2, 7, 3).astype(np.int32)


def _msh41_ascii_tets(coords, cells, tags) -> str:
    """ASCII twin of ``write_msh41_binary``: one volume entity per tag, a
    block for each run of equal tags."""
    vals = sorted(set(int(t) for t in tags))
    ent = {v: k + 1 for k, v in enumerate(vals)}
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities", f"0 0 0 {len(vals)}"]
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    for v in vals:
        lines.append(f"{ent[v]} {' '.join(map(repr, [*lo, *hi]))} 1 {v} 0")
    lines += ["$EndEntities", "$Nodes", f"1 {len(coords)} 1 {len(coords)}", f"3 1 0 {len(coords)}"]
    lines += [str(i + 1) for i in range(len(coords))]
    lines += [" ".join(repr(float(c)) for c in xyz) for xyz in coords]
    starts = np.flatnonzero(np.r_[True, tags[1:] != tags[:-1]])
    ends = np.r_[starts[1:], len(tags)]
    lines += ["$EndNodes", "$Elements", f"{len(starts)} {len(cells)} 1 {len(cells)}"]
    for a, b in zip(starts, ends):
        lines.append(f"3 {ent[int(tags[a])]} 4 {b - a}")
        lines += [" ".join(map(str, [c + 1, *(cells[c] + 1)])) for c in range(a, b)]
    lines += ["$EndElements", ""]
    return "\n".join(lines)


def _write(tmp_path, name):
    p = tmp_path / f"{name}.msh"
    if name == "msh22":
        p.write_text(MSH22)
    elif name == "msh41":
        p.write_text(MSH41)
    elif name == "msh41_binary":
        p.write_bytes(_msh41_binary_bytes())
    elif name == "named":
        p.write_text(MSH22_NAMED)
    else:
        m, tags = _slab_tags()
        if name == "tets_binary":
            write_msh41_binary(p, m.coords, m.cells, tags)
        else:
            p.write_text(_msh41_ascii_tets(m.coords, m.cells, tags))
    return p


@pytest.mark.parametrize("name", ["msh22", "msh41", "msh41_binary", "named", "tets_binary", "tets_ascii"])
def test_read_msh_matches_jax(name, tmp_path):
    p = _write(tmp_path, name)
    (tm, tct, tft), (jm, jct, jft) = tio.read_msh(p), jio.read_msh(p)
    for a, b in ((tm.coords, jm.coords), (tm.cells, jm.cells)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tm.cell_type.name == jm.cell_type.name
    for t, j in ((tct, jct), (tft, jft)):
        assert (t is None) == (j is None)
        if t is not None:
            assert t.dim == j.dim
            np.testing.assert_array_equal(t.indices, j.indices)
            np.testing.assert_array_equal(t.values, j.values)
    if "binary" not in name:  # $PhysicalNames is read from ASCII files
        assert tio.read_msh_physical_names(p) == jio.read_msh_physical_names(p)
    if name.startswith("tets"):  # the file gives back what was written, exactly
        m, tags = _slab_tags()
        np.testing.assert_array_equal(tm.coords, m.coords)
        np.testing.assert_array_equal(tm.cells, m.cells)
        np.testing.assert_array_equal(tct.indices, np.arange(m.num_cells))
        np.testing.assert_array_equal(tct.values, tags)
        assert tft is None


@pytest.mark.parametrize("bad", ["embedded_surface", "binary_v22", "not_msh"])
def test_read_msh_refusals_match_jax(bad, tmp_path):
    p = tmp_path / "bad.msh"
    if bad == "embedded_surface":
        p.write_text(MSH22_NAMED.replace("3 1 1 0", "3 1 1 0.3"))
        err, match = NotImplementedError, "embedded"
    elif bad == "binary_v22":
        p.write_bytes(b"$MeshFormat\n2.2 1 8\n" + b"\x01\x00\x00\x00" + b"\n$EndMeshFormat\n")
        err, match = ValueError, "binary .msh v2.2"
    else:
        p.write_text("hello\n")
        err, match = ValueError, "MeshFormat"
    for read in (tio.read_msh, jio.read_msh):
        with pytest.raises(err, match=match):
            read(p)


@pytest.mark.parametrize("kind", ["numpy", "tensor", "fields", "vector", "triangles"])
def test_vtu_bytes_equal_jax(kind, tmp_path):
    if kind == "triangles":
        tm, jm = tmesh.create_unit_square(None, 4, 3), jmesh.create_unit_square(None, 4, 3)
    else:
        tm = _slab_tags()[0]
        jm = jmesh.Mesh(coords=tm.coords, cells=tm.cells, cell_type=jmesh.CellType.tetrahedron)
    n = tm.num_vertices
    rng = np.random.default_rng(4)
    v = rng.uniform(-85.0, 40.0, n).astype(np.float32)
    frames = {
        "numpy": (v, v),
        "tensor": (torch.from_numpy(v), v),
        "fields": ({"v": torch.from_numpy(v), "s": v * 2}, {"v": v, "s": v * 2}),
        "vector": ({"f0": rng.standard_normal((n, 3))}, None),
        "triangles": (v, v),
    }[kind]
    t_frame, j_frame = frames
    if j_frame is None:
        j_frame = t_frame
    tw, jw = tio.VTUWriter(tmp_path / "t", tm), jio.VTUWriter(tmp_path / "j", jm)
    for t in (0.0, 1.5):
        tw.write(t, t_frame)
        jw.write(t, j_frame)
    tp, jp = tw.close(), jw.close()
    assert tp.read_bytes() == jp.read_bytes()
    for f in ("frame_000000.vtu", "frame_000001.vtu"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_mesh_files_cross(tmp_path):
    m = tmesh.create_unit_square(None, 3, 2)
    for write, read in ((tio.write_mesh, jio.read_mesh), (jio.write_mesh, tio.read_mesh)):
        src = m if write is tio.write_mesh else jmesh.create_unit_square(None, 3, 2)
        m2 = read(write(tmp_path / f"m_{write.__module__}.npz", src))
        np.testing.assert_array_equal(m2.coords, m.coords)
        np.testing.assert_array_equal(m2.cells, m.cells)
        assert m2.cell_type.name == m.cell_type.name


def test_checkpoints_cross(tmp_path):
    tm, jm = tmesh.create_unit_square(None, 4, 4), jmesh.create_unit_square(None, 4, 4)
    for writer, mesh, load in ((tio.CheckpointWriter, tm, jio.load_checkpoint),
                               (jio.CheckpointWriter, jm, tio.load_checkpoint)):
        path = tmp_path / f"run_{writer.__module__}"
        with writer(path, mesh) as w:
            for k in range(3):
                w.write(0.5 * k, np.full(mesh.num_vertices, float(k)))
        data = load(path)
        assert data.times.tolist() == [0.0, 0.5, 1.0] and data.cell_type == "triangle"
        np.testing.assert_array_equal(data.values[2], 2.0)
        np.testing.assert_array_equal(data.cells, tm.cells)
    with tio.CheckpointWriter(tmp_path / "tensor", tm) as w:  # a tensor snapshot is read back to the host
        w.write(0.0, torch.arange(tm.num_vertices, dtype=torch.float64))
    np.testing.assert_array_equal(jio.load_checkpoint(tmp_path / "tensor").values[0], np.arange(tm.num_vertices))
