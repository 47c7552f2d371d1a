"""Checkpoints, ParaView output and mesh files.

Port of ``fenicsx_beat_tpu/io.py``:

* :class:`CheckpointWriter` / :func:`load_checkpoint`: ``(t, values)``
  snapshots with the mesh arrays in one compressed ``.npz`` (``times``,
  ``values`` as float32, ``coords``, ``cells``, ``cell_type`` by name);
* :class:`VTUWriter`: a VTU (XML unstructured grid) file a frame and a
  ``.pvd`` collection that ParaView reads, from numpy arrays or torch
  tensors on any device;
* :func:`read_msh`: Gmsh ``.msh`` files, ASCII 2.2 and 4.1 and binary 4.1,
  into ``(mesh, cell_tags, facet_tags)``; :func:`read_msh_physical_names`;
* :func:`write_mesh` / :func:`read_mesh`: a mesh alone as ``.npz``.

Every file has the JAX package's layout, byte for byte where the writer is
deterministic (the VTU), so each package reads what the other writes.
"""

from __future__ import annotations

import base64
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .mesh import CellType, Mesh, MeshTags, _row_searchsorted

__all__ = [
    "CheckpointWriter",
    "CheckpointData",
    "load_checkpoint",
    "VTUWriter",
    "read_msh",
    "read_msh_physical_names",
    "read_mesh",
    "write_mesh",
]


class CheckpointData(NamedTuple):
    times: np.ndarray  # [nt]
    values: np.ndarray  # [nt, ndofs]
    coords: np.ndarray
    cells: np.ndarray
    cell_type: str


@dataclass
class CheckpointWriter:
    """Accumulates ``(t, dof-array)`` snapshots; :meth:`save` writes one npz."""

    path: str | Path
    mesh: Mesh

    def __post_init__(self):
        self._times: list[float] = []
        self._values: list[np.ndarray] = []

    def write(self, t: float, values: np.ndarray) -> None:
        self._times.append(float(t))
        self._values.append(_host_f32(values).copy())

    def save(self) -> Path:
        path = Path(self.path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            times=np.asarray(self._times),
            values=np.stack(self._values) if self._values else np.zeros((0, 0)),
            coords=self.mesh.coords,
            cells=self.mesh.cells,
            cell_type=self.mesh.cell_type.name,
        )
        return path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.save()
        return False


def load_checkpoint(path: str | Path) -> CheckpointData:
    with np.load(Path(path).with_suffix(".npz"), allow_pickle=False) as f:
        return CheckpointData(
            times=f["times"],
            values=f["values"],
            coords=f["coords"],
            cells=f["cells"],
            cell_type=str(f["cell_type"]),
        )


_VTK_CELL_TYPES = {
    CellType.interval: 3,  # VTK_LINE
    CellType.triangle: 5,  # VTK_TRIANGLE
    CellType.tetrahedron: 10,  # VTK_TETRA
}


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def _host_f32(v) -> np.ndarray:
    """A field as a float32 host array (a torch tensor on any device, or
    anything numpy reads)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


class VTUWriter:
    """Writes a ParaView-readable time series: one .vtu per frame + .pvd
    (the JAX package's ``io.py:106-195``, byte for byte)."""

    def __init__(self, path: str | Path, mesh: Mesh, name: str = "v"):
        self.base = Path(path)
        self.base.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self.name = name
        self._frames: list[tuple[float, str]] = []

    def write(self, t: float, values) -> None:
        """Write one frame. ``values`` is a dof array (named ``self.name``)
        or a dict ``{field_name: dof_array}`` of point-data fields; a
        torch tensor is read back from its device."""
        mesh = self.mesh
        n_pts, n_cells = mesh.num_vertices, mesh.num_cells
        coords3 = np.zeros((n_pts, 3), dtype=np.float32)
        coords3[:, : mesh.gdim] = mesh.coords
        conn = mesh.cells.astype(np.int32)
        offsets = (np.arange(1, n_cells + 1) * conn.shape[1]).astype(np.int32)
        ctype = np.full(n_cells, _VTK_CELL_TYPES[mesh.cell_type], dtype=np.uint8)
        if not isinstance(values, dict):
            values = {self.name: values}
        fields = {k: _host_f32(v) for k, v in values.items()}
        scalars = next(iter(fields))

        def _array_xml(k, v):
            # [n_pts, ncomp] (or flat n_pts*ncomp from a blocked Function)
            # becomes a multi-component DataArray (vector fields: fibers)
            ncomp = v.shape[1] if v.ndim == 2 else v.size // n_pts
            comp_attr = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
            return (
                f'    <DataArray type="Float32" Name="{k}"{comp_attr} '
                f'format="binary">{_b64(v)}</DataArray>'
            )

        point_data = "\n".join(_array_xml(k, v) for k, v in fields.items())

        fname = f"frame_{len(self._frames):06d}.vtu"
        xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
 <UnstructuredGrid>
  <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
   <Points>
    <DataArray type="Float32" NumberOfComponents="3" format="binary">{_b64(coords3)}</DataArray>
   </Points>
   <Cells>
    <DataArray type="Int32" Name="connectivity" format="binary">{_b64(conn)}</DataArray>
    <DataArray type="Int32" Name="offsets" format="binary">{_b64(offsets)}</DataArray>
    <DataArray type="UInt8" Name="types" format="binary">{_b64(ctype)}</DataArray>
   </Cells>
   <PointData Scalars="{scalars}">
{point_data}
   </PointData>
  </Piece>
 </UnstructuredGrid>
</VTKFile>
"""
        (self.base / fname).write_text(xml)
        self._frames.append((float(t), fname))

    def close(self) -> Path:
        entries = "\n".join(
            f'  <DataSet timestep="{t}" part="0" file="{f}"/>' for t, f in self._frames
        )
        pvd = f"""<?xml version="1.0"?>
<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">
 <Collection>
{entries}
 </Collection>
</VTKFile>
"""
        out = self.base / "series.pvd"
        out.write_text(pvd)
        return out


# ---------------------------------------------------------------------------
# Mesh input: Gmsh .msh (ASCII v2.2 / v4.1) and npz round-trip.
#
# The reference obtains patient/atlas meshes through dolfinx's gmshio
# (cardiac-geometries and ukb-atlas both produce Gmsh files); this is the
# in-repo counterpart of ``dolfinx.io.gmshio.read_from_msh`` returning
# ``(mesh, cell_tags, facet_tags)``.

_GMSH_TYPES = {
    1: ("line", 2, 1),
    2: ("triangle", 3, 2),
    4: ("tetrahedron", 4, 3),
    15: ("point", 1, 0),
}


def read_msh(path: str | Path):
    """Read a Gmsh ``.msh`` file: ASCII format 2.2 or 4.1, or BINARY
    format 4.1 (Gmsh's default output mode — real users' meshes arrive
    binary first).

    Returns ``(mesh, cell_tags, facet_tags)``: cells are the
    highest-dimension elements; physical tags on cells/facets become
    :class:`~fenicsx_beat_tpu.mesh.MeshTags` (``None`` when untagged).
    Facet entities are matched to the mesh's own facet enumeration.
    Mirrors ``dolfinx.io.gmshio.read_from_msh`` (reference demos receive
    their LV/BiV geometries through it).
    """
    raw = Path(path).read_bytes()
    head = raw[:128].split(b"\n")
    if not head or not head[0].strip().startswith(b"$MeshFormat"):
        raise ValueError(f"{path}: not a Gmsh mesh (missing $MeshFormat)")
    fmt = head[1].split()
    version = float(fmt[0])
    is_binary = len(fmt) > 1 and int(fmt[1]) != 0
    if is_binary:
        if version < 4.0:
            raise ValueError(
                f"{path}: binary .msh v{version} is not supported — "
                "re-export as v4.1 ('gmsh -save') or ASCII ('-bin 0')"
            )
        tags, coords, blocks = _parse_msh4_binary(raw, int(fmt[2]))
    else:
        text = raw.decode()
        sections: dict[str, list[str]] = {}
        name = None
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("$End"):
                name = None
            elif s.startswith("$"):
                name = s[1:]
                sections[name] = []
            elif name is not None:
                sections[name].append(s)
        if "MeshFormat" not in sections or "Nodes" not in sections:
            raise ValueError(f"{path}: not an ASCII Gmsh mesh")
        if version >= 4.0:
            tags, coords, blocks = _parse_msh4(sections)
        elif version >= 2.0:
            tags, coords, blocks = _parse_msh2(sections)
        else:
            raise ValueError(f"{path}: unsupported msh version {version}")

    tdim = max(d for d, _, _ in blocks)
    if tdim < 3 and np.abs(coords[:, tdim:]).max(initial=0.0) > 1e-12:
        raise NotImplementedError(
            f"{path}: {tdim}D cells embedded in 3D (curved surface mesh) — "
            "the PDE layer requires tdim == gdim; project or volumetrize "
            "the mesh first"
        )
    coords = coords[:, :tdim]

    order = np.argsort(tags)
    sorted_tags = tags[order]

    def _remap(conn):
        pos = np.searchsorted(sorted_tags, conn.ravel())
        if (pos >= sorted_tags.size).any() or (sorted_tags[pos] != conn.ravel()).any():
            raise ValueError("element references an undefined node tag")
        return order[pos].reshape(conn.shape).astype(np.int32)

    cell_conn, cell_vals = [], []
    facet_conn, facet_vals = [], []
    for dim, phys, conn in blocks:
        if dim == tdim:
            cell_conn.append(_remap(conn))
            cell_vals.append(np.full(len(conn), phys, dtype=np.int32))
        elif dim == tdim - 1:
            facet_conn.append(_remap(conn))
            facet_vals.append(np.full(len(conn), phys, dtype=np.int32))
    cells = np.concatenate(cell_conn, axis=0)
    ctype = {3: CellType.tetrahedron, 2: CellType.triangle, 1: CellType.interval}[tdim]
    mesh = Mesh(coords=np.ascontiguousarray(coords, dtype=np.float64), cells=cells, cell_type=ctype)

    cvals = np.concatenate(cell_vals)
    cell_tags = None
    if (cvals != 0).any():
        cell_tags = MeshTags(
            mesh=mesh, dim=tdim,
            indices=np.arange(mesh.num_cells, dtype=np.int32), values=cvals,
        )
    facet_tags = None
    if facet_conn:
        fconn = np.sort(np.concatenate(facet_conn, axis=0), axis=1)
        fvals = np.concatenate(facet_vals)
        facets = mesh.entities(tdim - 1)  # lexicographically enumerated
        idx = _row_searchsorted(facets, fconn)
        ok = (idx < facets.shape[0]) & (facets[np.minimum(idx, facets.shape[0] - 1)] == fconn).all(axis=1)
        if not ok.all():
            raise ValueError(
                f"{path}: {int((~ok).sum())} tagged facets are not facets of the mesh"
            )
        facet_tags = MeshTags(
            mesh=mesh, dim=tdim - 1,
            indices=idx.astype(np.int32), values=fvals,
        )
    return mesh, cell_tags, facet_tags


def read_msh_physical_names(path: str | Path) -> dict[str, tuple[int, int]]:
    """``{name: (dim, physical tag)}`` from a .msh ``$PhysicalNames``
    section (empty dict when absent) — lets callers resolve named regions
    (EPI/ENDO_LV/...) to the tag values carried by :func:`read_msh`'s
    MeshTags, the role gmsh physical groups play for dolfinx users."""
    out: dict[str, tuple[int, int]] = {}
    inside = False
    for line in Path(path).read_text().splitlines():
        s = line.strip()
        if s == "$PhysicalNames":
            inside = True
            continue
        if s == "$EndPhysicalNames":
            break
        if inside and '"' in s:
            head, _, name = s.partition('"')
            dim, tag = (int(x) for x in head.split()[:2])
            out[name.rstrip('"')] = (dim, tag)
    return out


def _parse_msh2(sections):
    """v2.2: $Nodes = 'tag x y z'; $Elements = 'tag type ntags tags... nodes...'
    (tags[0] = physical group)."""
    nl = sections["Nodes"]
    n = int(nl[0])
    tags = np.empty(n, dtype=np.int64)
    coords = np.empty((n, 3), dtype=np.float64)
    for i, line in enumerate(nl[1 : 1 + n]):
        parts = line.split()
        tags[i] = int(parts[0])
        coords[i] = [float(x) for x in parts[1:4]]
    el = sections["Elements"]
    ne = int(el[0])
    blocks: dict[tuple[int, int, int], list[list[int]]] = {}
    for line in el[1 : 1 + ne]:
        parts = [int(x) for x in line.split()]
        etype = parts[1]
        if etype not in _GMSH_TYPES:
            continue
        _, nn, dim = _GMSH_TYPES[etype]
        ntags = parts[2]
        phys = parts[3] if ntags >= 1 else 0
        conn = parts[3 + ntags : 3 + ntags + nn]
        blocks.setdefault((dim, phys, etype), []).append(conn)
    out = [(dim, phys, np.asarray(rows, dtype=np.int64)) for (dim, phys, _), rows in blocks.items()]
    return tags, coords, out


def _parse_msh4(sections):
    """v4.1: entity-block $Nodes/$Elements; physical tags resolved through
    the $Entities section (first physical tag of each entity)."""
    # entity (dim, tag) -> physical tag
    phys_of: dict[tuple[int, int], int] = {}
    if "Entities" in sections:
        lines = sections["Entities"]
        counts = [int(x) for x in lines[0].split()]  # points, curves, surfaces, volumes
        li = 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = lines[li].split()
                li += 1
                tag = int(parts[0])
                # points: tag x y z numPhys phys...; others: tag bbox(6) numPhys phys...
                off = 4 if dim == 0 else 7
                nphys = int(parts[off])
                phys_of[(dim, tag)] = int(parts[off + 1]) if nphys else 0
    nl = sections["Nodes"]
    nblocks, nnodes = int(nl[0].split()[0]), int(nl[0].split()[1])
    tags = np.empty(nnodes, dtype=np.int64)
    coords = np.empty((nnodes, 3), dtype=np.float64)
    li, k = 1, 0
    for _ in range(nblocks):
        nb = int(nl[li].split()[3])
        li += 1
        for j in range(nb):
            tags[k + j] = int(nl[li + j])
        for j in range(nb):
            coords[k + j] = [float(x) for x in nl[li + nb + j].split()[:3]]
        li += 2 * nb
        k += nb
    el = sections["Elements"]
    eblocks = int(el[0].split()[0])
    li = 1
    blocks = []
    for _ in range(eblocks):
        dim, etag, etype, nb = (int(x) for x in el[li].split())
        li += 1
        if etype not in _GMSH_TYPES:
            li += nb
            continue
        _, nn, edim = _GMSH_TYPES[etype]
        rows = np.empty((nb, nn), dtype=np.int64)
        for j in range(nb):
            rows[j] = [int(x) for x in el[li + j].split()[1 : 1 + nn]]
        li += nb
        blocks.append((edim, phys_of.get((dim, etag), 0), rows))
    return tags, coords, blocks


class _BinCursor:
    """Sequential reader over a binary .msh buffer: ASCII section marker
    lines interleaved with packed binary payloads (binary sections cannot
    be located by scanning for ``$End`` markers — the payload bytes can
    contain anything — so the walk must be strictly sequential with
    spec-known record sizes)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def line(self) -> str:
        end = self.data.index(b"\n", self.pos)
        out = self.data[self.pos : end].decode(errors="replace").strip()
        self.pos = end + 1
        return out

    def skip_newline(self) -> None:
        while self.pos < len(self.data) and self.data[self.pos : self.pos + 1] in (
            b"\n",
            b"\r",
        ):
            self.pos += 1

    def read(self, dtype: np.dtype, count: int) -> np.ndarray:
        nbytes = dtype.itemsize * count
        out = np.frombuffer(self.data, dtype=dtype, count=count, offset=self.pos)
        self.pos += nbytes
        return out


def _parse_msh4_binary(data: bytes, data_size: int):
    """Binary MSH 4.1 (the default ``gmsh -save`` output): same entity-
    block structure as the ASCII v4.1 parser, records packed per the
    published spec (size_t = ``data_size`` bytes; endianness detected
    from the one-int probe after the $MeshFormat line)."""
    cur = _BinCursor(data)
    if cur.line() != "$MeshFormat":
        raise ValueError("binary .msh: missing $MeshFormat")
    cur.line()  # "4.1 1 <data_size>"
    # endianness probe: the int 1 written in the file's native order
    one_le = np.frombuffer(data, dtype="<i4", count=1, offset=cur.pos)[0]
    bo = "<" if one_le == 1 else ">"
    cur.pos += 4
    i4 = np.dtype(f"{bo}i4")
    f8 = np.dtype(f"{bo}f8")
    szt = np.dtype(f"{bo}u{data_size}")
    cur.skip_newline()
    if cur.line() != "$EndMeshFormat":
        raise ValueError("binary .msh: malformed $MeshFormat")

    phys_of: dict[tuple[int, int], int] = {}
    tags = coords = None
    blocks = []
    while cur.pos < len(data):
        sec = cur.line()
        if not sec.startswith("$"):
            continue
        name = sec[1:]
        if name == "PhysicalNames":
            # ASCII even inside binary files (per spec)
            nn = int(cur.line())
            for _ in range(nn):
                cur.line()
            cur.line()  # $EndPhysicalNames
        elif name == "Entities":
            counts = cur.read(szt, 4)
            for dim in range(4):
                for _ in range(int(counts[dim])):
                    tag = int(cur.read(i4, 1)[0])
                    # points carry x,y,z; higher dims a 6-double bbox
                    cur.read(f8, 3 if dim == 0 else 6)
                    nphys = int(cur.read(szt, 1)[0])
                    phys = cur.read(i4, nphys)
                    phys_of[(dim, tag)] = int(phys[0]) if nphys else 0
                    if dim > 0:
                        nbound = int(cur.read(szt, 1)[0])
                        cur.read(i4, nbound)
            cur.skip_newline()
            if cur.line() != "$EndEntities":
                raise ValueError("binary .msh: malformed $Entities")
        elif name == "Nodes":
            hdr = cur.read(szt, 4)
            nblocks, nnodes = int(hdr[0]), int(hdr[1])
            tags = np.empty(nnodes, dtype=np.int64)
            coords = np.empty((nnodes, 3), dtype=np.float64)
            k = 0
            for _ in range(nblocks):
                cur.read(i4, 3)  # entityDim, entityTag, parametric
                nb = int(cur.read(szt, 1)[0])
                tags[k : k + nb] = cur.read(szt, nb).astype(np.int64)
                coords[k : k + nb] = (
                    cur.read(f8, 3 * nb).astype(np.float64).reshape(nb, 3)
                )
                k += nb
            cur.skip_newline()
            if cur.line() != "$EndNodes":
                raise ValueError("binary .msh: malformed $Nodes")
        elif name == "Elements":
            hdr = cur.read(szt, 4)
            nblocks = int(hdr[0])
            for _ in range(nblocks):
                edim, etag, etype = (int(x) for x in cur.read(i4, 3))
                nb = int(cur.read(szt, 1)[0])
                if etype not in _GMSH_TYPES:
                    # unknown element type: record size is unknowable;
                    # the four supported types cover P1 simplex meshes
                    raise ValueError(
                        f"binary .msh: unsupported element type {etype}"
                    )
                _, nn, dim = _GMSH_TYPES[etype]
                rec = cur.read(szt, nb * (1 + nn)).astype(np.int64).reshape(nb, 1 + nn)
                blocks.append((dim, phys_of.get((edim, etag), 0), rec[:, 1:]))
            cur.skip_newline()
            if cur.line() != "$EndElements":
                raise ValueError("binary .msh: malformed $Elements")
            break  # everything needed is in hand
        else:
            raise ValueError(
                f"binary .msh: section ${name} before $Elements is not "
                "supported (binary sections cannot be skipped blindly)"
            )
        cur.skip_newline()
    if tags is None:
        raise ValueError("binary .msh: no $Nodes section")
    return tags, coords, blocks


def write_mesh(path: str | Path, mesh: Mesh) -> Path:
    """Write a mesh (and nothing else) as one ``.npz`` — the storage
    counterpart of the reference's XDMF ``write_mesh``."""
    path = Path(path)
    np.savez_compressed(
        path, coords=mesh.coords, cells=mesh.cells, cell_type=str(mesh.cell_type)
    )
    return path


def read_mesh(path: str | Path) -> Mesh:
    """Read a mesh written by :func:`write_mesh` (or a checkpoint npz)."""
    with np.load(path, allow_pickle=False) as f:
        ct = str(f["cell_type"]).split(".")[-1]  # "CellType.tetrahedron" -> name
        return Mesh(
            coords=np.asarray(f["coords"], dtype=np.float64),
            cells=np.asarray(f["cells"], dtype=np.int32),
            cell_type=CellType[ct],
        )
