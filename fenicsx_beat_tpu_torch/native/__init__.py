"""The native host kit: host C++ (``beatkit.cpp``) bound with ctypes, each
function beside its numpy twin.

The port's own copy of the JAX package's ``fenicsx_beat_tpu/native``.  The
library is compiled with ``g++ -O3`` at the first call into
``build/native/libbeatkit-<hash>.so`` beside the package, keyed by a hash
of the source and flags; the compiler writes into a scratch file that is
renamed into place, so processes that build at once do not trip over each
other.  A failed build raises with g++'s output: there is no numpy fallback
and no switch that turns the kit off.  Each ``<name>_twin`` is the plain
numpy version of ``<name>`` on the same arguments, which the tests and
``benchmarks/setup_kit.py`` hold the kit to.

Functions (host numpy in and out):

* ``unique_rows(rows)``: lexicographically sorted unique int32 rows;
* ``coo_to_ell_arrays(rows, cols, vals, shape, width=None)``: padded ELL
  with duplicates summed;
* ``rcm_ordering(indptr, indices)``: reverse Cuthill-McKee permutation
  (``perm[new] = old``);
* ``p1_geometry(coords, cells, tdim)``: edges, volumes, basis gradients;
* ``p1_stencil_tables`` / ``p1_stencil_tables_direct``: the P1 mass and
  stiffness as ``[n, K]`` stencil tables (``"too_wide"`` when the column
  offsets exceed the bound);
* ``p1_ell_tables_direct``: the P1 pair as padded ELL of a bounded width
  with the longer rows' rest in a COO tail;
* ``locate_points(coords, cells, points, tol)``: the lowest-index cell
  holding each point, -1 outside.

The P1 functions take ``tdim == gdim`` meshes (1-3 for ``p1_geometry``, 2
or 3 for the others) and raise ``ValueError`` on others; a cell of zero
volume raises ``numpy.linalg.LinAlgError``, as the numpy geometry does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import tempfile
from collections import deque
from pathlib import Path

import numpy as np

__all__ = [
    "library", "det_inv", "degenerate",
    "unique_rows", "unique_rows_twin",
    "coo_to_ell_arrays", "coo_to_ell_arrays_twin",
    "rcm_ordering", "rcm_ordering_twin",
    "p1_geometry", "p1_geometry_twin",
    "p1_stencil_tables", "p1_stencil_tables_twin",
    "p1_stencil_tables_direct", "p1_stencil_tables_direct_twin",
    "p1_ell_tables_direct", "p1_ell_tables_direct_twin",
    "locate_points", "locate_points_twin",
]

_SRC = Path(__file__).with_name("beatkit.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_i32p, _i64p, _f64p = (ctypes.POINTER(t) for t in (ctypes.c_int32, ctypes.c_int64, ctypes.c_double))
_SIGNATURES = {
    "unique_rows_i32": (_i64, [_i32p, _i64, _i64, _i32p]),
    "coo_to_ell_f64": (_i64, [_i64p, _i64p, _f64p, _i64, _i64, _i64, _i32, _i32p, _f64p]),
    "rcm_ordering": (None, [_i64p, _i32p, _i64, _i32p]),
    "p1_geometry": (_i64, [_f64p, _i32p, _i64, _i32, _f64p, _f64p, _f64p]),
    "p1_stencil_offsets": (_i64, [_i64p, _i64, _i32, _i64, _i64p]),
    "p1_stencil_assemble": (_i64, [_i64p, _i64, _i32, _f64p, _f64p, _i32, _f64p, _i64, _f64p, _i64p, _i64,
                                   _f64p, _f64p]),
    "p1_stencil_offsets_i32": (_i64, [_i32p, _i64, _i32, _i64, _i64p]),
    "p1_stencil_assemble_direct": (_i64, [_f64p, _i32p, _i64, _i32, _f64p, _i64, _i64p, _i64, _f64p, _f64p,
                                          _f64p]),
    "p1_ell_assemble_direct": (_i64, [_f64p, _i32p, _i64, _i32, _f64p, _i64, _i64, _i32, _i32p, _i32p, _f64p,
                                      _f64p, _i64, _i64p, _i32p, _i32p, _f64p, _f64p]),
    "locate_points": (None, [_f64p, _i32p, _i64, _i32, _f64p, _i64, ctypes.c_double, _i64p]),
}


def _compile(out: Path) -> None:
    """g++ the source into ``out`` through a scratch file; raises with the
    compiler's output when it fails."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        tmp = Path(td) / out.name
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except OSError as ex:
            raise RuntimeError(f"the native host kit needs g++ to build {_SRC.name}: {ex}") from ex
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {_SRC} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kit; raises on failure."""
    tag = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libbeatkit-{tag}.so"
    if not out.is_file():
        _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _p(arr: np.ndarray, ctype=ctypes.c_double):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def degenerate() -> np.linalg.LinAlgError:
    """The error of a cell of zero volume, as numpy's geometry raises it."""
    return np.linalg.LinAlgError("singular cell Jacobian: mesh contains degenerate (zero-volume) cells")


def _simplex(coords: np.ndarray, cells: np.ndarray, dims=(2, 3)) -> tuple[np.ndarray, np.ndarray, int]:
    """``(coords f64, cells int32, d)`` of a tdim == gdim simplex mesh with
    d in ``dims``; ValueError otherwise."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    d = cells.shape[1] - 1
    if d not in dims or coords.ndim != 2 or coords.shape[1] != d:
        raise ValueError(f"the kit takes simplex meshes with tdim == gdim in {dims}: cells {cells.shape}, "
                         f"coords {coords.shape}")
    return coords, cells, d


def _cell_tensor(Mc: np.ndarray, g: int) -> tuple[np.ndarray, int]:
    """A per-cell ``[nc, g, g]`` tensor as the kernels read it: one block
    with stride 0 when it is a broadcast of one tensor."""
    Mc = np.asarray(Mc, dtype=np.float64)
    if Mc.strides[0] == 0:
        return np.ascontiguousarray(Mc[0]), 0
    return np.ascontiguousarray(Mc), g * g


# ---------------------------------------------------------------------------
# entity enumeration


def unique_rows(rows: np.ndarray) -> np.ndarray:
    """Unique rows (lexicographically sorted) of an int array ``[n, k]``, int32."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, k = rows.shape
    out = np.empty_like(rows)
    m = library().unique_rows_i32(_p(rows, ctypes.c_int32), n, k, _p(out, ctypes.c_int32))
    return out[:m].copy()


def unique_rows_twin(rows: np.ndarray) -> np.ndarray:
    return np.unique(np.asarray(rows, dtype=np.int32), axis=0)


# ---------------------------------------------------------------------------
# COO -> padded ELL


def _ell_pad(cols: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Padding slots (beyond each row's count) point at the row itself."""
    n, w = cols.shape
    pad = np.arange(w)[None, :] >= counts[:, None]
    return np.where(pad, np.arange(n, dtype=np.int32)[:, None], cols).astype(np.int32)


def coo_to_ell_arrays(rows, cols, vals, shape: tuple[int, int], width: int | None = None):
    """``(cols [n, w] int32, vals [n, w] f64, w, counts [n] int64)`` from COO
    triplets, duplicates summed in their given order, each row's entries
    in column order; padding points at the row itself with value 0.  ``w``
    is the widest row's count; ``width``, a first guess of it, only sizes
    the buffer (the JAX package's kit: a guess too small is widened)."""
    nrows = shape[0]
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    cap = int(np.bincount(rows, minlength=nrows).max()) if rows.size else 1
    cap = max(cap, int(width or 1))
    cols_out = np.empty((nrows, cap), dtype=np.int32)
    vals_out = np.empty((nrows, cap), dtype=np.float64)
    w = library().coo_to_ell_f64(_p(rows, ctypes.c_int64), _p(cols, ctypes.c_int64), _p(vals), rows.size, nrows,
                                 cap, -1, _p(cols_out, ctypes.c_int32), _p(vals_out))
    w = max(int(w), 1)
    cols_out, vals_out = cols_out[:, :w], vals_out[:, :w].copy()
    counts = (cols_out >= 0).sum(axis=1).astype(np.int64)
    return _ell_pad(cols_out, counts), vals_out, w, counts


def coo_to_ell_arrays_twin(rows, cols, vals, shape: tuple[int, int], width: int | None = None):
    nrows = shape[0]
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    if r.size:
        new = np.ones(r.size, dtype=bool)
        new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        v = np.bincount(np.cumsum(new) - 1, weights=v)
        r, c = r[new], c[new]
    counts = np.bincount(r, minlength=nrows).astype(np.int64)
    w = max(int(counts.max()) if counts.size else 1, 1)
    cols_out = np.broadcast_to(np.arange(nrows, dtype=np.int32)[:, None], (nrows, w)).copy()
    vals_out = np.zeros((nrows, w))
    pos = np.arange(r.size) - np.concatenate([[0], np.cumsum(counts)])[r]
    cols_out[r, pos] = c
    vals_out[r, pos] = v
    return cols_out, vals_out, w, counts


# ---------------------------------------------------------------------------
# reverse Cuthill-McKee


def rcm_ordering(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (``perm[new] = old``, int32) of a
    CSR adjacency graph: each component seeded at its unvisited node of
    least degree (the lowest index on ties), neighbours queued by degree
    (CSR order on ties)."""
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    n = indptr.size - 1
    out = np.empty(n, dtype=np.int32)
    library().rcm_ordering(_p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32), n, _p(out, ctypes.c_int32))
    return out


def rcm_ordering_twin(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    n = indptr.size - 1
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = []
    remaining = np.argsort(degree, kind="stable")
    ptr = 0
    while len(order) < n:
        while visited[remaining[ptr]]:
            ptr += 1
        seed = remaining[ptr]
        visited[seed] = True
        q = deque([seed])
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = [v for v in indices[indptr[u]: indptr[u + 1]] if not visited[v]]
            for v in sorted(nbrs, key=lambda x: degree[x]):
                visited[v] = True
                q.append(v)
    return np.asarray(order[::-1], dtype=np.int32)


# ---------------------------------------------------------------------------
# P1 geometry


def p1_geometry(coords: np.ndarray, cells: np.ndarray, tdim: int):
    """``(edges [nc, d, d], volume [nc], grads [nc, d+1, d])`` of a P1
    simplex mesh with tdim == gdim == d in {1, 2, 3}, one pass over the
    cells: edge row i is ``x_{i+1} - x_0``, grads rows 1..d are
    ``inv(E)^T`` and row 0 their negative sum (``fem.CellGeometry``'s
    layout, whose ``inv_edges`` is ``grads[:, 1:]``)."""
    coords, cells, d = _simplex(coords, cells, (1, 2, 3))
    if d != tdim:
        raise ValueError(f"tdim {tdim} against cells of {d + 1} vertices")
    nc = cells.shape[0]
    edges = np.empty((nc, d, d))
    volume = np.empty(nc)
    grads = np.empty((nc, d + 1, d))
    rc = library().p1_geometry(_p(coords), _p(cells, ctypes.c_int32), nc, d, _p(edges), _p(volume), _p(grads))
    if rc == -1:
        raise degenerate()
    return edges, volume, grads


def det_inv(E: np.ndarray):
    """Determinant and inverse of ``[nc, d, d]`` batches, d <= 3, by
    cofactors (vectorized arithmetic: ``np.linalg`` would send each tiny
    matrix through LAPACK); a singular matrix gives det 0 and inf/nan
    entries, which the caller tests."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _cofactor_det_inv(E)


def _cofactor_det_inv(E: np.ndarray):
    d = E.shape[-1]
    if d == 1:
        det = E[:, 0, 0]
        return det, (1.0 / det)[:, None, None]
    inv = np.empty_like(E)
    if d == 2:
        a, b, c, dd = E[:, 0, 0], E[:, 0, 1], E[:, 1, 0], E[:, 1, 1]
        det = a * dd - b * c
        r = 1.0 / det
        inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 0], inv[:, 1, 1] = dd * r, -b * r, -c * r, a * r
        return det, inv
    a, b, c = E[:, 0, 0], E[:, 0, 1], E[:, 0, 2]
    p, q, r = E[:, 1, 0], E[:, 1, 1], E[:, 1, 2]
    u, v, w = E[:, 2, 0], E[:, 2, 1], E[:, 2, 2]
    A, B, C = q * w - r * v, r * u - p * w, p * v - q * u
    det = a * A + b * B + c * C
    s = 1.0 / det
    inv[:, 0, 0], inv[:, 1, 0], inv[:, 2, 0] = A * s, B * s, C * s
    inv[:, 0, 1], inv[:, 1, 1], inv[:, 2, 1] = (c * v - b * w) * s, (a * w - c * u) * s, (b * u - a * v) * s
    inv[:, 0, 2], inv[:, 1, 2], inv[:, 2, 2] = (b * r - c * q) * s, (c * p - a * r) * s, (a * q - b * p) * s
    return det, inv


def p1_geometry_twin(coords: np.ndarray, cells: np.ndarray, tdim: int):
    coords, cells, d = _simplex(coords, cells, (1, 2, 3))
    X = coords[cells]
    E = X[:, 1:, :] - X[:, :1, :]
    det, inv = det_inv(E)
    if np.any(det == 0):
        raise degenerate()
    Gi = np.transpose(inv, (0, 2, 1))
    return E, np.abs(det) / math.factorial(d), np.concatenate([-Gi.sum(axis=1, keepdims=True), Gi], axis=1)


# ---------------------------------------------------------------------------
# P1 stencil tables


def p1_stencil_tables(cd, vol, grads, Mc, base, max_offsets: int, n: int):
    """The P1 mass and stiffness as ``[n, K]`` stencil tables from the cell
    geometry: ``cd [nc, nd]`` cell dofs, ``vol [nc]``, ``grads [nc, nd, g]``,
    ``Mc [nc, g, g]`` (a stride-0 broadcast is read as one block), ``base
    [nd, nd]`` the mass matrix over the volume.  Returns ``(offs [K] int64
    sorted, mst, kst)``, or ``"too_wide"`` when there are more than
    ``max_offsets`` column offsets (an unstructured mesh)."""
    cd = np.ascontiguousarray(cd, dtype=np.int64)
    nc, nd = cd.shape
    g = grads.shape[2]
    if nd > 4 or g > 3:
        raise ValueError(f"the kit takes at most 4 dofs a cell and 3 dimensions, got {nd} and {g}")
    mc, stride = _cell_tensor(Mc, g)
    lib = library()
    offs = np.empty(max_offsets, dtype=np.int64)
    K = lib.p1_stencil_offsets(_p(cd, ctypes.c_int64), nc, nd, max_offsets, _p(offs, ctypes.c_int64))
    if K < 0:
        return "too_wide"
    offs = offs[:K].copy()
    mst, kst = np.zeros(n * K), np.zeros(n * K)
    vol = np.ascontiguousarray(vol, dtype=np.float64)
    grads = np.ascontiguousarray(grads, dtype=np.float64)
    base = np.ascontiguousarray(base, dtype=np.float64)
    rc = lib.p1_stencil_assemble(_p(cd, ctypes.c_int64), nc, nd, _p(vol), _p(grads), g, _p(mc), stride, _p(base),
                                 _p(offs, ctypes.c_int64), K, _p(mst), _p(kst))
    if rc != 0:
        raise RuntimeError(f"p1_stencil_assemble returned {rc}")
    return offs, mst.reshape(n, K), kst.reshape(n, K)


def _stencil_offsets_twin(cd: np.ndarray, max_offsets: int):
    """The sorted column offsets of every (i, j) slot, or None past the bound."""
    nd = cd.shape[1]
    offsets: set[int] = set()
    for i in range(nd):
        for j in range(nd):
            u = np.unique(cd[:, j] - cd[:, i])
            if u.size > max_offsets:
                return None
            offsets.update(int(v) for v in u)
            if len(offsets) > max_offsets:
                return None
    return np.array(sorted(offsets), dtype=np.int64)


def _stencil_slots_twin(cd, vol, grads, Mc, base, offs, n):
    """Each element-matrix (i, j) slot scattered into the tables with
    ``np.bincount``: no sort, no ``[nc, nd, nd]`` element tensor."""
    nd, K = cd.shape[1], offs.size
    mst, kst = np.zeros(n * K), np.zeros(n * K)
    for j in range(nd):
        MGj = np.einsum("cgh,ch->cg", Mc, grads[:, j, :])
        for i in range(nd):
            lin = cd[:, i] * K + np.searchsorted(offs, cd[:, j] - cd[:, i])
            mst += np.bincount(lin, weights=vol * base[i, j], minlength=n * K)
            kst += np.bincount(lin, weights=vol * np.einsum("cg,cg->c", grads[:, i, :], MGj), minlength=n * K)
    return mst.reshape(n, K), kst.reshape(n, K)


def p1_stencil_tables_twin(cd, vol, grads, Mc, base, max_offsets: int, n: int):
    cd = np.asarray(cd, dtype=np.int64)
    offs = _stencil_offsets_twin(cd, max_offsets)
    if offs is None:
        return "too_wide"
    return (offs, *_stencil_slots_twin(cd, vol, grads, np.asarray(Mc, dtype=np.float64), base, offs, n))


def _mass_base(d: int) -> np.ndarray:
    return (np.ones((d + 1, d + 1)) + np.eye(d + 1)) / ((d + 1) * (d + 2))


def p1_stencil_tables_direct(coords, cells, Mc, max_offsets: int, n: int, want_volumes: bool = False):
    """Geometry and stencil assembly in one pass over the cells, straight
    from ``coords [n, d]`` and ``cells [nc, d+1]`` (the P1 cell dofs),
    d in {2, 3}, with no per-cell array.  Returns ``(offs, mst, kst, vol
    [nc] or None)`` or ``"too_wide"``."""
    coords, cells, d = _simplex(coords, cells)
    nc = cells.shape[0]
    mc, stride = _cell_tensor(Mc, d)
    lib = library()
    offs = np.empty(max_offsets, dtype=np.int64)
    K = lib.p1_stencil_offsets_i32(_p(cells, ctypes.c_int32), nc, d + 1, max_offsets, _p(offs, ctypes.c_int64))
    if K < 0:
        return "too_wide"
    offs = offs[:K].copy()
    mst, kst = np.zeros(n * K), np.zeros(n * K)
    vol = np.empty(nc) if want_volumes else None
    rc = lib.p1_stencil_assemble_direct(_p(coords), _p(cells, ctypes.c_int32), nc, d, _p(mc), stride,
                                        _p(offs, ctypes.c_int64), K, _p(mst), _p(kst),
                                        _p(vol) if want_volumes else _f64p())
    if rc == -1:
        raise degenerate()
    if rc != 0:
        raise RuntimeError(f"p1_stencil_assemble_direct returned {rc}")
    return offs, mst.reshape(n, K), kst.reshape(n, K), vol


def p1_stencil_tables_direct_twin(coords, cells, Mc, max_offsets: int, n: int, want_volumes: bool = False):
    coords, cells, d = _simplex(coords, cells)
    cd = cells.astype(np.int64)
    offs = _stencil_offsets_twin(cd, max_offsets)
    if offs is None:
        return "too_wide"
    _, vol, grads = p1_geometry_twin(coords, cells, d)
    mst, kst = _stencil_slots_twin(cd, vol, grads, np.asarray(Mc, dtype=np.float64), _mass_base(d), offs, n)
    return offs, mst, kst, vol if want_volumes else None


# ---------------------------------------------------------------------------
# P1 padded ELL with a COO tail


def _tail_sum(tr, tc, tm, tk, n):
    """The tail's (row, col) pairs summed in their given order, sorted."""
    uniq, inv = np.unique(tr.astype(np.int64) * n + tc, return_inverse=True)
    tm_s, tk_s = np.zeros(uniq.size), np.zeros(uniq.size)
    np.add.at(tm_s, inv, tm)
    np.add.at(tk_s, inv, tk)
    return (uniq // n).astype(np.int32), (uniq % n).astype(np.int32), tm_s, tk_s


def p1_ell_tables_direct(coords, cells, Mc, n: int, width: int | None = None):
    """Geometry and the P1 mass and stiffness in one pass over the cells
    (d in {2, 3}), into padded ELL rows of at most ``width`` entries (32 in
    3-D, 12 in 2-D), each row's first ``width`` columns in the order the
    cells meet them kept and sorted; the rest of a longer row (the LV's
    apex) spills into a COO tail, summed.  Returns ``(cols [n, w] int32,
    mvals, kvals, counts [n] int64, tail)``, ``tail`` None or ``(rows,
    cols, mvals, kvals)`` sorted by (row, col); padding points at the row
    itself with value 0."""
    coords, cells, d = _simplex(coords, cells)
    nc = cells.shape[0]
    mc, stride = _cell_tensor(Mc, d)
    width = int(width or (32 if d == 3 else 12))
    tail_cap = max(4096, nc // 16)
    lib = library()
    while True:
        counts = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n * width, dtype=np.int32)
        mvals, kvals = np.zeros(n * width), np.zeros(n * width)
        tr, tc = np.empty(tail_cap, dtype=np.int32), np.empty(tail_cap, dtype=np.int32)
        tm, tk = np.empty(tail_cap), np.empty(tail_cap)
        tail_n = np.zeros(1, dtype=np.int64)
        rc = lib.p1_ell_assemble_direct(
            _p(coords), _p(cells, ctypes.c_int32), nc, d, _p(mc), stride, n, width,
            _p(counts, ctypes.c_int32), _p(cols, ctypes.c_int32), _p(mvals), _p(kvals),
            tail_cap, _p(tail_n, ctypes.c_int64),
            _p(tr, ctypes.c_int32), _p(tc, ctypes.c_int32), _p(tm), _p(tk),
        )
        if rc != -4:
            break
        tail_cap *= 4
    if rc == -1:
        raise degenerate()
    if rc < 0:
        raise RuntimeError(f"p1_ell_assemble_direct returned {rc}")
    w = max(int(rc), 1)
    counts = counts.astype(np.int64)
    cols = _ell_pad(cols.reshape(n, width)[:, :w], counts)
    nt = int(tail_n[0])
    tail = _tail_sum(tr[:nt], tc[:nt], tm[:nt], tk[:nt], n) if nt else None
    return cols, mvals.reshape(n, width)[:, :w].copy(), kvals.reshape(n, width)[:, :w].copy(), counts, tail


def p1_ell_tables_direct_twin(coords, cells, Mc, n: int, width: int | None = None):
    coords, cells, d = _simplex(coords, cells)
    nc, nd = cells.shape
    width = int(width or (32 if d == 3 else 12))
    _, vol, G = p1_geometry_twin(coords, cells, d)
    Mc = np.asarray(Mc, dtype=np.float64)
    MG = np.einsum("cab,cjb->cja", Mc, G)
    Ke = np.einsum("cia,cja->cij", G, MG) * vol[:, None, None]
    Me = vol[:, None, None] * (np.where(np.eye(nd, dtype=bool), 2.0, 1.0) / ((d + 1) * (d + 2)))
    # the triplets in the kernel's (cell, i, j) order
    r = np.repeat(cells, nd, axis=1).ravel().astype(np.int64)
    c = np.tile(cells, (1, nd)).ravel().astype(np.int64)
    me, ke = Me.ravel(), Ke.ravel()
    key = r * n + c
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    urow, ucol = uniq // n, uniq % n
    # a row keeps the first `width` columns the traversal meets
    by_first = np.lexsort((first, urow))
    row_start = np.searchsorted(urow[by_first], np.arange(n))
    rank = np.empty(uniq.size, dtype=np.int64)
    rank[by_first] = np.arange(uniq.size) - row_start[urow[by_first]]
    kept = rank < width
    counts = np.bincount(urow[kept], minlength=n).astype(np.int64)
    w = max(int(counts.max()) if n else 1, 1)
    msum = np.bincount(inv, weights=me, minlength=uniq.size)
    ksum = np.bincount(inv, weights=ke, minlength=uniq.size)
    # kept pairs are in (row, col) order already: their slot is the rank among the row's kept
    krow = urow[kept]
    pos = np.arange(krow.size) - np.concatenate([[0], np.cumsum(counts)])[krow]
    cols = np.zeros((n, w), dtype=np.int32)
    mvals, kvals = np.zeros((n, w)), np.zeros((n, w))
    cols[krow, pos], mvals[krow, pos], kvals[krow, pos] = ucol[kept], msum[kept], ksum[kept]
    spilled = ~kept[inv]
    tail = _tail_sum(r[spilled].astype(np.int32), c[spilled].astype(np.int32), me[spilled], ke[spilled], n) \
        if spilled.any() else None
    return _ell_pad(cols, counts), mvals, kvals, counts, tail


# ---------------------------------------------------------------------------
# point location


def locate_points(coords, cells, points, tol: float = 1e-10) -> np.ndarray:
    """The lowest-index cell holding each point (barycentric coordinates
    all >= -tol, among the cells whose bounding box padded by ``tol``
    holds it; cells of zero volume skipped), -1 outside: ``[np]`` int64,
    one pass over the cells for all points, on a mesh with tdim == gdim
    in {2, 3}."""
    coords, cells, g = _simplex(coords, cells)
    pts = np.ascontiguousarray(np.atleast_2d(np.asarray(points, dtype=np.float64))[:, :g])
    out = np.empty(pts.shape[0], dtype=np.int64)
    library().locate_points(_p(coords), _p(cells, ctypes.c_int32), cells.shape[0], g, _p(pts), pts.shape[0],
                            float(tol), _p(out, ctypes.c_int64))
    return out


def locate_points_twin(coords, cells, points, tol: float = 1e-10) -> np.ndarray:
    coords, cells, g = _simplex(coords, cells)
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))[:, :g]
    X = coords[cells]  # [nc, g+1, g]
    lo, hi = X.min(axis=1) - tol, X.max(axis=1) + tol
    out = np.full(pts.shape[0], -1, dtype=np.int64)
    for k, p in enumerate(pts):
        cand = np.nonzero(((p >= lo) & (p <= hi)).all(axis=1))[0]
        if not cand.size:
            continue
        E = X[cand, 1:, :] - X[cand, :1, :]
        det, inv = det_inv(E)
        xi = np.einsum("ca,cai->ci", p[None, :] - X[cand, 0, :], inv)
        ok = (det != 0) & (xi >= -tol).all(axis=1) & (1.0 - xi.sum(axis=1) >= -tol)
        hits = cand[ok]
        if hits.size:
            out[k] = hits[0]
    return out
