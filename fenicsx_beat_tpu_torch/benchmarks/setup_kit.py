"""Host setup seconds of the native kit against its numpy twins.

For each call site of :mod:`fenicsx_beat_tpu_torch.native` the kit's
function and its twin run on the same inputs of a full-width case, and,
where the port's numpy path before the kit was another function, that one
too: ``{site: {"kit": s, "twin": s, "numpy_path": s}}``, each the least of
``REPEATS`` runs (one for RCM and the dx=0.05 pair), and whether the results agree (integer tables equal,
floats within 1e-12 relative).  Then the whole operator assembly of each
case (``fem.assemble_mass_stiffness_auto``, as the solvers call it) with
the kit and with every kit function swapped for its twin:

- the psize 0.1 LV (243,518 nodes, 1,323,510 tets) with its Niederer
  tensor along the fibres: cell geometry, the stencil's decline, the ELL
  pair, edge enumeration, COO to ELL, the probes' cells, RCM of the graph;
- the dx=0.1 Niederer slab pair (442,401 nodes) and the dx=0.05 ECG pair
  (3,449,001 nodes, 20,160,000 tets): the stencil tables.

Host only (no card needed).  Usage::

    python -m fenicsx_beat_tpu_torch.benchmarks.setup_kit [--out setup_kit.json]

Prints a line per measurement and one JSON object last; with ``--out``
writes the object there too.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from .. import fem, native
from ..conductivities import as_cell_tensors, default_conductivities, define_conductivity_tensor
from ..geometry import get_3D_slab_geometry, get_lv_ellipsoid_geometry
from ..mesh import _unique_rows
from ..ops.sparse import coo_to_ell_group
from .lv import lv_probe_points
from .niederer import LX, LY, LZ, niederer_setup

LV_PSIZE, SLAB_DX, ECG_DX = 0.1, 0.1, 0.05  # the full-width cases above
REPEATS = 2

KIT_FUNCTIONS = ("unique_rows", "coo_to_ell_arrays", "rcm_ordering", "p1_geometry", "p1_stencil_tables",
                 "p1_stencil_tables_direct", "p1_ell_tables_direct", "locate_points")


@contextmanager
def twins():
    """Every kit function swapped for its numpy twin while inside."""
    saved = {name: getattr(native, name) for name in KIT_FUNCTIONS}
    try:
        for name in KIT_FUNCTIONS:
            setattr(native, name, getattr(native, f"{name}_twin"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def best(fn, repeats: int):
    """(least seconds over ``repeats`` calls, the last call's result)."""
    times, out = [], None
    for _ in range(repeats):
        tic = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - tic)
    return min(times), out


def agree(a, b) -> bool:
    """Integer arrays equal, floats within 1e-12 of the largest magnitude."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(agree(x, y) for x, y in zip(a, b))
    if a is None or b is None or isinstance(a, (str, int, float)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind in "iub":
        return bool(np.array_equal(a, b))
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    return bool(np.abs(a - b).max(initial=0.0) <= 1e-12 * scale)


def site(out: dict, name: str, kit, twin, numpy_path=None, repeats: int = REPEATS) -> None:
    t_kit, r_kit = best(kit, repeats)
    t_twin, r_twin = best(twin, repeats)
    row = {"kit": t_kit, "twin": t_twin, "agree": agree(r_kit, r_twin)}
    if numpy_path is not None:
        row["numpy_path"] = best(numpy_path, repeats)[0]
    out[name] = row
    print(f"[setup_kit] {name}: " + ", ".join(f"{k} {v:.4f} s" if isinstance(v, float) else f"{k} {v}"
                                             for k, v in row.items()), flush=True)


def assembly(out: dict, name: str, V, Mc, repeats: int = REPEATS) -> None:
    """The solvers' whole assembly with the kit and on the twins."""
    def run():
        V.mesh.__dict__.pop("_cell_geometry", None)
        return fem.assemble_mass_stiffness_auto(V, Mc)

    t_kit, _ = best(run, repeats)
    with twins():
        t_twin, _ = best(run, repeats)
    out[name] = {"kit": t_kit, "twin": t_twin}
    print(f"[setup_kit] {name} (assemble_mass_stiffness_auto): kit {t_kit:.4f} s, twins {t_twin:.4f} s", flush=True)


def lv_case(out: dict) -> None:
    tic = time.perf_counter()
    geo = get_lv_ellipsoid_geometry(psize_ref=LV_PSIZE, cache=False)
    mesh = geo.mesh
    out["lv_geometry_s"] = time.perf_counter() - tic
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs
    M_cells = as_cell_tensors(define_conductivity_tensor(f0=geo.f0, **default_conductivities("Niederer")), mesh)
    Mc = fem._broadcast_cell_tensor(M_cells, mesh.num_cells, 3)
    print(f"[setup_kit] LV psize {LV_PSIZE}: {n} nodes, {mesh.num_cells} cells, geometry {out['lv_geometry_s']:.2f} s",
          flush=True)
    coords, cells = mesh.coords, mesh.cells
    site(out, "lv/p1_geometry", lambda: native.p1_geometry(coords, cells, 3),
         lambda: native.p1_geometry_twin(coords, cells, 3))
    site(out, "lv/stencil_decline", lambda: native.p1_stencil_tables_direct(coords, cells, Mc, 64, n),
         lambda: native.p1_stencil_tables_direct_twin(coords, cells, Mc, 64, n))

    def coo_path():
        rows, cols, mv, kv, shape = fem.assemble_mass_stiffness_coo(V, Mc)
        return coo_to_ell_group(rows, cols, [mv, kv], shape)

    site(out, "lv/p1_ell_tables_direct", lambda: native.p1_ell_tables_direct(coords, cells, Mc, n),
         lambda: native.p1_ell_tables_direct_twin(coords, cells, Mc, n), coo_path)
    sub = np.sort(np.concatenate([cells[:, list(c)] for c in itertools.combinations(range(4), 2)]), axis=1)
    site(out, "lv/unique_rows (edges)", lambda: native.unique_rows(sub), lambda: native.unique_rows_twin(sub),
         lambda: _unique_rows(sub.astype(np.int32), n))
    rows, cols, mv, kv, shape = fem.assemble_mass_stiffness_coo(V, Mc)
    site(out, "lv/coo_to_ell_arrays (mass, stiffness)",
         lambda: [native.coo_to_ell_arrays(rows, cols, v, shape) for v in (mv, kv)],
         lambda: [native.coo_to_ell_arrays_twin(rows, cols, v, shape) for v in (mv, kv)],
         lambda: coo_to_ell_group(rows, cols, [mv, kv], shape))
    pts = np.array(list(lv_probe_points(LV_PSIZE).values()))
    site(out, "lv/locate_points (probes)", lambda: native.locate_points(coords, cells, pts),
         lambda: native.locate_points_twin(coords, cells, pts))
    A = fem.assemble_mass_stiffness(V, 1.0)[0]
    from ..ops.sparse import operator_to_csr

    S = operator_to_csr(A)
    indptr, indices = S.indptr.astype(np.int64), S.indices.astype(np.int32)
    site(out, "lv/rcm_ordering", lambda: native.rcm_ordering(indptr, indices),
         lambda: native.rcm_ordering_twin(indptr, indices), repeats=1)
    assembly(out, "lv/assembly", V, M_cells)


def slab_case(out: dict, name: str, mesh, M, repeats: int = REPEATS) -> None:
    V = fem.functionspace(mesh, ("P", 1))
    n = V.ndofs
    M_cells = as_cell_tensors(M, mesh)
    Mc = fem._broadcast_cell_tensor(M_cells, mesh.num_cells, 3)
    print(f"[setup_kit] {name}: {n} nodes, {mesh.num_cells} cells", flush=True)
    site(out, f"{name}/p1_stencil_tables_direct",
         lambda: native.p1_stencil_tables_direct(mesh.coords, mesh.cells, Mc, 64, n),
         lambda: native.p1_stencil_tables_direct_twin(mesh.coords, mesh.cells, Mc, 64, n), repeats=repeats)
    assembly(out, f"{name}/assembly", V, M_cells, repeats)


def card_line() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "no card"
    except OSError:
        return "no card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    tic = time.perf_counter()
    native.library()
    out: dict = {"card": card_line(), "kit_load_s": time.perf_counter() - tic}
    print(f"[setup_kit] host of: {out['card']}; kit built or loaded in {out['kit_load_s']:.2f} s", flush=True)
    lv_case(out)
    mesh, M, _, _ = niederer_setup(SLAB_DX)
    slab_case(out, f"slab dx={SLAB_DX}", mesh, M)
    del mesh
    ecg = get_3D_slab_geometry(None, dx=ECG_DX, Lx=LX, Ly=LY, Lz=LZ).mesh
    slab_case(out, f"ecg dx={ECG_DX}", ecg, 1.0, 1)
    out["seconds"] = time.perf_counter() - tic
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
