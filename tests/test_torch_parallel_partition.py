"""The port's partition functions against the JAX package's.

Every function of ``fenicsx_beat_tpu_torch/parallel/partition.py`` fed the
JAX package's global operator arrays (carried across by
``convert.stencil_from_numpy`` and ``convert.ell_from_numpy``) returns
JAX's outputs exactly, on the dx=1.0 slab and the psize 0.6 LV (RCM
renumbered, so its apex rows spill into the COO tail).  ``lane.py``'s CSR
blocks differ from JAX's TPU page layout by design and are held by their
product against JAX's packed product (its lane-gather kernel in interpret
mode), to f64 rounding.  The partitioned product over halo-extended
blocks equals the global one, in one process.  Every name the JAX
``parallel`` package and its modules export is present in the port's.
"""

import importlib

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as jslab
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.native import rcm_ordering as jrcm
from fenicsx_beat_tpu.ops.pallas_ell import LaneGatherMatrix
from fenicsx_beat_tpu.parallel import lane as jlane
from fenicsx_beat_tpu.parallel import partition as jpart
from fenicsx_beat_tpu.parallel.solver import ell_adjacency as jadjacency
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch.convert import ell_from_numpy, rank_blocks, stencil_from_numpy
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry as tslab
from fenicsx_beat_tpu_torch.native import rcm_ordering as trcm
from fenicsx_beat_tpu_torch.parallel import lane as tlane
from fenicsx_beat_tpu_torch.parallel import partition as tpart
from fenicsx_beat_tpu_torch.parallel.solver import ell_adjacency as tadjacency

DEVICES = (2, 4, 8)
MODULES = ("", ".distributed", ".partition", ".lane", ".solver", ".bidomain", ".adjoint")


def _equal(a, b):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert (a is None) == (b is None) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def slab():
    V = jfem.functionspace(jslab(None, dx=1.0, Lx=20.0, Ly=7.0, Lz=3.0).mesh, ("P", 1))
    m_st, k_st = jfem.assemble_mass_stiffness_stencil(V, 1.0)
    mass, stiff = jfem.assemble_mass_stiffness(V, 1.0)
    return V, (m_st, k_st), (mass, stiff)


@pytest.fixture(scope="module")
def lv():
    """The psize 0.6 LV's ELL pair, RCM-renumbered as the sharded solvers
    renumber it."""
    mesh = jlv(None, psize_ref=0.6).mesh
    V = jfem.functionspace(mesh, ("P", 1))
    mass, _ = jfem.assemble_mass_stiffness(V, 1.0)
    perm = jrcm(*jadjacency(mass)).astype(np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size)
    from fenicsx_beat_tpu.mesh import Mesh

    pm = Mesh(coords=mesh.coords[perm], cells=iperm[mesh.cells.astype(np.int64)].astype(np.int32),
              cell_type=mesh.cell_type)
    Vp = jfem.functionspace(pm, ("P", 1))
    mass, stiff = jfem.assemble_mass_stiffness(Vp, 0.2)
    assert mass.has_tail
    return V, perm, iperm, (mass, stiff)


def _port_ell(A):
    if A.has_tail:
        return ell_from_numpy(A.cols, A.vals, A.shape, A.tail_rows, A.tail_cols, A.tail_vals)
    return ell_from_numpy(A.cols, A.vals, A.shape)


@pytest.mark.parametrize("nd", DEVICES)
def test_partition_stencil_and_nodes_equal_jax(slab, nd):
    V, (m_st, k_st), _ = slab
    n = V.ndofs
    assert tpart.partition_nodes(n, nd) == jpart.partition_nodes(n, nd)
    for A, pad in ((m_st, 1.0), (k_st, 0.0)):
        tA = stencil_from_numpy(A.offsets, np.asarray(A.vals))
        jp, jvals = jpart.partition_stencil(A, nd, diag_pad=pad)
        tp, tvals = tpart.partition_stencil(tA, nd, diag_pad=pad)
        assert (tp.n_global, tp.n_devices, tp.n_local, tp.halo) == (jp.n_global, jp.n_devices, jp.n_local, jp.halo)
        _equal(tvals, jvals)
        x = np.arange(n, dtype=np.float64)[None].repeat(2, 0)
        _equal(tpart.pad_global(x, tp, fill=-1.0), jpart.pad_global(x, jp, fill=-1.0))


@pytest.mark.parametrize("nd", DEVICES)
@pytest.mark.parametrize("mesh", ["slab", "lv"])
def test_partition_ell_equals_jax(slab, lv, mesh, nd):
    """Columns, values, halo and the per-rank COO tail, bit for bit."""
    ops = slab[2] if mesh == "slab" else lv[3]
    for A in ops:
        jp, jc, jv, jt = jpart.partition_ell(A, nd)
        tp, tc, tv, tt = tpart.partition_ell(_port_ell(A), nd)
        assert (tp.n_local, tp.halo, tp.n_pad) == (jp.n_local, jp.halo, jp.n_pad)
        _equal(tc, jc)
        _equal(tv, jv)
        _equal(tt, jt)
        assert (tt is not None) == (mesh == "lv")


@pytest.mark.parametrize("nd", DEVICES)
def test_partition_quadrature_equals_jax(lv, nd):
    """The per-rank element tables of a general stimulus, renumbered by the
    LV's RCM permutation, from JAX's quadrature data."""
    V, perm, iperm, (mass, _) = lv
    quad = jfem.cell_quadrature(V, np.arange(0, V.mesh.num_cells, 7), degree=2)
    jp = jpart.partition_ell(mass, nd)[0]
    tp = tpart.Partition1D(jp.n_global, jp.n_devices, jp.n_local, jp.halo)
    for a, b in zip(tpart.partition_quadrature(quad, tp, iperm), jpart.partition_quadrature(quad, jp, iperm)):
        _equal(a, b)


def test_ell_adjacency_and_rcm_equal_jax(lv):
    """The RCM input graph and permutation the sharded solvers renumber by."""
    V, perm, _, _ = lv
    mass, _ = jfem.assemble_mass_stiffness(V, 1.0)
    j_adj = jadjacency(mass)
    t_adj = tadjacency(_port_ell(mass))
    for a, b in zip(t_adj, j_adj):
        _equal(a, b)
    np.testing.assert_array_equal(trcm(*t_adj), perm)


@pytest.mark.parametrize("nd", (2, 4))
def test_lane_blocks_product_equals_jax_packed_product(lv, nd):
    """Each rank's CSR block (mass and stiffness on one layout, the apex
    tail merged into its rows) times the halo-extended vector equals JAX's
    lane-gather pack with its tail (interpret mode) to f64 rounding; the
    diagonal streams are JAX's exactly.  The rank's blocks are cut from
    JAX's stacked arrays by ``convert.rank_blocks``."""
    _, _, _, (mass, stiff) = lv
    jp, cols3, vm3, tm = jpart.partition_ell(mass, nd)
    _, _, vk3, tk = jpart.partition_ell(stiff, nd)
    tail = (tm[0], tm[1], tm[2], tk[2])
    ri4, l5, (jvm, jvk), jdiags, jtails, meta = jlane.partition_lane_gather(
        jp, cols3, [vm3, vk3], tail, np.float64, max_planes=16)
    assert jtails is not None  # JAX's pack overflows into its own tail at 16 planes
    tp = tpart.Partition1D(jp.n_global, jp.n_devices, jp.n_local, jp.halo)
    rng = np.random.default_rng(0)
    n_ext = jp.n_local + 2 * jp.halo
    for d in range(nd):
        blk = rank_blocks({"cols": cols3, "vm": vm3, "vk": vk3, "tr": tail[0], "tc": tail[1], "tvm": tail[2],
                           "tvk": tail[3]}, d, nd)
        blk = {k: v.numpy()[None] for k, v in blk.items()}
        blocks, diags, tmeta = tlane.partition_lane_gather(
            tp, blk["cols"], [blk["vm"], blk["vk"]], (blk["tr"], blk["tc"], blk["tvm"], blk["tvk"]))
        assert tmeta["n_ext"] == meta["n_ext"] == n_ext
        x = rng.standard_normal(n_ext)
        for k, (jv5, jd) in enumerate(((jvm, jdiags[0]), (jvk, jdiags[1]))):
            L = LaneGatherMatrix(rowidx=ri4[d], lanes=l5[d], vals=jv5[d], shape=(jp.n_local, n_ext),
                                 Rc=meta["Rc"], interpret=True)
            want = np.asarray(L @ x)
            ttr, ttc, *ttv = jtails
            np.add.at(want, ttr[d], ttv[k][d] * x[ttc[d]])
            got = (blocks[0][k] @ torch.as_tensor(x)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
            _equal(diags[k][0], jd[d])
            np.testing.assert_array_equal(blocks[0][k].diag.numpy(), jd[d])


@pytest.mark.parametrize("nd", (2, 8))
def test_partitioned_spmv_matches_global(nd):
    """The port's own assembly, partitioned: the product over each rank's
    halo-extended block equals the global product (JAX's
    ``test_partitioned_spmv_matches_global``)."""
    V = tfem.functionspace(tslab(None, dx=1.0, Lx=10.0, Ly=5.0, Lz=3.0).mesh, ("P", 1))
    _, stiff = tfem.assemble_mass_stiffness(V, 1.0)
    part, cols, vals, tail = tpart.partition_ell(stiff, nd)
    assert tail is None
    x = np.random.default_rng(0).standard_normal(V.ndofs)
    y_ref = (stiff @ torch.as_tensor(x)).numpy()
    xl = tpart.pad_global(x, part).reshape(nd, part.n_local)
    H = part.halo
    y = np.zeros(part.n_pad)
    for d in range(nd):
        left = xl[d - 1][-H:] if d > 0 else np.zeros(H)
        right = xl[d + 1][:H] if d < nd - 1 else np.zeros(H)
        x_ext = np.concatenate([left, xl[d], right])
        y[d * part.n_local : (d + 1) * part.n_local] = np.sum(vals[d] * x_ext[cols[d]], axis=1)
    np.testing.assert_allclose(y[: V.ndofs], y_ref, rtol=1e-10, atol=1e-12)


def test_rank_blocks_cuts_stacked_and_node_axes():
    stacked = np.arange(2 * 3 * 4, dtype=np.float64).reshape(2, 3, 4)
    states = np.arange(5 * 6, dtype=np.float64).reshape(5, 6)
    out = rank_blocks({"v": stacked, "s": states, "c": stacked.astype(np.int32)}, 1, 2, node_axis={"s": -1},
                      dtype=torch.float32)
    np.testing.assert_array_equal(out["v"].numpy(), stacked[1])
    np.testing.assert_array_equal(out["s"].numpy(), states[:, 3:])
    assert out["v"].dtype == torch.float32 and out["c"].dtype == torch.int32
    with pytest.raises(ValueError):
        rank_blocks({"v": stacked}, 0, 3)


@pytest.mark.parametrize("suffix", MODULES)
def test_every_jax_export_present(suffix):
    """Each name that ``fenicsx_beat_tpu.parallel`` and its modules export
    (``__all__`` and their own public definitions) exists in the port's
    module of the same name."""
    jm = importlib.import_module("fenicsx_beat_tpu.parallel" + suffix)
    tm = importlib.import_module("fenicsx_beat_tpu_torch.parallel" + suffix)
    names = set(getattr(jm, "__all__", ()))
    names |= {k for k, v in vars(jm).items()
              if not k.startswith("_") and getattr(v, "__module__", None) == jm.__name__}
    if not suffix:
        names |= {k for k in vars(jm) if not k.startswith("_") and k not in ("annotations",)}
    missing = sorted(k for k in names if not hasattr(tm, k))
    assert not missing, f"fenicsx_beat_tpu_torch.parallel{suffix} lacks {missing}"


def test_census_on_gloo_ranks():
    """``benchmarks/multichip.py``'s weak-scaling census at 1 and 2 gloo
    ranks: the block stays about the same size, one exchange a CG
    iteration plus the right-hand side's and the initial residual's, two
    all-reduces a CG iteration plus the start's, halo bytes only between
    ranks (each of the H rows a product, f64)."""
    from fenicsx_beat_tpu_torch.benchmarks.multichip import run_census

    rows = run_census((1, 2), device="cpu", dx=0.5, n_steps=10, timeout=120.0)["weak_scaling"]
    one, two = rows
    assert (one["devices"], two["devices"]) == (1, 2)
    assert abs(two["n_local"] - one["n_local"]) <= 0.05 * one["n_local"] and one["halo_rows"] == two["halo_rows"]
    for r in rows:
        cg = r["cg_iters_per_step"] * 10
        assert r["exchanges_per_chunk"] == cg + 2 * 10
        assert r["all_reduces_per_chunk"] == 2 * cg + 10
    assert one["halo_bytes_per_step"] == 0 and one["halo_traffic_fraction"] == 0
    assert two["halo_bytes_per_step"] == two["halo_rows"] * 8 * (two["cg_iters_per_step"] + 2)


def test_parallel_imports_neither_jax_nor_the_jax_package():
    """The sharded layer, its census and the ranks' module import no JAX
    (a fresh interpreter, as a spawned rank starts)."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys; sys.path.insert(0, 'tests'); "
        "import fenicsx_beat_tpu_torch.parallel, fenicsx_beat_tpu_torch.parallel.adjoint, "
        "fenicsx_beat_tpu_torch.parallel.lane, fenicsx_beat_tpu_torch.benchmarks.multichip, torch_parallel_ranks; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'fenicsx_beat_tpu' or m.startswith('fenicsx_beat_tpu.')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
