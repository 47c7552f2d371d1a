"""The SA-AMG V-cycle's products on B8 (``csrc/csr_spmv.cu``), without JAX.

On the CPU: a hierarchy on the CPU counts no B8 launch.  On the card
(``-m cuda``): every level's ``A``, ``P`` and ``R`` of the psize 0.8 LV's
hierarchy (the bidomain's options, four levels) on B8 against its twin,
within 1e-4 of max|twin|; one V-cycle on the card launches B8
``2 * degree + 2`` times a level and lands within 1e-4 of max|twin| of the
float64 V-cycle on the CPU; the Laplace solve on "amg" within 1e-4 of the
CPU's float64 one.  Imports neither JAX nor the JAX package, so the card's
machine runs it as it is::

    python -m pytest --noconftest tests/test_torch_amg_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch import fem, utils
from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors, conductivity_tensor
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.ops import amg, cuda_ell

REL_TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _hierarchy():
    """The psize 0.8 LV's bidomain K_ie, its hierarchy at the bidomain's
    options with a small coarse size (so it has levels)."""
    geo = get_lv_ellipsoid_geometry(psize_ref=0.8)
    V = fem.functionspace(geo.mesh, ("P", 1))
    Mi = as_cell_tensors(conductivity_tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0), geo.mesh)
    Me = as_cell_tensors(conductivity_tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0), geo.mesh)
    _, Ki = fem.assemble_mass_stiffness(V, Mi)
    _, Ke = fem.assemble_mass_stiffness(V, Me)
    K = Ki.combine(1.0, Ke, 1.0)
    return K, amg.build_amg(K, semidefinite=True, strength_theta=(0.15, 0.05), omega=0.0, coarse_n=100)


def _residual(n):
    r = np.random.default_rng(5).standard_normal(n)
    return r - r.mean()


def test_cpu_hierarchy_runs_the_twin():
    K, h = _hierarchy()
    assert h.n_levels >= 3
    hd = h.to_device(CPU)
    assert hd.coarse_inv.dtype == torch.float64
    before = cuda_ell.csr_spmv.launches
    z = amg.amg_apply(hd, torch.as_tensor(_residual(K.shape[0])))
    assert cuda_ell.csr_spmv.launches == before and bool(torch.isfinite(z).all())


@pytest.mark.cuda
def test_levels_on_b8_match_twin(cuda_device):
    K, h = _hierarchy()
    hd = h.to_device(cuda_device)
    rng = np.random.default_rng(2)
    for k, lv in enumerate(hd.levels):
        for name in ("A", "P", "R"):
            M = getattr(lv, name)
            assert M.vals.device.type == "cuda" and M.vals.dtype == torch.float32
            x = torch.as_tensor(rng.standard_normal(M.shape[1]), device=cuda_device).float()
            before = cuda_ell.csr_spmv.launches
            y = cuda_ell.csr_spmv(M, x)
            assert cuda_ell.csr_spmv.launches == before + 1
            t = cuda_ell.csr_spmv_twin(M, x)
            assert float((y - t).abs().max()) <= REL_TOL * float(t.abs().max()), (k, name)


@pytest.mark.cuda
def test_vcycle_on_card_matches_cpu(cuda_device):
    K, h = _hierarchy()
    r = _residual(K.shape[0])
    z_cpu = amg.amg_apply(h.to_device(CPU), torch.as_tensor(r)).numpy()
    hd = h.to_device(cuda_device)
    before = cuda_ell.csr_spmv.launches
    z = amg.amg_apply(hd, torch.as_tensor(r, device=cuda_device).float())
    torch.cuda.synchronize()
    assert cuda_ell.csr_spmv.launches - before == (2 * h.degree + 2) * len(h.levels)
    err = np.abs(z.cpu().numpy().astype(np.float64) - z_cpu).max()
    assert err <= REL_TOL * np.abs(z_cpu).max(), err
    assert torch.equal(z, amg.amg_apply(hd, torch.as_tensor(r, device=cuda_device).float()))


@pytest.mark.cuda
def test_laplace_amg_on_card_matches_cpu(cuda_device):
    geo = get_lv_ellipsoid_geometry(psize_ref=0.3)  # 9,780 dofs: "auto" takes AMG
    V = fem.functionspace(geo.mesh, ("P", 1))
    bcs = [fem.dirichletbc(0.0, fem.locate_dofs_topological(V, 2, geo.ffun.find(6)), V),
           fem.dirichletbc(1.0, fem.locate_dofs_topological(V, 2, geo.ffun.find(7)), V)]
    ref = utils.laplace_solve(V, bcs, device="cpu")
    before = cuda_ell.csr_spmv.launches
    u, info = utils._laplace_solve(V, bcs, device=cuda_device)
    assert info.precond == "amg" and info.converged and info.amg_levels >= 2
    assert cuda_ell.csr_spmv.launches - before > info.iterations
    assert np.abs(u - ref).max() <= REL_TOL
