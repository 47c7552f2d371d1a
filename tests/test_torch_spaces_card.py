"""Spaces beyond P1 on the kernels, without JAX.

On the CPU: a transfer from Quadrature points to P1 (rows of up to 192
entries) and back is one CSR product each on B8's twin, counting no
launch, and keeps a constant; the OO Niederer run on P2 takes the CSR
PCG (no stencil) and, with the ODE at the quadrature points, counts two
crossings a transfer.  On the card (``-m cuda``): B8 on those rectangular
transfers (the long rows on a warp each) against its twin, within 1e-4
of max|twin| (B8's limit in ``chip_smoke.py``); and the P2 route's
launches over 4 Strang steps: B1 twice a step, B8, and no stencil
kernel.  Imports neither JAX nor the JAX package, so the card's machine
runs it as it is::

    python -m pytest --noconftest tests/test_torch_spaces_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch import fem
from fenicsx_beat_tpu_torch.benchmarks.niederer import build_niederer_oo, niederer_setup
from fenicsx_beat_tpu_torch.ops import cuda_cg, cuda_ell, cuda_ode, cuda_spmv, cuda_stencil

STENCIL = (cuda_spmv.stencil_spmv_sym, cuda_spmv.stencil_spmv_sym_dir_dot, cuda_cg.cg_update, cuda_cg.axpy,
           cuda_stencil.stencil_spmv)


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


def quadrature_spaces(dx=1.0):
    """P1 and Quadrature_2 on the Niederer slab at ``dx``."""
    mesh = niederer_setup(dx)[0]
    return fem.functionspace(mesh, ("Quadrature", 2)), fem.functionspace(mesh, ("P", 1))


def transfer_inputs(Q, P, device, dtype):
    rng = np.random.default_rng(4)
    return (
        ("Q->P1", fem.transfer_operator(Q, P, device, dtype), torch.tensor(rng.uniform(-85, 40, Q.ndofs), dtype=dtype,
                                                                           device=device)),
        ("P1->Q", fem.transfer_operator(P, Q, device, dtype), torch.tensor(rng.uniform(-85, 40, P.ndofs), dtype=dtype,
                                                                           device=device)),
    )


def test_transfers_on_the_twin_count_no_launch():
    Q, P = quadrature_spaces()
    before = cuda_ell.csr_spmv.launches
    for name, T, x in transfer_inputs(Q, P, torch.device("cpu"), torch.float64):
        ones = torch.ones(T.shape[1], dtype=torch.float64)
        np.testing.assert_allclose(cuda_ell.csr_spmv(T, ones).numpy(), 1.0, rtol=1e-13)
        assert cuda_ell.csr_spmv(T, x).shape == (T.shape[0],)
    assert cuda_ell.csr_spmv.launches == before
    TqP = fem.transfer_operator(Q, P, torch.device("cpu"), torch.float64)
    assert int(torch.diff(TqP.indptr).max()) == 8 * 24 and TqP.long_rows.numel() > 0


@pytest.mark.parametrize("kw", [{"degree": 2}, {"ode_space": "Quadrature_2"}], ids=["p2", "q"])
def test_oo_routes_on_the_cpu(kw):
    setup = build_niederer_oo(1.0, device="cpu", **kw)
    solver = setup.solver
    assert solver.pde._pde.structured == ("ode_space" in kw)
    assert set(setup.setup_s) >= {"mesh", "space", "assembly", "packing", "stimulus", "ode"}
    before = solver.host_transfers
    solver.step((0.0, 0.05))
    crossings = 5 + (6 if "ode_space" in kw else 0)
    assert solver.host_transfers - before == crossings


@pytest.mark.cuda
def test_b8_on_rectangular_transfers_matches_twin(cuda_device):
    Q, P = quadrature_spaces(0.5)
    for name, T, x in transfer_inputs(Q, P, cuda_device, torch.float32):
        before = cuda_ell.csr_spmv.launches
        y = cuda_ell.csr_spmv(T, x)
        torch.cuda.synchronize()
        assert cuda_ell.csr_spmv.launches == before + 1
        ref = cuda_ell.csr_spmv_twin(T, x)
        assert float((y - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name


@pytest.mark.cuda
def test_p2_route_launches_b1_and_b8_only(cuda_device):
    setup = build_niederer_oo(1.0, degree=2, device=cuda_device)
    kernels = [cuda_ode.tp06_grl_step_v, cuda_ell.csr_spmv, *STENCIL]
    before = [k.launches for k in kernels]
    for k in range(4):
        setup.solver.step((k * 0.05, (k + 1) * 0.05))
    torch.cuda.synchronize()
    counts = [k.launches - b for k, b in zip(kernels, before)]
    assert counts[0] == 2 * 4
    assert counts[1] > 0
    assert not any(counts[2:])
    assert np.isfinite(setup.solver.pde.state.x.array).all()
