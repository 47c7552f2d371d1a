"""B8's list of long rows (``CSRMatrix.long_rows``): the rows longer than
``cuda_ell.LONG_ROW`` entries, which the kernel gives a warp each.

On the CPU: the list is found at pack time on operators with rows of 0, 1,
31, 32, 33, 64, 65 and 317 entries, square and rectangular; ``to``,
``combine`` and a matrix built from its fields alone find it again from
``indptr``, and no caller can give one; the twin's result is the float64
product's.  On the card (``-m cuda``): the
kernel against its twin on the same shapes, and two runs giving the same
bits.  Imports neither JAX nor the JAX package, so the card's machine runs
it as it is::

    python -m pytest tests/test_torch_csr_long_rows.py -m cuda
"""

from dataclasses import replace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fenicsx_beat_tpu_torch.ops import cuda_ell
from fenicsx_beat_tpu_torch.ops.cuda_ell import LONG_ROW, CSRMatrix

LENGTHS = (0, 1, 31, 32, 33, 64, 65, 317)
SHAPES = {"square": (1000, 1000), "rectangular": (600, 2100)}


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


def synthetic(shape, seed=0, values=1):
    """A CSR operator whose rows take the lengths of :data:`LENGTHS` in turn,
    each row's columns distinct and drawn at random; ``values`` value sets
    on one pattern (stacked when more than one)."""
    n_rows, n_cols = shape
    rng = np.random.default_rng(seed)
    lengths = np.array([LENGTHS[i % len(LENGTHS)] for i in range(n_rows)])
    rng.shuffle(lengths)
    rows = np.repeat(np.arange(n_rows), lengths)
    cols = np.concatenate([rng.choice(n_cols, size=k, replace=False) for k in lengths])
    mats = [sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=shape) for _ in range(values)]
    return mats, lengths


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_long_rows_listed_at_pack(shape):
    (A,), lengths = synthetic(shape)
    C = CSRMatrix.from_operator(A)
    assert C.long_rows.dtype == torch.int32
    np.testing.assert_array_equal(C.long_rows.numpy(), np.nonzero(lengths > LONG_ROW)[0])
    assert set(lengths[C.long_rows.numpy()]) == {33, 64, 65, 317}


def test_long_rows_found_again_by_to_and_combine():
    (A, B), lengths = synthetic(SHAPES["square"], seed=1, values=2)
    Ca, Cb = CSRMatrix.from_operator_pair(A, B)
    assert torch.equal(Ca.long_rows, Cb.long_rows)
    C = Ca.to("cpu", torch.float32).combine(1.0, Cb.to("cpu", torch.float32), 0.025)
    np.testing.assert_array_equal(C.long_rows.numpy(), np.nonzero(lengths > LONG_ROW)[0])
    assert C.long_rows.dtype == torch.int32 and C.vals.dtype == torch.float32


def test_long_rows_cannot_be_given():
    (A,), lengths = synthetic(SHAPES["square"], seed=9)
    C = CSRMatrix.from_operator(A)
    with pytest.raises(TypeError):
        CSRMatrix(indptr=C.indptr, cols=C.cols, vals=C.vals, shape=C.shape, long_rows=C.long_rows[:1])
    with pytest.raises(ValueError):
        replace(C, long_rows=C.long_rows[:1])
    np.testing.assert_array_equal(replace(C).long_rows.numpy(), np.nonzero(lengths > LONG_ROW)[0])


def test_long_rows_found_from_the_fields_alone():
    (A,), lengths = synthetic(SHAPES["rectangular"], seed=2)
    C = CSRMatrix.from_operator(A)
    bare = CSRMatrix(indptr=C.indptr, cols=C.cols, vals=C.vals, shape=C.shape)
    assert torch.equal(bare.long_rows, C.long_rows)
    none = CSRMatrix.from_operator(sp.identity(50, format="csr"))
    assert none.long_rows.shape == (0,) and none.long_rows.dtype == torch.int32


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_twin_on_long_rows_is_the_product(shape):
    (A,), _ = synthetic(shape, seed=3)
    x = np.random.default_rng(4).standard_normal(shape[1])
    before = cuda_ell.csr_spmv.launches
    y = cuda_ell.csr_spmv(CSRMatrix.from_operator(A), torch.tensor(x))
    assert cuda_ell.csr_spmv.launches == before  # the CPU runs the twin
    np.testing.assert_allclose(y.numpy(), A @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_kernel_matches_twin_on_long_rows(cuda_device, shape):
    (A,), _ = synthetic(shape, seed=5)
    C = CSRMatrix.from_operator(A).to(cuda_device, torch.float32)
    x = torch.tensor(np.random.default_rng(6).uniform(-90, 40, shape[1]), dtype=torch.float32, device=cuda_device)
    before = cuda_ell.csr_spmv.launches
    yk = cuda_ell.csr_spmv(C, x)
    assert cuda_ell.csr_spmv.launches == before + 1
    yt = cuda_ell.csr_spmv_twin(C, x)
    assert float((yk - yt).abs().max()) <= 1e-4 * float(yt.abs().max())
    assert torch.equal(yk[C.indptr[1:] == C.indptr[:-1]], torch.zeros_like(yk[C.indptr[1:] == C.indptr[:-1]]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_kernel_repeats_its_bits(cuda_device, shape):
    (A,), _ = synthetic(shape, seed=7)
    C = CSRMatrix.from_operator(A).to(cuda_device, torch.float32)
    x = torch.tensor(np.random.default_rng(8).standard_normal(shape[1]), dtype=torch.float32, device=cuda_device)
    first = cuda_ell.csr_spmv(C, x)
    assert all(torch.equal(first, cuda_ell.csr_spmv(C, x)) for _ in range(20))
