"""The sharded monodomain solver on the card at world size 1 over NCCL,
without JAX.

One rank spawned in an NCCL group (``spawn_ranks(..., backend="nccl")``)
runs the dx=1.0 Niederer slab for 2 ms on its card: B1, B3, B4 and B5 are
launched, every value is finite, and the activation times lie within one
dt of the fused solver's on the same card (float32; the two PCGs issue
different kernel sequences, B5 with B3 and B4 against B2·B4 with B3).
Imports neither JAX nor the JAX package, so the card's machine runs it as
it is::

    python -m pytest --noconftest tests/test_torch_parallel_card.py -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch.fused import FusedMonodomainSolver
from fenicsx_beat_tpu_torch.parallel import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402


@pytest.mark.cuda
def test_world_one_nccl_matches_fused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    got = spawn_ranks(R.card_slab, 1, backend="nccl", timeout=300.0)[0]
    assert got["backend"] == "nccl"
    assert all(n > 0 for n in got["launches"].values()), got["launches"]
    assert got["launches"]["b3"] == got["cg"]
    f = FusedMonodomainSolver(**R.niederer_setup())
    f.solve((0.0, R.T_SHORT), dt=R.DT)
    act = f.activation_times()
    assert np.isfinite(got["v"]).all() and got["v"].max() > 0.0
    fired = (act >= 0) & (got["act"] >= 0)
    assert np.count_nonzero((act >= 0) != (got["act"] >= 0)) <= 0.005 * act.size
    assert np.abs(act[fired] - got["act"][fired]).max() <= R.DT + 1e-6
