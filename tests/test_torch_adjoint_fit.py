"""The port's fit harnesses against the JAX package's, float64 on the CPU.

- ``benchmarks/conductivity_fit.py --quick`` (FitzHugh-Nagumo on the 16x16
  square, 60 steps, 12 Adam iterations in log space) against
  ``demos/conductivity_fit.py --quick``: the loss and both conductivities
  at every iteration within 1e-8 relative (torch's Adam and optax's adam
  are one formula, rounded in other orders).
- ``benchmarks/fit_scale.py``: the learning-rate schedule of ``adam``
  equals optax's hold-then-decay ``join_schedules`` at every iteration;
  the ``lv`` and ``slab`` problems (probes, stiffness components) equal
  JAX's; ``run_fdcheck`` at dx=1.0, T=30 ms, 20 ms windows, rel_eps 0.05
  (the JAX package's ``tests/test_fit.py`` gate) in float32 on the CPU:
  the windowed gradient's signs match central finite differences of the
  true loss and the log-space cosine is above 0.7 (about 50 s).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu.benchmarks import fit_scale as jfit
from fenicsx_beat_tpu_torch.benchmarks import conductivity_fit as tdemo
from fenicsx_beat_tpu_torch.benchmarks import fit_scale as tfit

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_conductivity_fit_matches_the_jax_demo(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        from demos import conductivity_fit as jdemo
    finally:
        sys.path.remove(str(ROOT))
    jdemo.main(["--quick", "-o", str(tmp_path / "jax")])
    g = tdemo.main(["--quick", "--device", "cpu", "-o", str(tmp_path / "torch")])
    jh = np.loadtxt(tmp_path / "jax" / "fit_history.csv", skiprows=1)
    th = np.loadtxt(tmp_path / "torch" / "fit_history.csv", skiprows=1)
    assert th.shape == jh.shape == (12, 4)
    np.testing.assert_allclose(th, jh, rtol=1e-8)
    np.testing.assert_allclose(g, th[-1, 2:], rtol=0)


@pytest.mark.parametrize("n_iters", [3, 12])
def test_adam_schedule_matches_optax(n_iters):
    import optax

    lr = 0.15
    hold = max(n_iters // 2, 1)
    ref = optax.join_schedules(
        [optax.constant_schedule(lr),
         optax.exponential_decay(lr, transition_steps=max(n_iters - hold, 1), decay_rate=0.2)],
        [hold],
    )
    theta = torch.zeros(2, dtype=torch.float64, requires_grad=True)
    opt, sched = tfit.adam(theta, lr, n_iters)
    got = []
    for _ in range(n_iters):
        got.append(opt.param_groups[0]["lr"])
        theta.grad = torch.ones_like(theta)
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, [float(ref(k)) for k in range(n_iters)], rtol=1e-12)


@pytest.mark.parametrize("case", ["lv", "slab"])
def test_fit_problems_match_jax(case):
    if case == "lv":
        jm, jI, jc, jp = jfit._lv_problem(0.8, np.float64)
        tm, tI, tc, tp = tfit._lv_problem(0.8)
    else:
        jm, jI, jc, jp = jfit._slab_problem(1.0, np.float64)
        tm, tI, tc, tp = tfit._slab_problem(1.0)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tp, jp)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tI.dz.entities(), jI.dz.entities())
    assert tI.expr.amplitude == jI.expr.amplitude and tI.expr.duration == jI.expr.duration


def test_windowed_gradient_descends_true_objective():
    row = tfit.run_fdcheck(dx=1.0, T=30.0, window_ms=20.0, rel_eps=0.05, device="cpu")
    assert row["signs_match"], row
    assert row["cosine_log_space"] > 0.7, row
