"""The ionic models' steps with their parameters in the autograd graph,
the differentiable solver's ionic stage (``ionic`` of
``fenicsx_beat_tpu_torch.adjoint.build_diff_simulator``), against the JAX
package in float64 on the CPU.

For TP06, FitzHugh-Nagumo, ToR-ORd dynCl and ToR-ORd dynCl + Land, GRL and
forward Euler, at perturbed states inside the pacing window: the step with
the parameter vector as a tensor that requires grad equals the step with
it as floats (rtol 1e-13: parameter-only terms in float64 either way), its
backward runs with warnings raised as errors, and the parameter gradient
of a weighted sum of the step equals JAX's (rtol 1e-8: the two frameworks'
exp/log/pow rounding), with the same parameters at exactly zero (those no
current reads at this state and time).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models():
    from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
    from fenicsx_beat_tpu.models import torord_dyncl as jto
    from fenicsx_beat_tpu.models import torord_dyncl_land as jla
    from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
    from fenicsx_beat_tpu_torch.models import torord_dyncl as tto
    from fenicsx_beat_tpu_torch.models import torord_dyncl_land as tla

    return {"tp06": (jtp, ttp), "fhn": (jfhn, tfhn), "torord_dyncl": (jto, tto), "torord_dyncl_land": (jla, tla)}


@pytest.mark.parametrize("model", ["tp06", "fhn", "torord_dyncl", "torord_dyncl_land"])
@pytest.mark.parametrize("scheme", ["generalized_rush_larsen", "forward_euler"])
def test_model_parameter_gradients_match_jax(model, scheme):
    jm, tm = _models()[model]
    rng = np.random.default_rng(11)
    n = 6
    s0 = jm.init_state_values()
    states = s0[:, None] * (1.0 + 0.01 * rng.standard_normal((s0.size, n)))
    params = jm.init_parameter_values()
    w = rng.standard_normal(states.shape)
    t, dt = 0.5, 0.05  # inside every model's pacing window

    def jloss(p):
        return jnp.sum(jnp.asarray(w) * getattr(jm, scheme)(jnp.asarray(states), t, p, dt))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(params)))
    p = torch.tensor(params, requires_grad=True)
    st = torch.as_tensor(states)
    out = getattr(tm, scheme)(st, t, p, dt)
    ref = getattr(tm, scheme)(st, t, params, dt)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-13, atol=1e-300)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no in-place operation on a saved tensor, nothing detached
        torch.sum(torch.as_tensor(w) * out).backward()
    scale = np.abs(jg).max()
    np.testing.assert_allclose(p.grad.numpy(), jg, rtol=1e-8, atol=1e-10 * scale)
    assert np.count_nonzero(p.grad.numpy()) == np.count_nonzero(jg)
