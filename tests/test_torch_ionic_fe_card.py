"""Forward Euler of TP06, ToR-ORd dynCl and ToR-ORd dynCl + Land on the
card, without JAX.

On the CPU: each model's ``forward_euler`` is registered with its three
wrappers, and a marker layer that takes a field steps on its twins with no
launch counted.  On the card (``-m cuda``): the nine forward-Euler kernels
(B1, B1's per-node form, B7) one step against their twins at n = 4,096 by
the one-step limits, nodes of no layer equal, each wrapper counting its
launch; a uniform field gives B1's bits.  Imports neither JAX nor the JAX
package, so the card's machine runs it as it is::

    python -m pytest --noconftest tests/test_torch_ionic_fe_card.py -m cuda
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu_torch.benchmarks import kernel_check as kc
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as tp06
from fenicsx_beat_tpu_torch.models import torord_dyncl as torord
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as land
from fenicsx_beat_tpu_torch.ops import cuda_ode

MODELS = {"tp06": tp06, "torord_dyncl": torord, "torord_dyncl_land": land}


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


def table(module) -> np.ndarray:
    stim = "stim_amplitude" if "stim_amplitude" in module._PARAM_NAMES else "i_Stim_Amplitude"
    return np.stack([module.init_parameter_values(**{stim: 0.0}, celltype=ct) for ct in kc.CELLTYPES])


@pytest.mark.parametrize("name", list(MODELS))
def test_fe_layer_runs_its_twins_on_the_cpu(name):
    """A field layer of forward Euler on the CPU: the per-node twin on the
    marker's nodes, no launch counted."""
    module = MODELS[name]
    spec = cuda_ode.ionic_model(module.forward_euler)
    n = 300
    mask = np.arange(n) % 3 == 0
    g = cuda_ode.field_group(mask, spec, np.tile(table(module)[1][:, None], (1, n)), torch.device("cpu"),
                             torch.float64)
    rng = np.random.default_rng(3)
    S = torch.tensor(kc.check_states(name, n, rng))
    v = torch.tensor(rng.uniform(-90.0, 40.0, n))
    before = spec.node_step.launches
    out = cuda_ode.field_step(S.clone(), v, g, 0.5, 0.05)
    ref = S[:, mask].clone()
    ref[0] = v[mask]
    ref = module.forward_euler(ref, 0.5, table(module)[1], 0.05)
    torch.testing.assert_close(out[:, mask], ref, rtol=1e-12, atol=0)
    assert torch.equal(out[:, ~mask], S[:, ~mask])
    assert spec.node_step.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_fe_kernels_match_twins_on_card(cuda_device, name):
    module = MODELS[name]
    spec = cuda_ode.ionic_model(module.forward_euler)
    rng = np.random.default_rng(11)
    n = 4096
    launches = [f.launches for f in (spec.step, spec.node_step, spec.multi_step)]
    res = kc.ionic_form_checks(spec, kc.check_states(name, n, rng), rng.uniform(-90.0, 40.0, n), table(module),
                               None, rng, device=cuda_device, beat_steps=0)
    for form, r in res["forms"].items():
        for (t, dt, g), (a, e) in r["step"].items():
            if g == "no layer":
                assert a == 0.0, form
            else:
                assert float(e.max()) <= kc.IONIC_STEP_TOL, (form, t, dt, g, e.tolist())
    assert res["uniform_bits"]
    assert all(f.launches > c for f, c in zip((spec.step, spec.node_step, spec.multi_step), launches))
