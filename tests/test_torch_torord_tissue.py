"""The ToR-ORd dynCl tissue paths: the slab demo at its quick size (dx=0.1
bar) and the LV with ToR-ORd layers at psize 0.8, the port against the JAX
``FusedMonodomainSolver`` on its plain and Pallas-interpret routes, f64 on
the CPU (the port on its kernels' twins): states within atol 1e-8 (CG rtol
1e-8 on both sides, sums in other orders), activation times equal.
"""

import numpy as np
import pytest

from torch_lv_reference import jax_lv_solver, jax_slab_solver, probe_values

from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import lv as tlv
from fenicsx_beat_tpu_torch.benchmarks import slab as tslab
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor

SLAB_STEPS = 60  # the demo's quick horizon, 3 ms at dt = 0.05


@pytest.fixture(scope="module")
def slab_port():
    ts = tslab.build_slab_solver(dx=0.1, device="cpu")
    assert ts.solve((0.0, SLAB_STEPS * 0.05), dt=0.05, save_freq=20) == Status.OK
    return ts


@pytest.mark.parametrize("route", ["plain", "pallas_interpret"])
def test_slab_demo_matches_jax(slab_port, route):
    kw = {"use_pallas_ode": False} if route == "plain" else {"use_pallas_ode": True, "pallas_spmv_min_nodes": 1}
    js = jax_slab_solver(0.1, **kw)
    assert js.solve((0.0, SLAB_STEPS * 0.05), dt=0.05, save_freq=20).name == "OK"
    ts = slab_port
    assert ts.V.ndofs == 1836 and ts._structured
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states)[:, : ts._n], rtol=0, atol=1e-8)
    act = ts.activation_times()
    np.testing.assert_array_equal(act, np.asarray(js.activation_times())[: ts._n])
    assert (act >= 0).sum() > 0  # the stimulated face fired
    tp = (ts.activation_time[ts._probe_dofs] * ts._probe_w).sum(dim=1).numpy()
    np.testing.assert_array_equal(tp, probe_values(js))


def test_run_slab_reports_the_demo_probes():
    res = tslab.run_slab(dx=0.1, T=1.0, device="cpu")
    assert res.n_nodes == 1836 and res.n_steps == 20 and res.all_finite and res.device == "cpu"
    assert res.t1 == res.t2 == -1.0 and res.cv_cm_per_ms is None  # the wave needs ~6 ms to x = 0.3


LV_PSIZE, LV_STEPS = 0.8, 40


@pytest.fixture(scope="module")
def lv_port():
    probes = tlv.lv_probe_points(LV_PSIZE)
    ts = tlv.build_lv_solver(psize=LV_PSIZE, device="cpu", model="torord_dyncl",
                             probe_points=np.array(list(probes.values())))
    assert ts.solve((0.0, LV_STEPS * 0.05), dt=0.05) == Status.OK
    return ts


@pytest.mark.parametrize("route", ["plain", "pallas_interpret"])
def test_torord_lv_layers_match_jax(lv_port, route):
    kw = {"use_pallas_ode": False} if route == "plain" else {"use_pallas_ode": True, "pallas_spmv_min_nodes": 1}
    probes = tlv.lv_probe_points(LV_PSIZE)
    js, layers = jax_lv_solver(LV_PSIZE, probe_points=np.array(list(probes.values())), model="torord_dyncl", **kw)
    assert js.solve((0.0, LV_STEPS * 0.05), dt=0.05).name == "OK"
    ts = lv_port
    assert ts._ionic.name == "torord_dyncl" and ts.states.shape[0] == 45
    np.testing.assert_array_equal(ts._ionic_groups[0].index.numpy(), np.asarray(layers.x.array).astype(np.int32))
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states)[:, : ts._n], rtol=0, atol=1e-8)
    act = ts.activation_times()
    np.testing.assert_array_equal(act, np.asarray(js.activation_times())[: ts._n])
    assert (act >= 0).sum() > 0
    tp = (ts.activation_time[ts._probe_dofs] * ts._probe_w).sum(dim=1).numpy()
    np.testing.assert_array_equal(tp, probe_values(js))


def test_lv_starts_from_the_given_layer_states(lv_port):
    """``init_states`` (the pre-paced steady states) seed each layer."""
    steady = {m: ttor.init_state_values(v=-85.0 - m) for m in tlv.CELLTYPES}
    ts = tlv.build_lv_solver(psize=LV_PSIZE, device="cpu", model="torord_dyncl", init_states=steady,
                             layers=lv_port._ionic_groups[0].index.numpy())
    index = ts._ionic_groups[0].index.numpy()
    for i, m in enumerate(sorted(tlv.CELLTYPES)):
        assert np.all(ts.states[0].numpy()[index == i] == -85.0 - m)
