"""The whole LV slice at psize 0.8, the port against the JAX package in f64
on the CPU (the port on its kernels' twins): three TP06 layers, the ENDO
facet stimulus, Strang, 40 steps, against the JAX ``FusedMonodomainSolver``
on its plain path and on its Pallas-interpret path (lane-gather SpMV and
the multi-marker kernel).  States within atol 1e-8 (CG rtol 1e-8 on both
sides, sums in other orders) and activation times equal.  (Split from
``tests/test_torch_lv.py``, which keeps the geometry, the layers and the
twins' run.)
"""

import numpy as np
import pytest
import torch

from torch_lv_reference import jax_lv_solver

from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import lv as tlv

PSIZE, DT, N_STEPS = 0.8, 0.05, 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():  # module scope: set before the module-scoped run below
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_run():
    probes = tlv.lv_probe_points(PSIZE)
    ts = tlv.build_lv_solver(psize=PSIZE, device="cpu", probe_points=np.array(list(probes.values())))
    assert ts.solve((0.0, N_STEPS * DT), dt=DT) == Status.OK
    return ts


@pytest.mark.parametrize("route", ["plain", "pallas_interpret"])
def test_lv_slice_matches_jax(port_run, route):
    kw = {"use_pallas_ode": False}
    if route == "pallas_interpret":
        kw = {"use_pallas_ode": True, "pallas_spmv_min_nodes": 1}
    probes = tlv.lv_probe_points(PSIZE)
    js, layers = jax_lv_solver(PSIZE, probe_points=np.array(list(probes.values())), **kw)
    if route == "pallas_interpret":
        assert js._lane_gather  # the unstructured TPU path engaged
    assert js.solve((0.0, N_STEPS * DT), dt=DT).name == "OK"
    ts = port_run
    np.testing.assert_array_equal(ts._ionic_groups[0].index.numpy(), np.asarray(layers.x.array).astype(np.int32))
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states), rtol=0, atol=1e-8)
    act = ts.activation_times()
    np.testing.assert_array_equal(act, np.asarray(js.activation_times()))
    assert (act >= 0).sum() > 0  # the stimulated endocardium fired
    # the unstructured PCG tests its exit once per iteration, plus once
    assert ts.host_syncs >= 2 * N_STEPS
    pdofs, pw = js._probe_tables
    jp = (np.asarray(js.activation_times())[pdofs] * pw).sum(axis=1)
    tp = (ts.activation_time[ts._probe_dofs] * ts._probe_w).sum(dim=1).numpy()
    np.testing.assert_array_equal(tp, jp)
