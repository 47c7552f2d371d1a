"""The unstructured LV slice: geometry, facet quadrature, layer labelling
and the fused solver on the LV, the port against the JAX package in f64 on
the CPU (the port on its kernels' twins).

- LV geometry arrays and facet quadrature tables: bit-equal (the same
  numpy formulas).
- ``expand_layer`` labels at psize 0.8 (1,083 dofs: JAX's Jacobi branch):
  equal.
- The whole slice at psize 0.8: three TP06 layers, the ENDO facet
  stimulus, Strang, 40 steps, against the JAX ``FusedMonodomainSolver`` on
  its plain path and on its Pallas-interpret path (lane-gather SpMV and
  the multi-marker kernel).  States within atol 1e-8 (CG rtol 1e-8 on both
  sides, sums in other orders) and activation times equal.
"""

import numpy as np
import pytest
import torch

from torch_lv_reference import jax_lv_solver

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import utils as jutils
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as j_lv
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import utils as tutils
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import lv as tlv
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as t_lv

PSIZE, DT, N_STEPS = 0.8, 0.05, 40


@pytest.mark.parametrize("psize", [0.8, 0.55])
def test_lv_geometry_bit_equal(psize):
    j, t = j_lv(psize_ref=psize, cache=False), t_lv(psize_ref=psize)
    pairs = [
        (j.mesh.coords, t.mesh.coords), (j.mesh.cells, t.mesh.cells),
        (j.ffun.indices, t.ffun.indices), (j.ffun.values, t.ffun.values),
        (j.f0, t.f0), (j.s0, t.s0), (j.n0, t.n0),
    ]
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert j.markers == t.markers and j.ffun.dim == t.ffun.dim == 2


@pytest.mark.parametrize("marker", ["ENDO", "EPI", "BASE"])
def test_facet_quadrature_equal(marker):
    j, t = j_lv(psize_ref=PSIZE, cache=False), t_lv(psize_ref=PSIZE)
    m = t.markers[marker][0]
    jq = jfem.facet_quadrature(jfem.functionspace(j.mesh, ("P", 1)), j.ffun.find(m))
    tq = tfem.facet_quadrature(tfem.functionspace(t.mesh, ("P", 1)), t.ffun.find(m))
    for name in ("X", "W", "N", "dofs"):
        np.testing.assert_array_equal(getattr(tq, name), getattr(jq, name))
    np.testing.assert_array_equal(tq.assemble_load_host(), jq.assemble_load_host())


def test_dofs_and_bcs_match_jax():
    j, t = j_lv(psize_ref=PSIZE, cache=False), t_lv(psize_ref=PSIZE)
    jV, tV = jfem.functionspace(j.mesh, ("P", 1)), tfem.functionspace(t.mesh, ("P", 1))
    for m in (6, 7):
        jd = jfem.locate_dofs_topological(jV, 2, j.ffun.find(m))
        td = tfem.locate_dofs_topological(tV, 2, t.ffun.find(m))
        np.testing.assert_array_equal(td, jd)
        bc = tfem.dirichletbc(1.0, td, tV)
        assert bc.value == 1.0 and bc.dofs.dtype == np.int32


def test_expand_layer_labels_equal():
    j, t = j_lv(psize_ref=PSIZE, cache=False), t_lv(psize_ref=PSIZE)
    kw = dict(endo_marker=6, epi_marker=7, endo_size=0.3, epi_size=0.3,
              output_mid_marker=0, output_endo_marker=1, output_epi_marker=2)
    jl = jutils.expand_layer(V=jfem.functionspace(j.mesh, ("P", 1)), ft=j.ffun, **kw)
    tl = tutils.expand_layer(tfem.functionspace(t.mesh, ("P", 1)), t.ffun, device="cpu", **kw)
    np.testing.assert_array_equal(tl, np.asarray(jl.x.array))
    assert set(np.unique(tl)) == {0, 1, 2}


def test_laplace_amg_branch_is_not_ported():
    """The AMG branch, once unported, now runs: at 9,780 dofs "auto" takes
    SA-AMG as the JAX package does, and the endo/epi solve equals JAX's
    within 1e-8 on it and on "amg"; an unknown preconditioner raises."""
    j, t = j_lv(psize_ref=0.3, cache=False), t_lv(psize_ref=0.3)
    jV, tV = jfem.functionspace(j.mesh, ("P", 1)), tfem.functionspace(t.mesh, ("P", 1))
    jbcs = [jfem.dirichletbc(0.0, jfem.locate_dofs_topological(jV, 2, j.ffun.find(6)), jV),
            jfem.dirichletbc(1.0, jfem.locate_dofs_topological(jV, 2, j.ffun.find(7)), jV)]
    tbcs = [tfem.dirichletbc(0.0, tfem.locate_dofs_topological(tV, 2, t.ffun.find(6)), tV),
            tfem.dirichletbc(1.0, tfem.locate_dofs_topological(tV, 2, t.ffun.find(7)), tV)]
    ref = jutils.laplace_solve(jV, jbcs)
    for precond in ("auto", "amg"):
        arr, info = tutils._laplace_solve(tV, tbcs, precond=precond, device="cpu")
        assert info.precond == "amg" and info.converged
        np.testing.assert_allclose(arr, ref, rtol=0, atol=1e-8)
    with pytest.raises(ValueError):
        tutils.laplace_solve(tV, tbcs, precond="ilu", device="cpu")


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


def test_lv_twins_on_request_match_default_path(port_run):
    """use_kernels=False selects the twins explicitly; on the CPU the
    kernel wrappers dispatch to the same twins."""
    ts = tlv.build_lv_solver(psize=PSIZE, device="cpu", use_kernels=False,
                             layers=port_run._ionic_groups[0].index.numpy())
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert torch.equal(ts.states, port_run.states)


def test_lv_kernel_check_on_the_cpu():
    from fenicsx_beat_tpu_torch.benchmarks.kernel_check import lv_kernel_check

    out = lv_kernel_check(psize=PSIZE, n_steps=4, device="cpu", t_start=0.5)
    assert out["max_abs_dev"] == 0.0 and out["max_abs_dev_from_0"] == 0.0 and out["device"] == "cpu"
    # another summation order of the SpMV differs by rounding only in f64
    assert 0.0 <= out["max_abs_dev_from_0_twin_orders"] < 1e-9
