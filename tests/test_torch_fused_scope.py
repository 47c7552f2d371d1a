"""The fused solver's ionic and splitting scope against the JAX package's,
in f64 on the CPU (the port on its kernels' twins), on the Niederer slab at
dx=1.0 (672 nodes) unless a case says otherwise:

- merged Strang (``merge_strang_halves=True``), chunked so that each chunk
  opens and closes with its own half step: all states within atol 1e-8,
  activation times equal, ``n_steps + 1`` ionic steps a chunk; with
  theta=1 the option is ignored with a warning and the run is Godunov's;
- any splitting theta (0.25, 0.7);
- a general space-time stimulus expression (not a TimeWindow), in the
  fused solver and in the bidomain solver (the FitzHugh-Nagumo square of
  ``tests/test_torch_bidomain.py``, its tolerance: 1e-8 of each field's
  largest magnitude, CG counts equal);
- per-marker parameter fields: a dict ``ode_fun`` whose marker takes a
  node-aligned ``[NP, n]`` field (B1's per-node form on that marker's nodes)
  beside markers on vectors (B7), of one model and of two, and with nodes
  of no marker; the same in the bidomain solver (``ionic_layer``'s, shared).
  The object-oriented ``DolfinMultiODESolver`` takes a marker's field over
  its own nodes, as JAX's does (each marker an ``ODESystemSolver``).

Activation times are equal here (both sides stamp the same step times),
states within atol 1e-8 (``tests/test_torch_fused.py``'s tolerances: the
port's symmetric SpMV sums in another order, CG tolerance rtol 1e-8).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.benchmarks import niederer as jnied
from fenicsx_beat_tpu.bidomain import BidomainSolver as JBidomain
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.models import torord_dyncl as jtor
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import odesolver as tode
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import niederer as tnied
from fenicsx_beat_tpu_torch.bidomain import BidomainSolver as TBidomain
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.models import torord_dyncl as ttor
from fenicsx_beat_tpu_torch.ops import cuda_ode
from test_torch_bidomain import assert_same, run, square

DX, DT, N_STEPS, N = 1.0, 0.05, 40, 672
SIDES = {"jax": (jtp, jtor, jstim), "port": (ttp, ttor, tstim)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def solvers(of_side=None, **kw):
    """The JAX solver (its plain path) and the port's, both Niederer's at
    ``DX`` with the keyword arguments ``kw``, or those ``of_side(side)``
    gives for each side."""
    out = []
    for side in ("jax", "port"):
        args = of_side(side) if of_side else dict(kw)
        theta = args.pop("theta", 0.5)
        if side == "jax":
            s = jnied._build_solver(dx=DX, theta=theta, use_pallas_ode=False, operator_cache_key=None)
        else:
            s = tnied._build_solver(dx=DX, theta=theta, device="cpu")
        out.append(dataclasses.replace(s, **args) if args else s)
    return out


def assert_same_run(port, jax_solver):
    np.testing.assert_allclose(port.states.numpy(), np.asarray(jax_solver.states)[:, : port._n], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(port.activation_times(), np.asarray(jax_solver.activation_times()))


def count_ionic_steps(solver) -> list:
    """Wrap the solver's ionic step; returns the list of the steps' dt."""
    calls = []
    step = solver._ode_step

    def counted(states, v, t, dt):
        calls.append(dt)
        return step(states, v, t, dt)

    solver._ode_step = counted
    return calls


def test_merged_strang_matches_jax():
    """Chunks of 30, 30, 30 and 10 steps (100 in all, 5 ms): each chunk's first
    ionic step dt/2, the others dt, one trailing dt/2, and the midpoint
    activation stamps of the S1 region's upstroke."""
    js, ts = solvers(theta=0.5, merge_strang_halves=True)
    assert ts._merged
    js.solve((0.0, 100 * DT), dt=DT, save_freq=30)
    calls = count_ionic_steps(ts)
    assert ts.solve((0.0, 100 * DT), dt=DT, save_freq=30) == Status.OK
    assert len(calls) == 100 + 4  # n_steps + 1 a chunk
    assert calls[:31] == [0.5 * DT] + [DT] * 29 + [0.5 * DT]
    assert (ts.activation_times() >= 0).sum() > 2
    assert_same_run(ts, js)
    # a merged run depends on its chunking: one chunk of 100 is another run
    one = solvers(theta=0.5, merge_strang_halves=True)[1]
    one.solve((0.0, 100 * DT), dt=DT)
    assert not np.array_equal(one.states.numpy(), ts.states.numpy())


def test_merged_strang_with_godunov_warns_and_runs_godunov(caplog):
    with caplog.at_level(logging.WARNING, logger="fenicsx_beat_tpu_torch.fused"):
        js, ts = solvers(theta=1.0, merge_strang_halves=True)
    assert not ts._merged and "merge_strang_halves requires theta=0.5" in caplog.text
    js.solve((0.0, N_STEPS * DT), dt=DT)
    calls = count_ionic_steps(ts)
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert calls == [DT] * N_STEPS
    assert_same_run(ts, js)
    godunov = solvers(theta=1.0)[1]
    godunov.solve((0.0, N_STEPS * DT), dt=DT)
    np.testing.assert_array_equal(godunov.states.numpy(), ts.states.numpy())


@pytest.mark.parametrize("theta", [0.25, 0.7])
def test_any_splitting_theta_matches_jax(theta):
    js, ts = solvers(theta=theta)
    js.solve((0.0, N_STEPS * DT), dt=DT, save_freq=15)
    calls = count_ionic_steps(ts)
    ts.solve((0.0, N_STEPS * DT), dt=DT, save_freq=15)
    assert len(calls) == 2 * N_STEPS
    np.testing.assert_allclose(calls[:2], [theta * DT, (1 - theta) * DT], rtol=1e-15)
    assert_same_run(ts, js)


def general_stimulus(side, stim):
    """A space-time expression that is not a TimeWindow: the S1 window
    ``stim`` (a TimeWindow Stimulus) times 1 + x/10, evaluated by the side's
    own arrays (jnp or torch)."""
    st = SIDES[side][2]
    w = stim.expr
    amp, start, dur = w.amplitude, w.start, w.duration

    def expr(x, t):
        return amp * (1.0 + 0.1 * x[0]) * ((t >= start) & (t <= start + dur))

    return st.Stimulus(expr=expr, dZ=stim.dZ, marker=stim.marker)


def test_general_stimulus_matches_jax():
    js, ts = solvers(theta=0.5)
    js = dataclasses.replace(js, I_s=general_stimulus("jax", js.I_s))
    ts = dataclasses.replace(ts, I_s=general_stimulus("port", ts.I_s))
    assert ts._b_units is None and ts._stim_terms[0][3] is None  # assembled each step, not a unit load
    np.testing.assert_array_equal(ts.stimulus_amplitudes(), [1.0])
    js.solve((0.0, N_STEPS * DT), dt=DT)
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert (ts.activation_times() >= 0).sum() > 0
    assert_same_run(ts, js)


@pytest.mark.parametrize("scheme, theta", [("monolithic", 0.5), ("gs", 1.0)])
def test_general_stimulus_matches_jax_in_the_bidomain(scheme, theta):
    """The FitzHugh-Nagumo square's corner window as a general expression
    (times 1 + y/10), at the PDE theta point of each step."""
    common = dict(theta=theta, scheme=scheme, pde_theta=0.5)
    sides = {}
    for side, cls, kw in (("jax", JBidomain, {"use_pallas_ode": False}), ("port", TBidomain, {"device": "cpu"})):
        args = square(side, 8)
        stim = args["I_s"]
        st = jstim if side == "jax" else tstim
        w = stim.expr

        def expr(x, t, w=w):
            return w.amplitude * (1.0 + 0.1 * x[1]) * ((t >= w.start) & (t <= w.start + w.duration))

        args["I_s"] = st.Stimulus(expr=expr, dZ=stim.dZ, marker=stim.marker)
        sides[side] = cls(**args, **common, **kw)
    np.testing.assert_array_equal(sides["port"].stimulus_amplitudes(), [1.0])
    assert_same(run(sides["jax"], 1.5, 0.1, 5), run(sides["port"], 1.5, 0.1, 5))


def celltype_field(model, n, seed):
    """A node-aligned parameter field of mixed celltypes (pacing off)."""
    cts = np.random.default_rng(seed).integers(0, 3, n).astype(float)
    return np.stack([model.init_parameter_values(stim_amplitude=0.0, celltype=c) for c in cts], axis=1)


def marker_kwargs(case):
    """The dict ``ode_fun`` arguments of ``case`` for each side: markers
    along x, one of them on a field."""

    def kw(side):
        tp, tor, _ = SIDES[side]
        x = tnied.niederer_setup(DX)[0].coords[:, 0]
        field = celltype_field(tp, N, seed=7)
        if case == "tp06 field | torord":
            markers = (x >= 10.0).astype(np.int64)
            funs = {0: tp.generalized_rush_larsen, 1: tor.generalized_rush_larsen}
            init = {0: tp.init_state_values(), 1: tor.init_state_values()}
            params = {0: field, 1: tor.init_parameter_values(i_Stim_Amplitude=0.0)}
        elif case == "tp06 field | tp06":
            markers = (x >= 10.0).astype(np.int64)
            funs = {0: tp.generalized_rush_larsen, 1: tp.generalized_rush_larsen}
            init = {0: tp.init_state_values(), 1: tp.init_state_values()}
            params = {0: field, 1: tp.init_parameter_values(stim_amplitude=0.0, celltype=2.0)}
        else:  # two fields, and nodes of no marker (marker 2 names no model)
            markers = np.digitize(x, [7.0, 14.0]).astype(np.int64)
            funs = {0: tp.generalized_rush_larsen, 1: tp.generalized_rush_larsen}
            init = {0: tp.init_state_values(), 1: tp.init_state_values()}
            params = {0: field, 1: celltype_field(tp, N, seed=8)}
        return dict(theta=0.5, ode_fun=funs, init_states=init, parameters=params,
                    v_index={m: 0 for m in funs}, ode_markers=markers)

    return kw


@pytest.mark.parametrize("case", ["tp06 field | torord", "tp06 field | tp06", "fields and no marker"])
def test_per_marker_parameter_fields_match_jax(case):
    js, ts = solvers(marker_kwargs(case))
    assert len(ts._ionic_fields) >= 1
    assert all(g.field.shape == (54, g.nodes.numel()) for g in ts._ionic_fields)
    js.solve((0.0, N_STEPS * DT), dt=DT)
    ts.solve((0.0, N_STEPS * DT), dt=DT)
    assert (ts.activation_times() >= 0).sum() > 0
    assert_same_run(ts, js)


def test_field_step_reads_only_its_marker():
    """The field marker's nodes are gathered: states of other nodes never
    enter its step (a NaN there stays there and spreads nowhere), and a
    uniform field gives the same marker's run on its vector, to rounding:
    the twins read a vector's entries as Python scalars and a field's as
    tensors, so their last bits may differ (the kernels' are equal on the
    card, ``chip_smoke.py`` phase 21 (c))."""
    kw = marker_kwargs("tp06 field | tp06")("port")
    ts = dataclasses.replace(tnied._build_solver(dx=DX, theta=0.5, device="cpu"), **kw)
    vector = ttp.init_parameter_values(stim_amplitude=0.0, celltype=1.0)
    table = dataclasses.replace(ts, **{**kw, "parameters": {0: vector, 1: kw["parameters"][1]}})
    uniform = dataclasses.replace(ts, **{**kw, "parameters": {0: np.tile(vector[:, None], (1, N)),
                                                              1: kw["parameters"][1]}})
    assert uniform._ionic_fields and not table._ionic_fields
    for s in (table, uniform):
        s.solve((0.0, 10 * DT), dt=DT)
    np.testing.assert_allclose(uniform.states.numpy(), table.states.numpy(), rtol=1e-12, atol=1e-12)
    other = torch.as_tensor(kw["ode_markers"] == 1)
    states = uniform.states.clone()
    states[1:, other] = float("nan")
    v = states[0].clone()
    uniform._ode_step(states, v, 0.0, DT)
    assert torch.isfinite(states[:, ~other]).all()


def test_per_marker_fields_match_jax_in_the_bidomain():
    """Two FitzHugh-Nagumo layers, one on a field of its ``b`` (the
    bidomain takes ``ionic_layer`` as the fused solver does)."""
    common = dict(theta=0.5, scheme="monolithic", pde_theta=0.5)
    sides = {}
    for side, cls, kw in (("jax", JBidomain, {"use_pallas_ode": False}), ("port", TBidomain, {"device": "cpu"})):
        args = square(side, 8, markers=True)
        fhn = jfhn if side == "jax" else tfhn
        n = args["ode_markers"].size
        b = np.linspace(0.01, 0.03, n)
        args["parameters"][1] = np.stack([fhn.init_parameter_values(stim_amplitude=0.0, b=bi) for bi in b], axis=1)
        sides[side] = cls(**args, **common, **kw)
    assert len(sides["port"]._ionic_fields) == 1
    assert_same(run(sides["jax"], 1.5, 0.1, 5), run(sides["port"], 1.5, 0.1, 5))


def test_oo_multi_ode_solver_takes_a_marker_field():
    """``DolfinMultiODESolver``: a marker's field covers that marker's own
    nodes (``[NP, n_m]``, its ``ODESystemSolver``'s B1 per-node form), as
    JAX's takes it; TP06 with mixed celltypes beside FitzHugh-Nagumo."""
    out = {}
    for side, fem_, mesh_, mod, tp, fh, kw in (
        ("jax", jfem, jmesh, jode, jtp, jfhn, {}),
        ("port", tfem, tmesh, tode, ttp, tfhn, {"device": "cpu"}),
    ):
        mesh = mesh_.create_unit_square(None, 5, 5)
        V = fem_.functionspace(mesh, ("P", 1))
        markers = fem_.Function(V)
        markers.interpolate(lambda x: np.where(x[0] < 0.5, 1.0, 2.0))
        n1 = int((markers.x.array == 1).sum())
        ode = mod.DolfinMultiODESolver(
            v_ode=fem_.Function(V), v_pde=fem_.Function(V), markers=markers,
            init_states={1: tp.init_state_values(), 2: fh.init_state_values()},
            parameters={1: celltype_field(tp, n1, seed=3), 2: fh.init_parameter_values()},
            fun={1: tp.generalized_rush_larsen, 2: fh.generalized_rush_larsen},
            num_states={1: 19, 2: 2}, v_index={1: 0, 2: 1}, **kw,
        )
        for k in range(5):
            ode.step(0.05 * k, 0.05)
        out[side] = [np.asarray(ode.values(m)) for m in (1, 2)]
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_scope_accepts_fields_and_refuses_what_is_not_ported():
    funs = {0: ttp.generalized_rush_larsen, 1: ttor.forward_euler}
    models = cuda_ode.ionic_model
    assert models(ttp.forward_euler).name == "tp06_fe" and models(ttor.forward_euler).name == "torord_dyncl_fe"
    from fenicsx_beat_tpu_torch.splitting import check_ionic_scope

    scope = check_ionic_scope(funs, np.zeros(4), {0: ttp.init_state_values(), 1: ttor.init_state_values()},
                              {0: np.zeros((54, 4)), 1: ttor.init_parameter_values()}, {0: 0, 1: 0})
    assert scope.name == "tp06+torord_dyncl_fe"
    with pytest.raises(NotImplementedError, match="parameter vector"):
        check_ionic_scope(funs, np.zeros(4), {0: None, 1: None}, {0: None, 1: np.zeros(3)}, {0: 0, 1: 0})


@pytest.mark.parametrize("conductivity", ["niederer", "heterogeneous"])
def test_slab_pairs_are_symmetric(conductivity):
    """The fused solver keeps its refusal of non-symmetric stencil pairs
    (JAX reaches that branch only through TPU rules): every P1 pair the
    port assembles on the slab is symmetric within ``stencil_is_symmetric``'s
    1e-9, here at dx=0.5 with Niederer's tensor and with a random symmetric
    positive definite tensor in every cell."""
    from fenicsx_beat_tpu_torch import fem
    from fenicsx_beat_tpu_torch.conductivities import as_cell_tensors
    from fenicsx_beat_tpu_torch.ops.sparse import StencilMatrix, stencil_is_symmetric

    mesh, M, _, _ = tnied.niederer_setup(0.5)
    Mc = as_cell_tensors(M, mesh)
    if conductivity == "heterogeneous":
        rng = np.random.default_rng(3)
        B = rng.standard_normal((mesh.num_cells, 3, 3))
        Mc = np.einsum("cij,ckj->cik", B, B) + 0.1 * np.eye(3)
    pair = fem.assemble_mass_stiffness_auto(fem.functionspace(mesh, ("P", 1)), Mc)
    assert all(isinstance(A, StencilMatrix) for A in pair)
    assert all(stencil_is_symmetric(A.offsets, A.vals.numpy()) for A in pair)
