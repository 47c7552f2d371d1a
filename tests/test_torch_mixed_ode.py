"""B7's mixed-model form: markers that run different ionic models, the port
against the JAX package in f64 on the CPU (the port on the kernels' twins).

- ``make_multi_ode`` for TP06 + FitzHugh-Nagumo + ToR-ORd dynCl + Land
  (19, 2 and 52 states; V in rows 0, 1 and 0): the union, masks, swaps and
  the composed step equal JAX's (rtol 1e-12).
- :func:`mixed_multi_step`'s twin, as the solvers build it, against the JAX
  block-skip kernel ``build_pallas_multi_ode_step`` in interpret mode at
  n = 300, marker bands that split a kernel block, nodes of no marker:
  rtol 1e-12; those nodes keep their states with V injected, bit for bit.
- The groups: one launch per model in the order of its first marker, the
  last mask winning where masks overlap, the first launch injecting V into
  the nodes of no marker, each block list the blocks that hold a node of
  its launch.
- The two-model Niederer slab (TP06 below x = 10 mm, ToR-ORd + Land above)
  at dx=0.5 through ``FusedMonodomainSolver``, Strang, 40 ms: P1-P9 within
  one dt of the JAX fused solver's (they are equal).
- A bidomain run on the unit square with FHN and TP06 markers against
  JAX's ``BidomainSolver``: ``v`` and ``u_e`` within 1e-8 of their largest
  magnitude at every save, CG iterations equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bidomain_reference import IterMonitor
from torch_mixed_reference import jax_mixed_solver, probe_times

from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import odesolver as jode
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.bidomain import BidomainSolver as JBidomain
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.models import tentusscher_panfilov_2006 as jtp
from fenicsx_beat_tpu.models import torord_dyncl_land as jland
from fenicsx_beat_tpu.ops.pallas_ode import build_pallas_multi_ode_step
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import odesolver as tode
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.benchmarks import kernel_check
from fenicsx_beat_tpu_torch.benchmarks import mixed as tmixed
from fenicsx_beat_tpu_torch.bidomain import BidomainSolver as TBidomain
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.models import tentusscher_panfilov_2006 as ttp
from fenicsx_beat_tpu_torch.models import torord_dyncl_land as tland
from fenicsx_beat_tpu_torch.odesolver import MarkerModels, check_multi_models
from fenicsx_beat_tpu_torch.ops import cuda_ode
from fenicsx_beat_tpu_torch.splitting import check_ionic_scope, ionic_layer

RTOL = 1e-12
JAX = {1: jtp, 2: jfhn, 3: jland}
PORT = {1: ttp, 2: tfhn, 3: tland}
NONE = 9  # a marker value with no model


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread: its tensors here are small, and in
    the parallel test run, where every worker's threads compete for the
    cores, a process whose parallel regions wait on all its threads runs
    tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def three_models(side, models=(1, 2, 3)):
    """``(ode_fun, init_states, parameters, v_index)`` of TP06 (marker 1),
    FHN (2) and ToR-ORd + Land (3), each pacing off."""
    mods = JAX if side == "jax" else PORT
    funs = {m: mods[m].generalized_rush_larsen for m in models}
    init = {m: mods[m].init_state_values() for m in models}
    off = {1: {"stim_amplitude": 0.0}, 2: {}, 3: {"i_Stim_Amplitude": 0.0}}
    params = {m: mods[m].init_parameter_values(**off[m]) for m in models}
    v_idx = {m: mods[m].state_index("V" if m == 1 else "v") for m in models}
    return funs, init, params, v_idx


def banded(n, edges=(130, 200), none=(5, 150, 260)):
    """Markers 1 / 2 / 3 in bands that split a kernel block (of 128 lanes in
    JAX, 256 nodes here), and a few nodes of no model."""
    markers = np.where(np.arange(n) < edges[0], 1, np.where(np.arange(n) < edges[1], 2, 3))
    markers[list(none)] = NONE
    return markers


def perturbed(union, seed):
    rng = np.random.default_rng(seed)
    s = union * (1 + 0.01 * rng.standard_normal(union.shape))
    return s, rng.uniform(-90.0, 40.0, union.shape[1])


def test_make_multi_ode_three_models_matches_jax():
    n = 300
    markers = banded(n)
    fj, init_j, masks_j, vi_j = jode.make_multi_ode(markers, *three_models("jax"))
    ft, init_t, masks_t, vi_t = tode.make_multi_ode(markers, *three_models("port"))
    np.testing.assert_array_equal(init_t, init_j)
    np.testing.assert_array_equal(masks_t, masks_j)
    assert init_t.shape == (52, n) and vi_t == vi_j == 0
    for key in ("sizes", "trivial_swap"):
        assert ft.multi[key] == fj.multi[key]
    assert ft.multi["sizes"] == [19, 2, 52] and ft.multi["trivial_swap"] == [True, False, True]
    for a, b in zip(ft.multi["swaps"], fj.multi["swaps"]):
        np.testing.assert_array_equal(a, b)
    s, _ = perturbed(init_t, seed=1)
    ref = np.asarray(fj(jnp.asarray(s), 1.0, masks_j, 0.05))
    np.testing.assert_allclose(ft(torch.tensor(s), 1.0, masks_t, 0.05).numpy(), ref, rtol=RTOL, atol=1e-300)


def test_scope_names_every_model_and_keeps_refusals():
    funs, init, params, v_idx = three_models("port", (1, 3))
    models = check_multi_models({**funs, 4: tland.generalized_rush_larsen})
    assert isinstance(models, MarkerModels) and models.name == "tp06+torord_dyncl_land"
    assert [(spec.name, m) for spec, m in models.groups] == [("tp06", (1,)), ("torord_dyncl_land", (3, 4))]
    mixed = check_ionic_scope(funs, np.ones(4), init, params, v_idx)
    assert isinstance(mixed, MarkerModels) and mixed.name == "tp06+torord_dyncl_land"
    one = check_ionic_scope({0: ttp.generalized_rush_larsen, 1: ttp.generalized_rush_larsen}, np.ones(4),
                            {0: init[1], 1: init[1]}, {0: params[1], 1: params[1]}, {0: 0, 1: 0})
    assert one.groups == ((cuda_ode.ionic_model(ttp.generalized_rush_larsen), (0, 1)),) and one.name == "tp06"
    # a marker's parameter field and forward Euler are in the scope since
    # they were ported (tests/test_torch_fused_scope.py, test_torch_ionic_fe.py)
    field = check_ionic_scope(funs, np.ones(4), init, {1: params[1], 3: np.tile(params[3][:, None], (1, 4))}, v_idx)
    assert field.name == "tp06+torord_dyncl_land"
    fe = check_multi_models({1: ttp.forward_euler, 3: tland.generalized_rush_larsen})
    assert fe.name == "tp06_fe+torord_dyncl_land"
    with pytest.raises(NotImplementedError, match="parameter vector"):
        check_ionic_scope(funs, np.ones(4), init, {1: params[1], 3: None}, v_idx)
    with pytest.raises(NotImplementedError):
        check_multi_models({1: ttp.rhs, 3: tland.generalized_rush_larsen})


def test_groups_overlap_no_marker_and_blocks():
    """Masks that overlap (the last wins, as JAX's overlay), nodes of no
    marker (V injected by the first launch only), a model with no node."""
    n = 700
    masks = np.zeros((4, n), dtype=bool)
    masks[0, :300] = True  # TP06
    masks[1, 250:520] = True  # Land, over TP06's 250-299
    masks[2, 600:650] = True  # TP06 again (second row of its table)
    # masks[3]: FHN, no node; 520-599 and 650-699 in no marker
    models = [cuda_ode.ionic_model(f) for f in (ttp.generalized_rush_larsen, tland.generalized_rush_larsen,
                                                 ttp.generalized_rush_larsen, tfhn.generalized_rush_larsen)]
    params = [ttp.init_parameter_values(), tland.init_parameter_values(), ttp.init_parameter_values(g_Ks=0.1),
              tfhn.init_parameter_values()]
    groups = cuda_ode.mixed_groups(masks, models, params, "cpu", torch.float64)
    assert [g.model.name for g in groups] == ["tp06", "torord_dyncl_land"]  # FHN steps no node
    tp, la = (g.index.numpy() for g in groups)
    np.testing.assert_array_equal(tp[:250], 0)
    np.testing.assert_array_equal(tp[600:650], 1)
    np.testing.assert_array_equal(tp[250:520], cuda_ode.OTHER_MODEL)
    np.testing.assert_array_equal(tp[520:600], -1)
    np.testing.assert_array_equal(tp[650:], -1)
    np.testing.assert_array_equal(la[250:520], 0)
    assert (la[:250] == cuda_ode.OTHER_MODEL).all() and (la[520:] == cuda_ode.OTHER_MODEL).all()
    # block 1 (nodes 256-511) holds Land's nodes alone: TP06's launch skips it
    assert groups[0].blocks.tolist() == [0, 2] and groups[1].blocks.tolist() == [0, 1, 2]
    assert groups[0].table.shape == (2, 54) and groups[1].table.shape == (1, 136)
    for g in groups:
        np.testing.assert_array_equal(g.nodes.numpy(), np.nonzero(g.index.numpy() != cuda_ode.OTHER_MODEL)[0])


def test_b7_block_form_leaves_other_models_nodes():
    """B7's block-list form (CPU: its twin on the listed nodes) on union
    states of 52 rows: TP06's 19 rows step, a node of another model keeps
    every row, V is injected into the nodes of no marker."""
    s, v = perturbed(np.tile(tland.init_state_values()[:, None], (1, 8)), seed=2)
    index = torch.tensor([0, cuda_ode.OTHER_MODEL, -1, 0, cuda_ode.OTHER_MODEL, 0, -1, 0], dtype=torch.int32)
    states = torch.tensor(s)
    p = ttp.init_parameter_values()
    cuda_ode.tp06_grl_multi_step_v(states, torch.tensor(v), index, 1.0, 0.05, p[None], blocks=torch.tensor([0]))
    other, none, own = (index == cuda_ode.OTHER_MODEL).numpy(), (index == -1).numpy(), (index == 0).numpy()
    np.testing.assert_array_equal(states.numpy()[:, other], s[:, other])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[19:, own], s[19:, own])
    ref = s[:19, own].copy()
    ref[0] = v[own]
    np.testing.assert_allclose(states.numpy()[:19, own], ttp.generalized_rush_larsen(torch.tensor(ref), 1.0, p, 0.05),
                               rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("models, absent", [((1, 2), None), ((1, 2, 3), None), ((1, 2, 3), 1)],
                         ids=["tp06+fhn", "tp06+fhn+land", "tp06 on no node"])
def test_mixed_twin_matches_pallas_kernel(models, absent):
    """The solvers' mixed layer (its twin) against the JAX block-skip
    kernel in interpret mode at n = 300: TP06 and FHN (different voltage
    rows: the swaps) and with Land (S_max 52), bands that split a block,
    nodes of no marker; and the first model's marker on no node (the
    first launch that runs still injects V into the nodes of no marker)."""
    n = 300
    markers = banded(n)
    if models == (1, 2):
        markers[markers == 3] = 1
    if absent is not None:
        markers[markers == absent] = 2
    fj, union, masks, _ = jode.make_multi_ode(markers, *three_models("jax", models))
    step = build_pallas_multi_ode_step(fj.multi, masks_np=masks, num_states=union.shape[0], n_nodes=n,
                                       dtype=jnp.float64, v_index=0, interpret=True)
    s, v = perturbed(union, seed=3)
    ref = np.asarray(step(jnp.asarray(s), jnp.asarray(v), jnp.asarray(masks, dtype=jnp.float64), 2.0, 0.05))
    args = three_models("port", models)
    layer = ionic_layer(check_ionic_scope(args[0], markers, *args[1:]), args[0], markers, *args[1:], n,
                        torch.device("cpu"), torch.float64, True)
    assert [g.model.v_index for g in layer.groups] == [{1: 0, 2: 1, 3: 0}[m] for m in models if m != absent]
    assert all(g.blocks is not None for g in layer.groups)
    states = torch.tensor(s)
    layer.step(states, torch.tensor(v), 2.0, 0.05)
    np.testing.assert_allclose(states.numpy(), ref, rtol=RTOL, atol=1e-300)
    none = markers == NONE
    np.testing.assert_array_equal(states.numpy()[1:, none], s[1:, none])
    np.testing.assert_array_equal(states.numpy()[0, none], v[none])
    # the solver passes row 0 itself as v: the same result
    again = torch.tensor(s)
    again[0] = torch.tensor(v)
    layer.step(again, again[0], 2.0, 0.05)
    assert torch.equal(again, states)


def test_two_model_slab_matches_jax():
    """Path M at dx=0.5 (4,305 nodes; 9 of its 17 blocks per model, one
    shared), Strang, dt=0.05, 40 ms: P1-P9 against the JAX fused solver on
    its plain path (P2, P4, P6, P8, on the far side in y, fire after
    40 ms at this size on both)."""
    js = jax_mixed_solver(0.5, use_pallas_ode=False)
    assert js.solve((0.0, 40.0), dt=0.05, save_freq=200).name == "OK"
    ref = probe_times(js)
    res = tmixed.run_mixed_slab(dx=0.5, T=40.0, device="cpu", dtype=torch.float64)
    assert res.model == "tp06+torord_dyncl_land" and res.all_finite and res.n_nodes == 4305
    assert res.marker_nodes == {1: 2100, 2: 2205}
    assert res.blocks_per_model == {"tp06": 9, "torord_dyncl_land": 9} and res.two_model_share == 1 / 17
    for name, t in ref.items():
        assert abs(res.activation_times[name] - t) <= 0.05 + 1e-9, (name, res.activation_times[name], t)
    assert res.activation_times["P3"] > 0 and res.activation_times["P7"] > 0  # the wave crossed into Land


def _square(side):
    """The unit square of ``tests/test_torch_bidomain.py`` (nx = 8, a
    corner stimulus), FHN on x < 0.5 and TP06 on the rest."""
    mm, st = (jmesh, jstim) if side == "jax" else (tmesh, tstim)
    mesh = mm.create_unit_square(None, 8, 8)
    cells = mm.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    I_s = st.Stimulus(expr=st.TimeWindow(amplitude=30.0, start=0.0, duration=1.0),
                      dZ=st.dx(mesh, subdomain_data=mm.meshtags(mesh, 2, cells, 1)), marker=1)
    funs, init, params, v_idx = three_models(side, (1, 2))
    markers = np.where(mesh.coords[:, 0] < 0.5, 2, 1).astype(np.int64)
    return dict(mesh=mesh, M_i=np.diag([0.004, 0.0004]), M_e=np.diag([0.002, 0.0035]), I_s=I_s, ode_fun=funs,
                init_states=init, parameters=params, v_index=v_idx, ode_markers=markers)


def _run(solver):
    mon, saves = IterMonitor(), []
    solver.monitor = mon
    status = solver.solve((0.0, 1.5), dt=0.1, save_freq=5,
                          save_callback=lambda t, v, u: saves.append((t, np.array(v), np.array(u))))
    return saves, mon.iters, status


def test_bidomain_mixed_markers_match_jax():
    js = JBidomain(use_pallas_ode=False, theta=0.5, **_square("jax"))
    ts = TBidomain(device="cpu", theta=0.5, **_square("port"))
    assert len(ts._ionic_groups) == 2 and ts._ionic.name == "tp06+fhn"
    (sj, ij, stj), (sp, ip, stp) = _run(js), _run(ts)
    assert stp == Status.OK and stj.name == "OK" and ip == ij and len(sp) == len(sj) > 1
    for (tj, vj, uj), (tp, vp, up) in zip(sj, sp):
        assert tp == pytest.approx(tj, abs=1e-12)
        assert np.abs(vp - vj).max() <= 1e-8 * np.abs(vj).max(), tp
        assert np.abs(up - uj).max() <= 1e-8 * np.abs(uj).max(), tp
    np.testing.assert_allclose(ts.states.numpy(), np.asarray(js.states), rtol=0, atol=1e-6)


def _mixed_on_card(device, markers, models, seed):
    """The solvers' mixed layer on the card (kernels) and its twin, from
    perturbed union states: ``(step, twin, S, V, groups)``."""
    args = three_models("port", models)
    layer_k = ionic_layer(check_ionic_scope(args[0], markers, *args[1:]), args[0], markers, *args[1:],
                          markers.size, device, torch.float32, True)
    layer_w = ionic_layer(check_ionic_scope(args[0], markers, *args[1:]), args[0], markers, *args[1:],
                          markers.size, device, torch.float32, False)
    s, v = perturbed(layer_k.init_states, seed)
    S = torch.tensor(s, dtype=torch.float32, device=device)
    V = torch.tensor(v, dtype=torch.float32, device=device)
    return (lambda S_, v_, t, dt, _p: layer_k.step(S_, v_, t, dt),
            lambda S_, v_, t, dt, _p: layer_w.step(S_, v_, t, dt), S, V, layer_k.groups)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tp06|land along x", "tp06|fhn|none inside blocks"])
def test_mixed_kernels_match_twin_on_card(cuda_device, case):
    """One step of the mixed form's kernels against its twin per model's
    nodes (the one-step limit per state row), nodes of no marker bit for
    bit, one launch per model."""
    n = 100_000
    if case.startswith("tp06|land"):
        markers, models = np.where(np.arange(n) < 45_000, 1, 3), (1, 3)
    else:
        markers, models = np.random.default_rng(13).choice([1, 2, NONE], n), (1, 2)
    step, twin, S, V, groups = _mixed_on_card(cuda_device, markers, models, seed=14)
    nodes = {m: torch.as_tensor(np.nonzero(markers == m)[0], device=cuda_device) for m in (*models, NONE)}
    before = [g.model.multi_step.launches for g in groups]
    for dt in (0.025, 0.05):
        out = kernel_check.ionic_step_errors_by_group(step, twin, S, V, 1.0, dt, None, nodes)
        for m, (a, e) in out.items():
            if m == NONE:
                assert a == 0.0 or nodes[m].numel() == 0
            else:
                assert float(e.max()) <= kernel_check.IONIC_STEP_TOL, (m, e.tolist())
    assert [g.model.multi_step.launches - b for g, b in zip(groups, before)] == [2] * len(groups)
