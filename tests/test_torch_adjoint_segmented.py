"""``host_segmented_value_and_grad``: the port's host-chained segment
adjoints against the JAX package's and against the port's own monolithic
gradient, float64 on the CPU (float32 for the tiny cotangent seed).

- On the FitzHugh-Nagumo unit square (4 segments of 10 steps): the value
  within 1e-9 relative and the gradient within 1e-6 relative of JAX's for
  the plain chain, ``truncate_every``, an engaging ``carry_clip``,
  ``cotangent_scale`` and ``window_outlier``; the plain chain equal to the
  monolithic gradient (rtol 1e-10).
- Truncated BPTT is exact: w = K is the untruncated chain bit for bit, w =
  1 the sum of per-segment gradients from frozen boundaries, w = 2 two
  untruncated 2-segment chains.
- ``carry_clip``: a non-engaging clip is the exact chain bit for bit; an
  engaging clip equals a NumPy mirror of the clipped recursion on a toy
  linear simulator; a non-finite carry resets to zero.
- ``cotangent_scale``: a power of two gives the unscaled gradient bit for
  bit (CG tolerance purely relative), with and without an engaging clip;
  a 2**-80 seed in float32 is not flushed to zero.
- ``window_outlier`` drops an exploding window and a non-finite one;
  ``window_grads_out`` receives every window.
- The argument errors JAX raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import adjoint as jadj
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu_torch import adjoint as tadj
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn

F64 = torch.float64
DT, M, K = 0.1, 10, 4  # 4 segments of 10 steps


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(side: str, n_steps: int, nx: int = 6, dtype=None, **kw):
    m, s = (jmesh, jstim) if side == "jax" else (tmesh, tstim)
    fhn = jfhn if side == "jax" else tfhn
    mesh = m.create_unit_square(None, nx, nx)
    cells = m.locate_entities(mesh, 2, lambda x: (x[0] < 0.4) & (x[1] < 0.4))
    I_s = s.Stimulus(expr=s.TimeWindow(amplitude=30.0, start=0.0, duration=1.0),
                     dZ=s.dx(mesh, subdomain_data=m.meshtags(mesh, 2, cells, 1)), marker=1)
    extra = {"device": "cpu", "dtype": dtype} if side == "torch" else ({"dtype": dtype} if dtype else {})
    sim = (jadj if side == "jax" else tadj).build_diff_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
        I_s=I_s, probe_points=np.array([[0.2, 0.2], [0.8, 0.8]]), dt=DT, n_steps=n_steps, **kw, **extra)
    return sim, mesh.num_vertices


IONIC = jfhn.init_parameter_values(stim_amplitude=0.0)
OPTIONS = {
    "plain": {},
    "truncate_every": {"truncate_every": 2},
    "carry_clip": {"carry_clip": 1e-3},
    "cotangent_scale": {"cotangent_scale": 2.0**-40},
    "window_outlier": {"truncate_every": 1, "window_outlier": 1.5},
}


def _targets_np(nx: int = 6) -> np.ndarray:
    """Targets: the port's monolithic traces at g = 0.004 (float64)."""
    sim, _ = _sim("torch", K * M, nx)
    return sim({"g": 0.004, "ionic": IONIC}).numpy()


@pytest.fixture(scope="module")
def jax_results():
    target = _targets_np()
    sim, n = _sim("jax", M, cg_atol=0.0)
    states0 = jnp.tile(jnp.asarray(jfhn.init_state_values())[:, None], (1, n))
    seg_aux = [jnp.asarray(target[k * M : (k + 1) * M]) for k in range(K)]

    def run(p, **kw):
        return sim({**p, "ionic": jnp.asarray(IONIC)}, **kw)

    out = {}
    for name, opts in OPTIONS.items():
        v, g = jadj.host_segmented_value_and_grad(
            run, {"g": 0.003}, lambda tr, aux: jnp.sum((tr - aux) ** 2), seg_aux, segment_ms=M * DT,
            states0=states0, **opts)
        out[name] = (float(v), float(g["g"]))
    return target, out


def _port_seg(target, cg_atol=0.0, **opts):
    sim, n = _sim("torch", M, cg_atol=cg_atol)
    states0 = torch.as_tensor(tfhn.init_state_values())[:, None].repeat(1, n)
    seg_aux = [torch.as_tensor(target[k * M : (k + 1) * M]) for k in range(K)]
    v, g = tadj.host_segmented_value_and_grad(
        lambda p, **kw: sim({**p, "ionic": IONIC}, **kw), {"g": 0.003},
        lambda tr, aux: torch.sum((tr - aux) ** 2), seg_aux, segment_ms=M * DT, states0=states0, **opts)
    return v, float(g["g"])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_segmented_matches_jax(jax_results, name):
    target, ref = jax_results
    v, g = _port_seg(target, **OPTIONS[name])
    jv, jg = ref[name]
    np.testing.assert_allclose(v, jv, rtol=1e-9)
    np.testing.assert_allclose(g, jg, rtol=1e-6)
    if name in ("carry_clip", "window_outlier"):
        assert jg != pytest.approx(ref["plain"][1], rel=1e-3)  # the option engaged


def test_segmented_matches_monolithic():
    target = _targets_np()
    sim_full, _ = _sim("torch", K * M)
    g = torch.tensor(0.003, dtype=F64, requires_grad=True)
    loss = torch.sum((sim_full({"g": g, "ionic": IONIC}) - torch.as_tensor(target)) ** 2)
    loss.backward()
    v, gs = _port_seg(target, cg_atol=1e-12)
    np.testing.assert_allclose(v, float(loss.detach()), rtol=1e-12)
    np.testing.assert_allclose(gs, float(g.grad), rtol=1e-10)


def test_truncated_bptt_is_exact():
    sim, n = _sim("torch", 6, nx=5)
    states0 = torch.as_tensor(tfhn.init_state_values())[:, None].repeat(1, n)
    p0 = {"g": 0.003}

    def run(p, **kw):
        return sim({**p, "ionic": IONIC}, **kw)

    def seg_loss(tr, aux):
        return torch.sum((tr - aux) ** 2)

    bounds, seg_aux, s = [states0], [], states0
    for k in range(K):
        tr, s = run(p0, states0_in=s, t0=k * 6 * DT, return_final=True)
        seg_aux.append(tr * 0.9)
        bounds.append(s)
    kw = dict(segment_ms=6 * DT, states0=states0)
    v_none, g_none = tadj.host_segmented_value_and_grad(run, p0, seg_loss, seg_aux, **kw)
    v_K, g_K = tadj.host_segmented_value_and_grad(run, p0, seg_loss, seg_aux, truncate_every=K, **kw)
    assert v_K == v_none and torch.equal(g_K["g"], g_none["g"])

    def g_seg(k):
        g = torch.tensor(0.003, dtype=F64, requires_grad=True)
        seg_loss(run({"g": g}, states0_in=bounds[k], t0=k * 6 * DT), seg_aux[k]).backward()
        return float(g.grad)

    v_1, g_1 = tadj.host_segmented_value_and_grad(run, p0, seg_loss, seg_aux, truncate_every=1, **kw)
    np.testing.assert_allclose(v_1, v_none, rtol=1e-12)
    np.testing.assert_allclose(float(g_1["g"]), sum(g_seg(k) for k in range(K)), rtol=1e-6)

    g_win = 0.0
    for k0 in (0, 2):
        def shifted(p, *, states0_in, t0, return_final=True, _off=k0 * 6 * DT):
            return run(p, states0_in=states0_in, t0=t0 + _off, return_final=return_final)

        _v, g = tadj.host_segmented_value_and_grad(shifted, p0, seg_loss, seg_aux[k0 : k0 + 2],
                                                   segment_ms=6 * DT, states0=bounds[k0])
        g_win += float(g["g"])
    v_2, g_2 = tadj.host_segmented_value_and_grad(run, p0, seg_loss, seg_aux, truncate_every=2, **kw)
    np.testing.assert_allclose(v_2, v_none, rtol=1e-12)
    np.testing.assert_allclose(float(g_2["g"]), g_win, rtol=1e-6)


def _toy_sq(tr, aux):
    return torch.sum((tr - aux) ** 2)


def test_carry_clip_exact_and_engaging():
    """A toy linear segment, s -> a s, traces the final state."""

    def toy_sim(p, *, states0_in, t0, return_final=False):
        s = p["a"] * states0_in
        return (s, s) if return_final else s

    a0 = 10.0
    states0 = torch.tensor([1.0], dtype=F64)
    seg_aux = [torch.zeros(1, dtype=F64)] * K
    kw = dict(segment_ms=1.0, states0=states0)
    p0 = {"a": a0}
    v_exact, g_exact = tadj.host_segmented_value_and_grad(toy_sim, p0, _toy_sq, seg_aux, **kw)
    v_hi, g_hi = tadj.host_segmented_value_and_grad(toy_sim, p0, _toy_sq, seg_aux, carry_clip=1e30, **kw)
    assert v_hi == v_exact and torch.equal(g_hi["a"], g_exact["a"])

    C = 50.0
    bounds = [a0**k for k in range(K)]
    d, g_ref = 0.0, 0.0
    for k in reversed(range(K)):
        b = bounds[k]
        fin = a0 * b
        g_ref += 2.0 * fin * b + d * b
        d = 2.0 * fin * a0 + d * a0
        if abs(d) > C:
            d *= C / abs(d)
    v_c, g_c = tadj.host_segmented_value_and_grad(toy_sim, p0, _toy_sq, seg_aux, carry_clip=C, **kw)
    assert float(g_c["a"]) != pytest.approx(float(g_exact["a"]))
    np.testing.assert_allclose(v_c, v_exact, rtol=1e-12)
    np.testing.assert_allclose(float(g_c["a"]), g_ref, rtol=1e-12)


def test_carry_clip_resets_a_nonfinite_carry():
    def toy_sim(p, *, states0_in, t0, return_final=False):
        s = states0_in
        traces = p["a"] * torch.sqrt(s)  # d traces / d s is Inf at 0
        return (traces, s * 0.0) if return_final else traces

    kw = dict(segment_ms=1.0, states0=torch.tensor([0.0], dtype=F64))
    seg_aux = [torch.ones(1, dtype=F64)] * 2
    val, g = tadj.host_segmented_value_and_grad(toy_sim, {"a": 3.0}, _toy_sq, seg_aux, carry_clip=10.0, **kw)
    assert np.isfinite(val) and np.isfinite(float(g["a"]))
    assert float(g["a"]) == 0.0


def _fhn_run(dtype, cg_rtol=1e-10):
    sim, n = _sim("torch", 5, nx=4, dtype=dtype, cg_rtol=cg_rtol, cg_atol=0.0)
    states0 = torch.as_tensor(tfhn.init_state_values()).to(dtype)[:, None].repeat(1, n)
    ionic = torch.as_tensor(IONIC).to(dtype)

    def run(p, **kw):
        return sim({**p, "ionic": ionic}, **kw)

    p0 = {"g": torch.tensor(0.003, dtype=dtype)}
    seg_aux, s = [], states0
    for k in range(3):
        tr, s = run(p0, states0_in=s, t0=k * 5 * DT, return_final=True)
        seg_aux.append(tr * 0.9)
    return run, p0, seg_aux, dict(segment_ms=5 * DT, states0=states0)


def test_cotangent_scale_is_exact_for_a_power_of_two():
    run, p0, seg_aux, kw = _fhn_run(F64)
    for extra in ({}, {"carry_clip": 1e-3}):
        _v1, g1 = tadj.host_segmented_value_and_grad(run, p0, _toy_sq, seg_aux, **kw, **extra)
        _v2, g2 = tadj.host_segmented_value_and_grad(run, p0, _toy_sq, seg_aux, cotangent_scale=2.0**-40,
                                                     **kw, **extra)
        assert float(g1["g"]) == float(g2["g"]), extra


def test_tiny_float32_cotangent_seed_not_flushed():
    run, p0, seg_aux, kw = _fhn_run(torch.float32, cg_rtol=1e-6)
    _v1, g1 = tadj.host_segmented_value_and_grad(run, p0, _toy_sq, seg_aux, **kw)
    _v2, g2 = tadj.host_segmented_value_and_grad(run, p0, _toy_sq, seg_aux, cotangent_scale=2.0**-80, **kw)
    assert g2["g"].dtype == torch.float32 and float(g2["g"]) != 0.0
    np.testing.assert_allclose(float(g2["g"]), float(g1["g"]), rtol=1e-3)


@pytest.mark.parametrize("dtype, chaos", [(F64, 1e4), (torch.float32, 1e25)], ids=["exploding", "nonfinite"])
def test_window_outlier_drops_a_window(dtype, chaos):
    def sim(params, states0_in=None, t0=None, return_final=True):
        c = chaos if t0 == 2.0 else 1.0  # the segment at t0 = 2 is the chaotic one
        traces = c * params["p"] * torch.ones(3, dtype=dtype)
        return traces, states0_in + params["p"]

    targets = [torch.zeros(3, dtype=dtype)] * 4
    kw = dict(segment_ms=1.0, states0=torch.zeros(1, dtype=dtype), truncate_every=1)
    params = {"p": torch.tensor(1.0, dtype=dtype)}
    wins = []
    _, g_all = tadj.host_segmented_value_and_grad(sim, params, lambda tr, tg: torch.mean((tr - tg) ** 2),
                                                  targets, window_grads_out=wins, **kw)
    _, g_trim = tadj.host_segmented_value_and_grad(sim, params, lambda tr, tg: torch.mean((tr - tg) ** 2),
                                                   targets, window_outlier=10.0, **kw)
    assert len(wins) == 4 and [k for k, _ in wins] == [3, 2, 1, 0]
    if dtype == F64:  # per-window dL/dp = 2 c^2 p: [2, 2, 2e8, 2]
        np.testing.assert_allclose(float(g_all["p"]), 6.0 + 2e8, rtol=1e-6)
    else:  # 2e50 overflows float32: Inf
        assert not np.isfinite(float(g_all["p"]))
    np.testing.assert_allclose(float(g_trim["p"]), 6.0, rtol=1e-5)


@pytest.mark.parametrize("kwargs, match", [
    ({"truncate_every": 0}, "truncate_every"),
    ({"carry_clip": 0.0}, "carry_clip"),
    ({"cotangent_scale": 0.0}, "cotangent_scale"),
    ({"cotangent_scale": float("inf")}, "cotangent_scale"),
    ({"window_outlier": 5.0}, "requires truncate_every"),
    ({"window_outlier": 0.0, "truncate_every": 1}, "window_outlier"),
])
def test_argument_errors(kwargs, match):
    def toy_sim(p, *, states0_in, t0, return_final=False):
        return (states0_in, states0_in) if return_final else states0_in

    with pytest.raises(ValueError, match=match):
        tadj.host_segmented_value_and_grad(toy_sim, {"a": 1.0}, _toy_sq, [torch.zeros(1)], segment_ms=1.0,
                                           states0=torch.zeros(1), **kwargs)
