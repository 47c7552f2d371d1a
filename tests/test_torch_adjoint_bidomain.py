"""The differentiable BIDOMAIN simulator: the port's
``build_diff_bidomain_simulator`` against the JAX package's in float64 on
the CPU.

- FitzHugh-Nagumo on the 8x8 unit square, 20 steps, Godunov (theta 1) and
  the general splitting theta 0.5, ``u_probe_points``: v and u_e traces
  within 1e-9 of max|JAX|, gradients with respect to ``gi``, ``ge``,
  ``ionic`` and ``stim_amplitude`` of a u_e-trace loss within 1e-6
  relative.
- Fiber/transverse component vectors for ``gi``/``ge``: traces and
  gradients against JAX; nested checkpointing equals the flat scheme.
- The final ``(states, u_e)`` equals the port's ``BidomainSolver``'s
  (atol 5e-8, JAX's own test's limit).
- ``host_segmented_value_and_grad`` over the ``(states, u_e)`` carry equals
  the monolithic gradient.
- The splitting and PDE thetas outside (0, 1] raise.
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
IONIC = jfhn.init_parameter_values(stim_amplitude=0.0)
PROBES = np.array([[0.15, 0.15], [0.7, 0.7]])


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(side: str, nx: int = 8):
    m, s = (jmesh, jstim) if side == "jax" else (tmesh, tstim)
    mesh = m.create_unit_square(None, nx, nx)
    cells = m.locate_entities(mesh, 2, lambda x: (x[0] < 0.3) & (x[1] < 0.3))
    I_s = s.Stimulus(expr=s.TimeWindow(amplitude=30.0, start=0.0, duration=1.0),
                     dZ=s.dx(mesh, subdomain_data=m.meshtags(mesh, 2, cells, 1)), marker=1)
    return mesh, I_s


def _bi(side: str, nx: int = 8, components: bool = False, **kw):
    mesh, I_s = _setup(side, nx)
    fhn = jfhn if side == "jax" else tfhn
    if components:
        # fiber/transverse, the anisotropy fit's split: both connect every
        # node, so the block operator's nullspace stays the constant u_e
        K_l = np.outer([1.0, 0.0], [1.0, 0.0])
        comps = [K_l, np.eye(2) - K_l]
        kw.update(intra_components=comps, extra_components=comps)
    extra = {"device": "cpu"} if side == "torch" else {}
    return (jadj if side == "jax" else tadj).build_diff_bidomain_simulator(
        mesh, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(), v_index=fhn.state_index("v"),
        I_s=I_s, probe_points=PROBES, u_probe_points=PROBES, dt=0.1, **kw, **extra), mesh


def _jax_vg(sim, params, target):
    def loss(p):
        return jnp.mean((sim(p)["u_e"] - target) ** 2)

    v, g = jax.value_and_grad(loss)({k: jnp.asarray(x) for k, x in params.items()})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


def _torch_vg(sim, params, target):
    tp = {k: torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True) for k, x in params.items()}
    loss = torch.mean((sim(tp)["u_e"] - torch.as_tensor(np.array(target))) ** 2)
    loss.backward()
    return float(loss.detach()), {k: x.grad.numpy() for k, x in tp.items()}


@pytest.mark.parametrize("case", ["godunov", "theta_half", "components"])
def test_bidomain_matches_jax(case):
    kw = dict(n_steps=20, cg_rtol=1e-12, cg_atol=1e-14)  # solves well below the comparison's limit
    if case == "theta_half":
        kw["theta"] = 0.5
    comps = case == "components"
    sj, _ = _bi("jax", components=comps, **kw)
    st, _ = _bi("torch", components=comps, **kw)
    truth = ({"gi": [0.003, 0.005], "ge": [0.008, 0.006]} if comps else {"gi": 0.004, "ge": 0.009})
    at = ({"gi": [0.0036, 0.005], "ge": [0.008, 0.0065]} if comps else {"gi": 0.003, "ge": 0.007})
    jout = sj({**{k: jnp.asarray(v) for k, v in truth.items()}, "ionic": jnp.asarray(IONIC)})
    tout = st({**truth, "ionic": IONIC})
    for key in ("v", "u_e"):
        j = np.asarray(jout[key])
        np.testing.assert_allclose(tout[key].numpy(), j, rtol=0, atol=1e-9 * np.abs(j).max(), err_msg=key)
    target = np.asarray(jout["u_e"])
    params = {**at, "ionic": IONIC * 1.05, "stim_amplitude": 28.0}
    jv, jg = _jax_vg(sj, params, target)
    tv, tg = _torch_vg(st, params, target)
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-6, atol=1e-6 * np.abs(jg[k]).max(), err_msg=k)
    assert np.all(tg["gi"] != 0) and np.all(tg["ge"] != 0)


def test_nested_checkpointing_matches_flat():
    flat, _ = _bi("torch", 6, components=True, n_steps=12)
    nested, _ = _bi("torch", 6, components=True, n_steps=12, checkpoint_segments=4)
    ge = torch.tensor([0.008, 0.006], dtype=F64)
    target = flat({"gi": [0.0036, 0.006], "ge": ge, "ionic": IONIC})["v"]
    grads = []
    for sim in (flat, nested):
        gi = torch.tensor([0.003, 0.005], dtype=F64, requires_grad=True)
        torch.mean((sim({"gi": gi, "ge": ge, "ionic": IONIC})["v"] - target) ** 2).backward()
        grads.append(gi.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-9)
    assert not np.isclose(grads[0][0], grads[0][1])


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_final_state_matches_bidomain_solver(theta):
    from fenicsx_beat_tpu_torch.bidomain import BidomainSolver

    mesh, I_s = _setup("torch")
    gi, ge, n_steps, dt = 0.004, 0.008, 15, 0.1
    common = dict(ode_fun=tfhn.forward_euler, init_states=tfhn.init_state_values(), v_index=tfhn.state_index("v"),
                  theta=theta, pde_theta=0.5)
    solver = BidomainSolver(mesh=mesh, M_i=gi, M_e=ge, I_s=I_s, parameters=IONIC, cg_rtol=1e-12, cg_atol=1e-14,
                            device="cpu", use_kernels=False, **common)
    solver.solve((0.0, n_steps * dt), dt=dt)
    sim = tadj.build_diff_bidomain_simulator(mesh, I_s=I_s, probe_points=PROBES, u_probe_points=PROBES, dt=dt,
                                             n_steps=n_steps, cg_rtol=1e-12, cg_atol=1e-14, device="cpu",
                                             **common)
    out, (states, u_e) = sim({"gi": gi, "ge": ge, "ionic": IONIC}, return_final=True)
    np.testing.assert_allclose(states[tfhn.state_index("v")].numpy(), solver.v.cpu().numpy(), atol=5e-8)
    np.testing.assert_allclose(u_e.numpy(), solver.u_e.cpu().numpy(), atol=5e-8)
    assert float(out["u_e"].abs().max()) > 1e-5


def test_host_segmented_bidomain_matches_monolithic():
    m, K = 5, 4
    seg, mesh = _bi("torch", 5, n_steps=m)
    mono, _ = _bi("torch", 5, n_steps=m * K)
    n = mesh.num_vertices
    states0 = (torch.as_tensor(tfhn.init_state_values())[:, None].repeat(1, n), torch.zeros(n, dtype=F64))
    full = mono({"gi": 0.004, "ge": 0.007, "ionic": IONIC})["v"]
    seg_aux = [full[k * m : (k + 1) * m] for k in range(K)]

    def seg_loss(traces, aux):
        return torch.sum((traces["v"] - aux) ** 2)

    val, grads = tadj.host_segmented_value_and_grad(
        lambda p, **kw: seg({**p, "ionic": IONIC}, **kw), {"gi": 0.003, "ge": 0.007}, seg_loss, seg_aux,
        segment_ms=m * 0.1, states0=states0)
    gi = torch.tensor(0.003, dtype=F64, requires_grad=True)
    ge = torch.tensor(0.007, dtype=F64, requires_grad=True)
    ref = torch.sum((mono({"gi": gi, "ge": ge, "ionic": IONIC})["v"] - full) ** 2)
    ref.backward()
    np.testing.assert_allclose(val, float(ref.detach()), rtol=1e-10)
    np.testing.assert_allclose(float(grads["gi"]), float(gi.grad), rtol=1e-8)
    np.testing.assert_allclose(float(grads["ge"]), float(ge.grad), rtol=1e-8)


@pytest.mark.parametrize("kw, match", [({"theta": 0.0}, "splitting theta"), ({"theta": 1.5}, "splitting theta"),
                                       ({"pde_theta": 0.0}, "pde_theta")])
def test_theta_outside_range_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        _bi("torch", 4, n_steps=2, **kw)
