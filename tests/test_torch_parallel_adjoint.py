"""The port's sharded differentiable simulator against the single-device
one and the JAX package's sharded one, f64.

``fenicsx_beat_tpu_torch.parallel.adjoint.build_sharded_diff_simulator``
at 2 and 4 gloo ranks (one spawn per world size:
``tests/torch_parallel_ranks.py:adjoint_cases``) on the slab of JAX's
``tests/test_adjoint.py:test_sharded_diff_simulator_matches_single_device``
(FHN forward Euler, 16 steps, fiber and transverse stiffness components):
the loss value at rtol 1e-9 and dL/dg, dL/dionic and dL/dstim_amplitude at
rtol 1e-6 against the port's single-device gradient and against JAX's
sharded gradient at the same device count; the traces at JAX's rtol
1e-8 / atol 1e-10; ``host_segmented_value_and_grad`` driving the sharded
simulator unchanged equals the monolithic gradient.  One rank with no
process group equals the single-device simulator; unstructured meshes and
general stimuli raise, as in JAX.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from fenicsx_beat_tpu import mesh as jmeshmod
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as jslab
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu.parallel.adjoint import build_sharded_diff_simulator as jbuild_sharded
from fenicsx_beat_tpu_torch.adjoint import build_diff_simulator
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry
from fenicsx_beat_tpu_torch.parallel import make_device_mesh, spawn_ranks
from fenicsx_beat_tpu_torch.parallel.adjoint import build_sharded_diff_simulator
from fenicsx_beat_tpu_torch.stimulation import Stimulus

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_ranks as R  # noqa: E402

WORLDS = (2, 4)
SPAWN_TIMEOUT = 240.0  # one spawn (about 19 s here)
KEYS = ("g", "ionic", "stim_amplitude")


def _loss(traces, target):
    return torch.mean((traces - target) ** 2)


@pytest.fixture(scope="module")
def single():
    """The port's single-device value, gradient and traces, and the target
    (0.9 times its traces, as JAX's test takes it)."""
    m3, kw = R.adjoint_setup()
    sim = build_diff_simulator(m3, device="cpu", **kw)
    with torch.no_grad():
        target = sim(R.adjoint_params(False)) * 0.9
    params = R.adjoint_params()
    traces = sim(params)
    loss = _loss(traces, target)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"target": target.numpy(), "value": float(loss.detach()), "traces": traces.detach().numpy(),
            "grads": {k: g.numpy() for k, g in zip(KEYS, grads)}}


@pytest.fixture(scope="module")
def port_runs(single):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = spawn_ranks(R.adjoint_cases, world, backend="gloo", args=(single["target"],),
                                        timeout=SPAWN_TIMEOUT)[0]
        return cache[world]

    return get


def _jax_sharded(world, target):
    """JAX's sharded value and gradient at ``world`` devices on the same problem."""
    m3 = jslab(None, dx=0.5, Lx=6.0, Ly=2.0, Lz=1.0).mesh
    cells = jmeshmod.locate_entities(m3, 3, lambda x: x[0] <= 1.0)
    I_s = jstim.Stimulus(expr=jstim.TimeWindow(amplitude=40.0, start=0.0, duration=1.0),
                         dZ=jstim.dx(m3, subdomain_data=jmeshmod.meshtags(m3, 3, cells, 1)), marker=1)
    Kf = np.outer([1.0, 0.0, 0.0], [1.0, 0.0, 0.0])
    kw = dict(ode_fun=jfhn.forward_euler, init_states=jfhn.init_state_values(), v_index=jfhn.state_index("v"),
              I_s=I_s, probe_points=R.ADJ_PROBES, dt=0.1, n_steps=16, theta=1.0, pde_theta=0.5,
              stiffness_components=[Kf, np.eye(3) - Kf], cg_rtol=1e-11, cg_atol=1e-13, dtype=jnp.float64)
    sim = jbuild_sharded(m3, JaxMesh(np.array(jax.devices()[:world]), ("shard",)), **kw)
    params = {"g": jnp.asarray(R.ADJ_G, jnp.float64),
              "ionic": jnp.asarray(jfhn.init_parameter_values(stim_amplitude=0.0), jnp.float64),
              "stim_amplitude": jnp.asarray(40.0, jnp.float64)}
    tgt = jnp.asarray(target)
    v, g = jax.value_and_grad(lambda p: jnp.mean((sim(p) - tgt) ** 2))(params)
    return float(v), {k: np.asarray(g[k]) for k in KEYS}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gradient_matches_single_device(port_runs, single, world):
    """The halo exchange's backward is the reverse exchange, the implicit
    CG adjoint re-runs the rank-local solver with its dots all-reduced, and
    the replicated parameters' partial cotangents are summed over ranks:
    the value within 1e-9, the gradients within 1e-6 of one device's, the
    traces within 1e-8 / 1e-10."""
    got = port_runs(world)
    np.testing.assert_allclose(got["value"], single["value"], rtol=1e-9)
    for k in KEYS:
        np.testing.assert_allclose(got["grads"][k], single["grads"][k], rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got["traces"], single["traces"], rtol=1e-8, atol=1e-10)
    assert np.abs(single["grads"]["g"]).min() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gradient_matches_jax_sharded(port_runs, single, world):
    got = port_runs(world)
    jv, jg = _jax_sharded(world, single["target"])
    np.testing.assert_allclose(got["value"], jv, rtol=1e-9)
    for k in KEYS:
        np.testing.assert_allclose(got["grads"][k], jg[k], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_host_segmented_drives_sharded_simulator(port_runs, world):
    """``host_segmented_value_and_grad`` over 4 segments of 4 steps, the
    carried state the rank's block, equals the monolithic value and gradient."""
    got = port_runs(world)
    np.testing.assert_allclose(got["segmented"]["value"], got["value"], rtol=1e-9)
    for k in KEYS:
        np.testing.assert_allclose(got["segmented"]["grads"][k], got["grads"][k], rtol=1e-6, atol=1e-12)


def test_world_one_equals_single_device(single):
    m3, kw = R.adjoint_setup()
    sim = build_sharded_diff_simulator(m3, make_device_mesh(device="cpu"), **kw)
    params = R.adjoint_params()
    loss = _loss(sim(params), torch.as_tensor(single["target"]))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), single["value"], rtol=1e-12)
    for k, g in zip(KEYS, grads):
        np.testing.assert_allclose(g.numpy(), single["grads"][k], rtol=1e-9, atol=1e-14)
    assert sim.comm.counts["halo_bytes"] == 0


def test_refusals():
    """Unstructured meshes and general stimuli differentiate on one device."""
    m3, kw = R.adjoint_setup()
    mesh = make_device_mesh(device="cpu")
    lv = get_lv_ellipsoid_geometry(None, psize_ref=0.9).mesh
    with pytest.raises(NotImplementedError, match="structured"):
        build_sharded_diff_simulator(lv, mesh, **dict(kw, I_s=None, probe_points=lv.coords[:2]))
    general = Stimulus(expr=lambda x, t: 1.0 + 0.0 * x[0], dZ=kw["I_s"].dZ, marker=1)
    with pytest.raises(NotImplementedError, match="TimeWindow"):
        build_sharded_diff_simulator(m3, mesh, **dict(kw, I_s=general))
