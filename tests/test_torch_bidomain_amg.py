"""The bidomain's SA-AMG u-block preconditioner against the JAX package's,
f64 on the CPU (the port on B1's and B8's twins).

The setup of JAX's ``tests/test_bidomain.py::test_amg_u_precond_on_unstructured_lv``
(the psize 0.8 LV ellipsoid, Niederer-like anisotropic M_i and M_e along
the fibers, an apex stimulus, FitzHugh-Nagumo, Godunov, dt 0.1, 0.5 ms,
``cg_rtol=1e-10``), monolithic and Gauss-Seidel, on ``u_precond="auto"``
and ``"jacobi"``: ``"auto"`` engages AMG (the DCT declines on an
unstructured mesh), its worst step takes at most half of Jacobi's CG
iterations, v and u_e land within 5e-5 of the JAX solver's AMG run (and of
the port's Jacobi run), and every chunk's worst-step iterations equal
JAX's within 1.
"""

import numpy as np
import pytest
import torch

from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu import stimulation as jstim
from fenicsx_beat_tpu.bidomain import BidomainSolver as JBidomain
from fenicsx_beat_tpu.conductivities import conductivity_tensor as jtensor
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as jlv
from fenicsx_beat_tpu.models import fitzhughnagumo as jfhn
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch import stimulation as tstim
from fenicsx_beat_tpu_torch.base_model import Status
from fenicsx_beat_tpu_torch.bidomain import BidomainSolver as TBidomain
from fenicsx_beat_tpu_torch.conductivities import conductivity_tensor as ttensor
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as tlv
from fenicsx_beat_tpu_torch.models import fitzhughnagumo as tfhn
from fenicsx_beat_tpu_torch.ops import cuda_ell

ATOL = 5e-5  # JAX's gate between its AMG and Jacobi runs
SIDES = {"jax": (jmesh, jstim, jfhn, jtensor, jlv), "port": (tmesh, tstim, tfhn, ttensor, tlv)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread (small tensors; the parallel test run
    shares the cores between its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lv_setup(side):
    """JAX's ``_lv_setup(0.8)`` with FitzHugh-Nagumo, built by ``side``."""
    mm, st, fhn, tensor, lv = SIDES[side]
    geo = lv(psize_ref=0.8, cache=False)
    mesh = geo.mesh
    apex_x = mesh.coords[:, 0].min()
    tags = mm.meshtags(mesh, 3, mm.locate_entities(mesh, 3, lambda x: x[0] < apex_x + 2.0), 1)
    I_s = st.Stimulus(expr=st.TimeWindow(amplitude=80.0, start=0.0, duration=1.0),
                      dZ=st.dx(mesh, subdomain_data=tags), marker=1)
    return dict(mesh=mesh, M_i=tensor(0.17 / 1.4, 0.019 / 1.4, geo.f0), M_e=tensor(0.62 / 1.4, 0.24 / 1.4, geo.f0),
                I_s=I_s, ode_fun=fhn.forward_euler, init_states=fhn.init_state_values(),
                parameters=fhn.init_parameter_values(stim_amplitude=0.0), v_index=fhn.state_index("v"),
                theta=1.0, cg_rtol=1e-10, cg_atol=1e-12)


class Iters:
    def __init__(self):
        self.iters = []

    def record_ksp(self, info):
        self.iters.append(int(info.iterations))


def run(solver):
    mon = Iters()
    solver.monitor = mon
    status = solver.solve((0.0, 0.5), dt=0.1, save_freq=1)
    v, u = (np.array(x.cpu()) if hasattr(x, "cpu") else np.asarray(x) for x in (solver.v, solver.u_e))
    return status, mon.iters, v, u


@pytest.mark.parametrize("scheme", ["monolithic", "gs"])
def test_amg_u_precond_on_unstructured_lv(scheme):
    js = JBidomain(use_pallas_ode=False, u_precond="auto", scheme=scheme, **lv_setup("jax"))
    assert js._u_amg and not js._u_dct
    status_j, iters_j, v_j, u_j = run(js)
    assert status_j.name == "OK"

    port = {}
    for precond in ("auto", "jacobi"):
        ts = TBidomain(device="cpu", u_precond=precond, scheme=scheme, **lv_setup("port"))
        assert ts._u_amg == (precond == "auto") and not ts._u_dct and not ts._structured
        launches = cuda_ell.csr_spmv.launches
        port[precond] = run(ts)
        assert cuda_ell.csr_spmv.launches == launches  # B8's twin on the CPU
        assert port[precond][0] == Status.OK
    _, iters_amg, v_amg, u_amg = port["auto"]
    _, iters_jac, v_jac, u_jac = port["jacobi"]
    assert max(iters_amg) * 2 <= max(iters_jac), (iters_amg, iters_jac)
    assert len(iters_amg) == len(iters_j) == 5
    assert all(abs(a - b) <= 1 for a, b in zip(iters_amg, iters_j)), (iters_amg, iters_j)
    for got, ref in ((v_amg, v_j), (u_amg, u_j), (v_amg, v_jac), (u_amg, u_jac)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.abs(u_amg).max() > 1e-3  # the field is not trivially zero


def test_amg_options_and_cache(tmp_path, monkeypatch):
    """``u_amg_opts`` reach ``build_amg`` over the JAX defaults (a larger
    coarse size: fewer levels), and ``cache_key`` stores the hierarchy in
    the port's cache directory, read back by a second solver with the
    same run bit for bit."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    kw = dict(device="cpu", u_precond="amg", **lv_setup("port"))
    deep = TBidomain(u_amg_opts={"coarse_n": 100}, **kw)
    shallow = TBidomain(**kw)
    assert deep._amg.n_levels > shallow._amg.n_levels
    a = TBidomain(cache_key="lv", **kw)
    slots = list((tmp_path / "fenicsx_beat_tpu_torch" / "amg").glob("*.npz"))
    assert len(slots) == 1
    b = TBidomain(cache_key="lv", **kw)
    ra, rb = run(a), run(b)
    assert ra[1] == rb[1] and np.array_equal(ra[2], rb[2]) and np.array_equal(ra[3], rb[3])
