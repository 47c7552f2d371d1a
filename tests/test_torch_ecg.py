"""Pseudo-ECG recovery and the ECG analysis functions: the port against the
JAX package in f64 on the CPU (the port on its kernels' twins).

- The unit square (mirroring ``tests/test_ecg.py``): zero voltage gives
  zero potential, the potentials are symmetric and decay, the device
  electrode path equals the lazy forms, a warm-started second solve takes
  at most one iteration, and every number equals JAX's.
- The dx=0.5 Niederer slab (4,305 nodes, the stencil branch: B5's twin,
  and B6's with the 8 MiB rule forced), two frames of the moving wavefront
  of ``benchmarks/ecg_scale.py``, against JAX ``ECGRecovery`` with
  ``use_pallas=True`` (B5 in interpret mode, 5,120 padded rows) and
  ``use_pallas=False``: Im within 1e-9 of max|Im|, the 10 potentials within
  rtol 1e-9, CG iterations within one.  Both sides stop CG at rtol 1e-8,
  summing in other orders; the measured gaps are near 1e-13.
- The psize 0.3 LV (9,780 nodes, the CSR branch: B8's twin) against JAX's
  plain ELL path, with a front across the LV (x = -5 mm), the same limits.
- ``qt_interval``, ``apd``, ``restitution_curve``, ``Leads12`` and
  ``example``: equal to JAX's on the same inputs.
"""

import numpy as np
import pytest
import torch

import fenicsx_beat_tpu as beat
from fenicsx_beat_tpu import ecg as jecg
from fenicsx_beat_tpu import fem as jfem
from fenicsx_beat_tpu import mesh as jmesh
from fenicsx_beat_tpu.geometry import get_3D_slab_geometry as j_slab
from fenicsx_beat_tpu.geometry import get_lv_ellipsoid_geometry as j_lv
from fenicsx_beat_tpu_torch import ECGRecovery, Leads12
from fenicsx_beat_tpu_torch import ecg as tecg
from fenicsx_beat_tpu_torch import fem as tfem
from fenicsx_beat_tpu_torch import mesh as tmesh
from fenicsx_beat_tpu_torch.benchmarks import ecg_scale
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry as t_slab
from fenicsx_beat_tpu_torch.geometry import get_lv_ellipsoid_geometry as t_lv

ELECTRODES = list(ecg_scale.ELECTRODES_MM.values())


def square_pair(N):
    jV = jfem.functionspace(jmesh.create_unit_square(None, N, N), ("P", 1))
    tV = tfem.functionspace(tmesh.create_unit_square(None, N, N), ("P", 1))
    return jfem.Function(jV), tfem.Function(tV)


def test_ecg_unit_square_matches_jax():
    jv, tv = square_pair(5)
    je = beat.ECGRecovery(v=jv, M=1.0, C_m=1.0, sigma_b=1.0)
    te = ECGRecovery(v=tv, M=1.0, C_m=1.0, sigma_b=1.0, device="cpu")
    assert te.kernel == "B5" and te.dtype == torch.float64
    points = [(1.5, 0.5), (10.0, 0.5), (-0.5, 0.5)]
    jforms, tforms = [je.eval(p) for p in points], [te.eval(p) for p in points]
    te.solve()
    assert np.isclose(tfem.assemble_scalar(tforms[0]), 0.0)

    for v in (jv, tv):
        v.interpolate(lambda x: (x[0] - 0.5) ** 2)
    np.testing.assert_array_equal(tv.x.array, jv.x.array)
    je.solve()
    te.solve()
    got = np.array([tfem.assemble_scalar(f) for f in tforms])
    want = np.array([jfem.assemble_scalar(f) for f in jforms])
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert np.isclose(got[0], got[2])
    assert abs(got[1]) < abs(got[0])
    assert te.last_info.iterations == int(je.last_info.iterations)


def test_device_electrode_path_matches_lazy_forms_and_jax():
    jv, tv = square_pair(6)
    for v in (jv, tv):
        v.interpolate(lambda x: np.sin(np.pi * x[0]) * x[1])
    je = beat.ECGRecovery(v=jv, M=1.0)
    te = ECGRecovery(v=tv, M=1.0, device="cpu")
    points = [(1.5, 0.5), (-0.5, 0.25), (0.5, 2.0)]
    forms = [te.eval(p) for p in points]
    je.register_electrodes(points)
    te.register_electrodes(points)
    np.testing.assert_allclose(te._electrode_W.numpy(), np.asarray(je._electrode_W), rtol=1e-12, atol=1e-15)

    je.solve()
    te.solve()
    expected = np.array([tfem.assemble_scalar(f) for f in forms])
    got = te.electrode_potentials()
    np.testing.assert_allclose(got, expected, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, je.electrode_potentials(), rtol=1e-9, atol=1e-12)

    # warm start: a second solve from the first solution converges at once
    te.solve_device()
    assert te.last_info.iterations <= 1


def _frames(ecg, v, x, k_frames=2):
    out = []
    for k in range(k_frames):
        v.x.array[:] = ecg_scale.wavefront(x, k)
        im, info = ecg.solve_device()
        out.append((np.asarray(im)[: x.shape[0]], ecg.electrode_potentials(im), int(info.iterations)))
    return out


@pytest.fixture(scope="module")
def slab_jax():
    """JAX ECGRecovery on the dx=0.5 slab: Pallas (interpret) and plain."""
    geo = j_slab(None, dx=0.5, Lx=20.0, Ly=7.0, Lz=3.0)
    V = jfem.functionspace(geo.mesh, ("P", 1))
    out = {}
    for use_pallas in (True, False):
        v = jfem.Function(V)
        je = beat.ECGRecovery(v=v, M=1.0, use_pallas=use_pallas)
        je.register_electrodes(ELECTRODES)
        out[use_pallas] = _frames(je, v, np.asarray(V.dof_coords))
    return out


def _assert_frames_match(port, ref):
    for (ti, tp, tit), (ji, jp, jit) in zip(port, ref):
        np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-9 * np.abs(ji).max())
        np.testing.assert_allclose(tp, jp, rtol=1e-9)
        assert abs(tit - jit) <= 1


@pytest.mark.parametrize("kernel", ["B5", "B6"])
def test_slab_recovery_matches_jax(slab_jax, kernel, monkeypatch):
    if kernel == "B6":  # the windowed branch, taken above 8 MiB on the card
        monkeypatch.setattr(tecg, "WINDOW_OPERAND_BYTES", 0)
    geo = t_slab(None, dx=0.5, Lx=20.0, Ly=7.0, Lz=3.0)
    V = tfem.functionspace(geo.mesh, ("P", 1))
    assert V.ndofs == 4305
    v = tfem.Function(V)
    te = ECGRecovery(v=v, M=1.0, device="cpu")
    assert te.kernel == kernel and len(te.offsets) == 15
    te.register_electrodes(ELECTRODES)
    port = _frames(te, v, V.dof_coords)
    for use_pallas in (True, False):
        _assert_frames_match(port, slab_jax[use_pallas])


def test_lv_csr_branch_matches_jax():
    def front(x, k):
        return -85.0 + 125.0 / (1.0 + np.exp(-(x[:, 0] + 5.0 - 0.5 * k) / 0.5))

    jV = jfem.functionspace(j_lv(psize_ref=0.3, cache=False).mesh, ("P", 1))
    tV = tfem.functionspace(t_lv(psize_ref=0.3).mesh, ("P", 1))
    assert tV.ndofs == 9780
    runs = []
    for ecg_cls, V, kw in ((beat.ECGRecovery, jV, {"use_pallas": False}), (ECGRecovery, tV, {"device": "cpu"})):
        v = (jfem if V is jV else tfem).Function(V)
        e = ecg_cls(v=v, M=1.0, **kw)
        e.register_electrodes(ELECTRODES)
        x = np.asarray(V.dof_coords)
        out = []
        for k in range(2):
            v.x.array[:] = front(x, k)
            im, info = e.solve_device()
            out.append((np.asarray(im), e.electrode_potentials(im), int(info.iterations)))
        runs.append((e, out))
    assert runs[1][0].kernel == "B8"
    _assert_frames_match(runs[1][1], runs[0][1])


def test_default_device_is_the_card():
    _, tv = square_pair(2)
    if torch.cuda.is_available():
        assert ECGRecovery(v=tv).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ECGRecovery(v=tv)


def test_ecg_scale_and_niederer_ecg_run_on_cpu():
    """Both benchmark functions at dx=0.5 on the CPU: the keys, the kernel
    choice, converged and finite frames."""
    out = ecg_scale.run_ecg_scale(dx=0.5, n_frames=2, device="cpu")
    assert out["kernel"] == "B5" and out["n_nodes"] == 4305 and out["n_cells"] == 20160
    assert all(out["cg_converged_per_frame"]) and out["potentials_finite"]
    assert np.isfinite(out["lead_I_sample"])
    res = ecg_scale.run_niederer_ecg(dx=0.5, T=1.0, frame_ms=0.5, device="cpu")
    assert res["n_frames"] == 2 and res["kernel"] == "B5"
    assert all(res["cg_converged_per_frame"])
    assert np.array(res["potentials"]).shape == (2, 10)
    assert set(res["leads"]) == set(ecg_scale.LEAD_NAMES)
    assert np.isfinite(np.array(res["potentials"])).all()


# ---------------------------------------------------------------------------
# the copied numpy/scipy analysis


def _ap_train(cl=300.0, apds=(250.0, 230.0, 210.0), dt=0.5):
    t = np.arange(0.0, cl * len(apds) + 100.0, dt)
    v = np.full(t.size, -85.0)
    for k, a in enumerate(apds):
        t0 = 10.0 + k * cl
        up = (t >= t0) & (t < t0 + 1.0)
        down = (t >= t0 + 1.0) & (t < t0 + a)
        v[up] = -85.0 + (t[up] - t0) * 125.0
        v[down] = 40.0 - (t[down] - (t0 + 1.0)) * 125.0 / (a - 1.0)
    return t, v


def test_analysis_functions_equal_jax():
    kw = dict(sampling_rate_hz=1000, duration_s=2, noise_amplitude=0.0, heart_rate_bpm=70)
    t, y = tecg.example(**kw)
    tj, yj = jecg.example(**kw)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(y, yj)
    assert tuple(tecg.qt_interval(t=t, ecg_signal=y)) == tuple(jecg.qt_interval(t=tj, ecg_signal=yj))
    np.testing.assert_array_equal(tecg.detect_r_peaks(y), jecg.detect_r_peaks(y))
    assert tecg.detect_t_end(y, 200) == jecg.detect_t_end(y, 200)

    for apds in ((250.0, 230.0, 210.0), (200.0, 280.0, 310.0, 150.0)):
        t, v = _ap_train(cl=320.0, apds=apds)
        np.testing.assert_array_equal(tecg.apd(t, v), jecg.apd(t, v))
        np.testing.assert_array_equal(tecg.apd(t, v, repolarization=50.0), jecg.apd(t, v, repolarization=50.0))
        for a, b in zip(tecg.restitution_curve(t, v), jecg.restitution_curve(t, v)):
            np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(5)
    phi = rng.standard_normal((10, 7))
    names = list(ecg_scale.ELECTRODES_MM)
    tl = Leads12(**dict(zip(names, phi)))
    jl = jecg.Leads12(**dict(zip(names, phi)))
    for lead in ecg_scale.LEAD_NAMES + ("Vw",):
        np.testing.assert_array_equal(getattr(tl, lead), getattr(jl, lead))
    with pytest.raises(AttributeError):
        Leads12(RA=phi[0], LA=phi[1], LL=phi[2]).V1_
