"""The port's command line (``fenicsx_beat_tpu_torch/cli.py``) against the
JAX package's ``cli.main`` on the same files, both on the CPU in float64.

- ``version``, ``--help`` and the bad ``--stim-marker`` exit, as JAX's
  ``tests/test_cli.py`` has them; ``python -m fenicsx_beat_tpu_torch``;
  the slice's modules load no JAX module.
- ``run --mesh`` with FitzHugh-Nagumo on JAX's ``MSH41`` square and on a
  small tetrahedral binary Gmsh 4.1 file (stimulated 100 times the default
  amplitude: the command line's solver keeps the JAX package's C_m of 1
  uF/mm^2), then ``post`` and ``ecg`` on each
  package's checkpoint: the count of activated nodes equal and the
  activation time range within one dt; the checkpoint voltages (float32
  files of float64 runs) within 1e-5 of the largest |v|; the ECG traces
  within 1e-6 of the largest |trace| (the port's electrode weight matrix
  carries the quadrature of JAX's electrode forms; CG rtol 1e-8 on both
  sides).
- ``run`` on the slab at dx=0.5: P1-P9 within one dt of JAX's.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_io import MSH41

import fenicsx_beat_tpu.cli as jcli
import fenicsx_beat_tpu_torch as tbeat
import fenicsx_beat_tpu_torch.cli as tcli
from chip_smoke import write_msh41_binary
from fenicsx_beat_tpu_torch.geometry import get_3D_slab_geometry

DT = 0.1
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_version(capsys):
    assert tcli.main(["version"]) == 0
    out = capsys.readouterr().out
    assert f"fenicsx-beat-tpu: {tbeat.__version__}" in out
    assert f"torch: {torch.__version__}" in out


def test_help_exits_cleanly():
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--help"])
    assert exc.value.code == 0


def test_module_entry_point():
    proc = subprocess.run([sys.executable, "-m", "fenicsx_beat_tpu_torch", "version"], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0 and "fenicsx-beat-tpu: " in proc.stdout


def test_slice_imports_neither_jax_nor_jax_package():
    """The command line, io, the native kit and its benchmark, after a
    ``version`` call and a kit build, leave no JAX module loaded."""
    code = (
        "import sys; import fenicsx_beat_tpu_torch.cli as c, fenicsx_beat_tpu_torch.io, "
        "fenicsx_beat_tpu_torch.native as n, fenicsx_beat_tpu_torch.benchmarks.setup_kit; "
        "c.main(['version']); n.library(); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'fenicsx_beat_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_bad_marker_fails_loudly(tmp_path):
    p = tmp_path / "sq.msh"
    p.write_text(MSH41)
    with pytest.raises(SystemExit, match="stim-marker"):
        tcli.main(["run", "--mesh", str(p), "--model", "fitzhughnagumo", "--stim-marker", "99", "-T", "0.2",
                   "--dt", "0.1", "--outdir", str(tmp_path / "out"), "--device", "cpu"])


def _mesh_file(tmp_path, name):
    p = tmp_path / f"{name}.msh"
    if name == "square":
        p.write_text(MSH41)
    else:  # a tetrahedral slab with an end region tagged 3 and the rest 7
        m = get_3D_slab_geometry(None, dx=0.5, Lx=3.0, Ly=1.5, Lz=1.0).mesh
        tags = np.where(m.coords[m.cells].mean(axis=1)[:, 0] < 0.8, 3, 7)
        write_msh41_binary(p, m.coords, m.cells, tags)
    return p


def _line(out: str, head: str) -> str:
    return next(line for line in out.splitlines() if line.startswith(head))


def _range(out: str) -> np.ndarray:
    line = _line(out, "activation time range: ")
    return np.array([float(x) for x in line.split("[")[1].split("]")[0].split(",")])


@pytest.mark.parametrize("name,T,amp", [("square", 1.0, "500"), ("tets", 3.0, "5000000")])
def test_run_mesh_post_ecg_match_jax(name, T, amp, tmp_path, capsys):
    msh = _mesh_file(tmp_path, name)
    outs = {}
    for tag, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        args = ["run", "--mesh", str(msh), "--model", "fitzhughnagumo", "-T", str(T), "--dt", str(DT),
                "--save-freq", "5", "--stim-amplitude", amp, "--outdir", str(d)]
        assert main(args + extra) == 0
        run = capsys.readouterr().out
        assert main(["post", str(d / "voltage.npz")]) == 0
        post = capsys.readouterr().out
        assert main(["ecg", str(d / "voltage.npz")] + extra) == 0
        outs[tag] = (run, post, np.load(d / "voltage.npz"), np.load(d / "voltage_ecg.npz"))
    (jrun, jpost, jv, je), (trun, tpost, tv, te) = outs["jax"], outs["torch"]
    assert _line(trun, "nodes activated") == _line(jrun, "nodes activated")
    assert _line(tpost, "activated nodes") == _line(jpost, "activated nodes")
    n_act = int(_line(trun, "nodes activated").split()[2].split("/")[0])
    if n_act:
        np.testing.assert_allclose(_range(trun), _range(jrun), rtol=0, atol=DT)
        np.testing.assert_allclose(_range(tpost), _range(jpost), rtol=0, atol=DT)
    if name == "tets":
        assert n_act > 0  # the tagged end fired
    np.testing.assert_array_equal(tv["times"], jv["times"])
    np.testing.assert_allclose(tv["values"], jv["values"], rtol=0, atol=1e-5 * np.abs(jv["values"]).max())
    for k in ("coords", "cells"):
        np.testing.assert_array_equal(tv[k], jv[k])
    np.testing.assert_array_equal(te["electrodes"], je["electrodes"])
    np.testing.assert_allclose(te["traces"], je["traces"], rtol=0, atol=1e-6 * np.abs(je["traces"]).max())
    act = np.load(tmp_path / "torch" / "activation_times.npy")
    assert int((act >= 0).sum()) == n_act


def test_run_slab_matches_jax(tmp_path, capsys):
    ats = {}
    for tag, main, extra in (("jax", jcli.main, []), ("torch", tcli.main, ["--device", "cpu"])):
        assert main(["run", "--dx", "0.5", "--outdir", str(tmp_path / tag)] + extra) == 0
        out = capsys.readouterr().out
        assert "Niederer dx=0.5" in out
        ats[tag] = json.loads((tmp_path / tag / "activation_times.json").read_text())[-1]
    assert set(ats["torch"]) == set(ats["jax"])
    for k, v in ats["jax"].items():
        assert abs(ats["torch"][k] - v) <= 0.05 + 1e-9, (k, ats["torch"][k], v)
