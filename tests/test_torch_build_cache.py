"""The kernel library's build cache (``_build._built`` over ``_compile``):
a library on disk keeps nvcc's ``-Xptxas -v`` report beside it, and a
load that finds both reads the report back, so the registers and spills
read from ``KernelLibrary.compiler_output`` do not depend on whether the
library was built in this process.  Runs on the CPU with a stand-in for
``nvcc`` that writes its output files and prints a ptxas report."""

import stat

import pytest

from fenicsx_beat_tpu_torch import _build

REPORT = ("ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'\n"
          "ptxas info    : Function properties for _Z6kernelPf\n"
          "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
          "ptxas info    : Used 42 registers, used 0 barriers\n")


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in for ``nvcc`` that writes the file after ``-o`` and prints
    :data:`REPORT` when it compiles; its calls are counted in ``calls``."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        'while [ "$#" -gt 0 ]; do if [ "$1" = -o ]; then echo obj > "$2"; fi; shift; done\n'
        f"cat <<'END'\n{REPORT}END\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    return calls


def _load(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text("// one kernel\n")
    out = tmp_path / "build" / "libkernel.so"
    return out, _build._built(out, lambda work: _build._compile([src], out, work, []))


def test_report_read_back_on_a_cache_hit(tmp_path, fake_nvcc):
    out, (_, log) = _load(tmp_path)
    assert out.is_file() and out.with_suffix(".log").read_text() == log
    assert _build.ptxas_resources(log) == {"_Z6kernelPf": (42, 0, 0)}
    compiles = fake_nvcc.read_text().count("x")  # one compile, one link
    again_seconds, again = _load(tmp_path)[1]
    assert again_seconds == 0.0 and again == log
    assert fake_nvcc.read_text().count("x") == compiles  # nothing built again
    assert _build.ptxas_resources(again) == {"_Z6kernelPf": (42, 0, 0)}


def test_library_without_its_report_is_built_again(tmp_path, fake_nvcc):
    out, (_, log) = _load(tmp_path)
    out.with_suffix(".log").unlink()
    compiles = fake_nvcc.read_text().count("x")
    _, again = _load(tmp_path)[1]
    assert fake_nvcc.read_text().count("x") == 2 * compiles
    assert again == log and out.with_suffix(".log").is_file()
