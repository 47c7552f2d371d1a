"""The kernel library's build cache (``_build._built`` over ``_compile``):
a library on disk keeps nvcc's ``-Xptxas -v`` report beside it, and a
load that finds both reads the report back, so the registers and spills
read from ``KernelLibrary.compiler_output`` do not depend on whether the
library was built in this process.  Runs on the CPU with a stand-in for
``nvcc`` that writes its output files and prints a ptxas report.

The build flags of each source (``_build._nvcc_flags``): every ionic
source rounds without contraction (``-fmad=false``); TP06's, ToR-ORd's
and ToR-ORd dynCl + Land's divide approximately (``-prec-div=false``),
FitzHugh-Nagumo's and the generated models' templates do not, nor does
any other kernel; the forward-Euler sources take their GRL sources' flags.
The report keeps each source's nvcc seconds (``_build.source_seconds``).  And ``benchmarks/b1_designs.py``'s count of a
``cuobjdump -sass`` listing and the sources of its designs (those not
kept from ``benchmarks/b1_designs/``), and the flags of
``benchmarks/lv_division.py``'s builds."""

import stat
from pathlib import Path

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


def untimed(log: str) -> str:
    """A build report without its ``== source (seconds)`` lines."""
    return "\n".join(line for line in log.splitlines() if not line.startswith("== "))


def test_report_read_back_on_a_cache_hit(tmp_path, fake_nvcc):
    out, (_, log) = _load(tmp_path)
    assert out.is_file() and out.with_suffix(".log").read_text() == log
    assert _build.ptxas_resources(log) == {"_Z6kernelPf": (42, 0, 0)}
    compiles = fake_nvcc.read_text().count("x")  # one compile, one link
    again_seconds, again = _load(tmp_path)[1]
    assert again_seconds == 0.0 and again == log
    assert fake_nvcc.read_text().count("x") == compiles  # nothing built again
    assert _build.ptxas_resources(again) == {"_Z6kernelPf": (42, 0, 0)}
    (name, (wall, cpu)), = _build.source_seconds(again).items()
    assert name == "kernel.cu" and wall >= 0.0 and cpu >= 0.0


def test_library_without_its_report_is_built_again(tmp_path, fake_nvcc):
    out, (_, log) = _load(tmp_path)
    out.with_suffix(".log").unlink()
    compiles = fake_nvcc.read_text().count("x")
    _, again = _load(tmp_path)[1]
    assert fake_nvcc.read_text().count("x") == 2 * compiles
    # the same report, but for the seconds each build took
    assert untimed(again) == untimed(log) and out.with_suffix(".log").is_file()


# the forward-Euler sources (``*_fe*.cu``: each a GRL source with its node
# body's scheme switch on) take the GRL sources' flags
APPROX_DIV = ("tp06_grl", "torord_grl", "torord_land_grl", "tp06_fe", "torord_fe", "torord_land_fe")
IEEE_DIV = ("fhn_", "ode_")


@pytest.mark.parametrize("family", [*APPROX_DIV, *IEEE_DIV])
def test_ionic_sources_build_flags(family):
    sources = [p.name for p in sorted(_build._CSRC.iterdir())
               if p.name.startswith(family) and p.name.endswith((".cu", ".cu.in"))]
    assert len(sources) == 3, sources  # B1, its per-node form, B7
    for name in sources:
        flags = _build._nvcc_flags(Path(name.removesuffix(".in")))
        assert "-fmad=false" in flags, name
        assert ("-prec-div=false" in flags) == (family in APPROX_DIV), name


def test_other_sources_keep_the_default_flags():
    others = [p for p in sorted(_build._CSRC.glob("*.cu")) if not p.name.startswith((*APPROX_DIV, *IEEE_DIV))]
    assert {p.name for p in others} >= {"cg_update.cu", "csr_spmv.cu", "stencil_spmv_sym.cu"}
    for src in others:
        assert _build._nvcc_flags(src) == _build.NVCC_FLAGS, src.name


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_135torord_land_grl_multi_step_v_kernelILb1EEEvPfPKfPKiiffPK16TorordLandParamsiS5_
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe20000000800 */
        /*0010*/              @!P0 BRA 0x130 ;                              /* 0x0000000000000947 */
        /*0020*/               @P0 MUFU.RCP R3, R2 ;                        /* 0x0000000200030308 */
        /*0030*/                   FCHK P0, R1, R2 ;                        /* 0x0000000201007302 */
        /*0040*/                   CALL.REL.NOINC 0x1234 ;                  /* 0x0000000000007944 */
        /*0050*/                   BSSY B0, 0x100 ;                         /* 0x000000a000007945 */
        /*0060*/             @!UP0 MUFU.EX2 R3, R2 ;                        /* 0x0000000200037308 */
        /*0070*/                   BSYNC B0 ;                               /* 0x0000000000007941 */
\t\tFunction : _ZN12_GLOBAL__N_130torord_land_grl_step_v_kernelEPfPKfiff16TorordLandParams
        /*0000*/                   EXIT ;                                   /* 0x000000000000794d */
"""


def test_sass_census_counts_each_kernel(monkeypatch):
    from fenicsx_beat_tpu_torch.benchmarks import b1_designs

    monkeypatch.setattr(b1_designs, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(b1_designs.subprocess, "run", lambda cmd, **kw: type("Done", (), {"stdout": _SASS})())
    by_form = b1_designs.by_form(b1_designs.MODELS["torord_dyncl_land"], b1_designs.sass_census(Path("lib.so")))
    assert by_form == {
        "torord_land_grl_multi_step_v[blocks]": {"instructions": 8, "FCHK": 1, "CALL": 1, "BSSY": 1, "BSYNC": 1,
                                                 "MUFU": 2},
        "torord_land_grl_step_v": {"instructions": 1, "FCHK": 0, "CALL": 0, "BSSY": 0, "BSYNC": 0, "MUFU": 0},
    }


@pytest.mark.parametrize("model", ["tp06", "torord_dyncl", "torord_dyncl_land"])
def test_b1_designs_sources(model):
    from fenicsx_beat_tpu_torch.benchmarks import b1_designs

    m = b1_designs.MODELS[model]
    jobs = b1_designs.designs(m, None)
    kept = tuple(_build._CSRC / s for s in m.sources)
    assert b1_designs.library_name(m) in jobs and "ieee-div" in jobs and "use_fast_math" in jobs
    for name, (include, flags, sources) in jobs.items():
        assert include.is_dir() and sources and all(src.is_file() for src in sources), name
        assert ("-prec-div=false" in flags) == (name not in ("ieee-div", "use_fast_math")), name
    apart = {name: sources for name, (_, _, sources) in jobs.items() if sources != kept}
    if m.torord:  # the designs not kept come from b1_designs/, beside the library's B1 forms where they are B7's
        d = b1_designs._DESIGNS
        assert apart == {"unstaged": (d / "unstaged.cu",), "staged-all": (*kept[:2], d / "staged_all.cu"),
                         "smem-table": (*kept[:2], d / "smem_table.cu")}
    else:
        assert apart == {}


@pytest.mark.parametrize("variant", ["library", "ieee", "b7-ieee", "library-ulp"])
def test_lv_division_variant_flags(variant):
    from fenicsx_beat_tpu_torch.benchmarks import lv_division

    flags = lv_division.variant_flags(variant)
    for src in sorted(_build._CSRC.glob("*.cu")):
        torord = src.name.startswith(("torord_grl", "torord_land_grl"))
        ieee = torord and (variant == "ieee" or (variant == "b7-ieee" and src.stem.endswith("_multi")))
        approx = src.name.startswith(APPROX_DIV) and not ieee
        assert ("-prec-div=false" in flags(src)) == approx, src.name
        assert [f for f in flags(src) if f != "-prec-div=false"] == [
            f for f in _build._nvcc_flags(src) if f != "-prec-div=false"], src.name
