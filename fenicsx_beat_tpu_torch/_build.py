"""Build the port's CUDA kernels from ``csrc/`` at first use and load them.

``nvcc`` compiles every ``csrc/*.cu`` file for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into one
shared library with a plain C interface, bound with :mod:`ctypes` (no
PyTorch headers in the build, so it takes seconds, not minutes).  The
library goes to ``build/torch_kernels/libfbt_kernels-<hash>.so`` beside
the package, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is loaded as it is; the compiler's report is
kept beside it (``.log``) and read back with it.  A model that
``odefile.load_ode`` generated gets a library of its own
(:func:`load_model_library`): the templates ``csrc/ode_*.cu.in`` with its
node body, keyed by a hash of body, templates and flags.  Nothing here runs
at import time; a build failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = [
    "KernelLibrary", "load_library", "load_model_library", "model_symbol", "NVCC_FLAGS", "ptxas_resources",
    "source_seconds",
    "check", "require_cuda_f32", "require_cuda_i32", "require_f32_like", "stream_ptr", "num_blocks",
]

_CSRC = Path(__file__).with_name("csrc")
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills
]
# The ionic kernels round every product and every sum on its own, as their
# plain twins' elementwise PyTorch operations do: no contraction into fused
# multiply-adds, whose placement the compiler chooses per kernel.  B1's
# forms, which differ only in where the parameters come from, then give
# the same bits on the same parameters.
_NO_FMA_SOURCES = ("tp06_grl", "torord_grl", "torord_land_grl", "tp06_fe", "torord_fe", "torord_land_fe", "fhn_",
                   "ode_")
# The kernels of TP06, ToR-ORd dynCl and ToR-ORd dynCl + Land divide with
# the card's approximate full-range division (at most 2 ulp), not the IEEE
# sequence whose checks and slow-path branches took about a third of TP06's
# instructions: TP06's B1 at n = 442,401 runs in 30 us instead of 51 on an
# H100, with the one-step and one-beat errors against the twin what the
# IEEE build gives (benchmarks/b1_designs.py, PERF.md).  B1, the per-node
# form and B7 of each model share the flags, so a uniform parameter field
# gives B1's bits; the forward-Euler sources (``*_fe*.cu``, each a GRL
# source built with its node body's scheme switch) take the same flags.
# FitzHugh-Nagumo and the generated models keep the IEEE division.
_APPROX_DIV_SOURCES = ("tp06_grl", "torord_grl", "torord_land_grl", "tp06_fe", "torord_fe", "torord_land_fe")


def _nvcc_flags(src: Path) -> list[str]:
    """The nvcc flags of one source file."""
    return (NVCC_FLAGS + (["-fmad=false"] if src.stem.startswith(_NO_FMA_SOURCES) else [])
            + (["-prec-div=false"] if src.stem.startswith(_APPROX_DIV_SOURCES) else []))


_P = ctypes.c_void_p
# the ionic steps' C signatures, one per form, shared by every model
_GRL_STEP = (ctypes.c_int, [_P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, _P, _P])
_GRL_NODE_STEP = (ctypes.c_int, [_P, _P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, _P])
_GRL_MULTI_STEP = (  # ..., table, nm, blocks (null: every block), nblocks, stream
    ctypes.c_int,
    [_P, _P, _P, ctypes.c_longlong, ctypes.c_float, ctypes.c_float, _P, ctypes.c_int, _P, ctypes.c_int, _P],
)
_SIGNATURES = {
    # name: (restype, argtypes) -- pointers and the stream as c_void_p
    "tp06_grl_step_v": _GRL_STEP,
    "tp06_grl_node_step_v": _GRL_NODE_STEP,
    "tp06_grl_multi_step_v": _GRL_MULTI_STEP,
    "torord_grl_step_v": _GRL_STEP,
    "torord_grl_node_step_v": _GRL_NODE_STEP,
    "torord_grl_multi_step_v": _GRL_MULTI_STEP,
    "torord_land_grl_step_v": _GRL_STEP,
    "torord_land_grl_node_step_v": _GRL_NODE_STEP,
    "torord_land_grl_multi_step_v": _GRL_MULTI_STEP,
    # forward Euler: the GRL sources built with the node bodies' kFE switch
    "tp06_fe_step_v": _GRL_STEP,
    "tp06_fe_node_step_v": _GRL_NODE_STEP,
    "tp06_fe_multi_step_v": _GRL_MULTI_STEP,
    "torord_fe_step_v": _GRL_STEP,
    "torord_fe_node_step_v": _GRL_NODE_STEP,
    "torord_fe_multi_step_v": _GRL_MULTI_STEP,
    "torord_land_fe_step_v": _GRL_STEP,
    "torord_land_fe_node_step_v": _GRL_NODE_STEP,
    "torord_land_fe_multi_step_v": _GRL_MULTI_STEP,
    "fhn_step_v": _GRL_STEP,
    "fhn_node_step_v": _GRL_NODE_STEP,
    "fhn_multi_step_v": _GRL_MULTI_STEP,
    "stencil_spmv_sym": (  # vals, x, y, n, offsets, kp, partials, counter, dot, stream
        ctypes.c_int,
        [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P, _P, _P],
    ),
    "stencil_spmv_sym_dir_dot": (  # vals, z, p_old, rz_cur, rz_prev, p, ap, n, offsets, kp,
        ctypes.c_int,              # partials, counter, pap, alpha, stream
        [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P, _P, _P, _P],
    ),
    "cg_update": (
        ctypes.c_int,
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P],
    ),
    "axpy": (ctypes.c_int, [_P, _P, _P, _P, ctypes.c_longlong, _P]),
    "csr_spmv": (  # indptr, cols, vals, x, y, n_rows, long_rows, n_long, long_len, stream
        ctypes.c_int,
        [_P, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, _P],
    ),
    "stencil_spmv": (
        ctypes.c_int,
        [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P, _P],
    ),
    "stencil_spmv_window": (
        ctypes.c_int,
        [_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int, _P, _P, _P],
    ),
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was loaded
    compiler_output: str  # nvcc's -Xptxas -v report, of this build or the one loaded


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _source_tag(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(" ".join(_nvcc_flags(src)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out: Path, workdir: Path, include: list[Path]) -> tuple[float, str]:
    """Compile ``sources`` (one nvcc each, all started together) and link
    them into the shared library ``out``, renamed into place at the end,
    so a process that builds the same library at the same time never
    loads half a file, after the report (``out`` with suffix ``.log``), so a
    library on disk always has its report: each source's compiler output
    under a ``== name (seconds)`` line (:func:`source_seconds`).  A source's
    nvcc that is killed (a failed build) is reaped here too.  Returns
    (seconds, the compiler's report); raises on a failed compile or link."""
    nvcc = _nvcc()
    incs = [f"-I{d}" for d in include]
    tic = time.perf_counter()
    objs, procs, outs = [], [], []
    for src in sources:
        obj = workdir / f"{src.stem}.o"
        objs.append(obj)
        outs.append(open(workdir / f"{src.stem}.out", "w+"))
        procs.append(subprocess.Popen(
            [nvcc, *_nvcc_flags(src), *incs, "-c", "-o", str(obj), str(src)],
            stdout=outs[-1], stderr=subprocess.STDOUT, text=True,
        ))
    # each source's wall from the common start, and the CPU seconds of its
    # nvcc and every process nvcc waited for (wait4's usage of the child)
    seconds = [None] * len(procs)
    try:
        while None in seconds:
            for i, proc in enumerate(procs):
                if seconds[i] is None:
                    pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
                    if pid:
                        proc.returncode = os.waitstatus_to_exitcode(status)
                        seconds[i] = (time.perf_counter() - tic, usage.ru_utime + usage.ru_stime)
            if time.perf_counter() - tic > 600:
                raise RuntimeError("nvcc took more than 600 s")
            time.sleep(0.02)
    finally:
        for proc in procs:  # none outlives a failed or timed-out build
            if proc.returncode is None:
                proc.kill()
                proc.wait()
    logs, failed = [], []
    for src, proc, text, (wall, cpu) in zip(sources, procs, outs, seconds):
        text.seek(0)
        logs.append(f"== {src.name} ({wall:.2f} s wall, {cpu:.2f} s cpu)\n{text.read()}")
        text.close()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = workdir / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True, timeout=600,
    )
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    seconds = time.perf_counter() - tic
    report = workdir / "report.log"
    report.write_text(log)
    os.replace(report, out.with_suffix(".log"))
    os.replace(tmp, out)
    return seconds, log


def _built(out: Path, build) -> tuple[float, str]:
    """(seconds, the compiler's report) of the library ``out``: read from
    its saved report when the library and the report are both on disk,
    else built by ``build(workdir)`` in a scratch directory."""
    report = out.with_suffix(".log")
    if out.is_file() and report.is_file():
        return 0.0, report.read_text()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
        return build(Path(td))


def _bind(out: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(out))
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Compile (if needed) and load the kernel library; raises on failure."""
    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    out = _BUILD_DIR / f"libfbt_kernels-{_source_tag(sources + headers)}.so"
    seconds, log = _built(out, lambda work: _compile(sources, out, work, []))
    return KernelLibrary(lib=_bind(out, _SIGNATURES), path=out, build_seconds=seconds, compiler_output=log)


# A generated ionic model's kernels (odefile.py): three hand-written
# templates, each instantiated with the model's node body, as B1, B1's
# per-node form and B7, each for GRL1 and forward Euler.
_MODEL_TEMPLATES = ("ode_step.cu.in", "ode_node.cu.in", "ode_multi.cu.in")
_MODEL_FORMS = {"step_v": _GRL_STEP, "node_step_v": _GRL_NODE_STEP, "multi_step_v": _GRL_MULTI_STEP}
_MODEL_SCHEMES = ("grl", "fe")


def model_symbol(body: str) -> str:
    """The C symbol prefix of the kernels of the node body ``body``:
    ``ode_<hash>`` of the body, the templates, ``common.cuh`` and the
    flags, so libraries of two models, or of two versions of one, never
    share a name."""
    h = hashlib.sha256(body.encode())
    for name in (*_MODEL_TEMPLATES, "common.cuh"):
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_nvcc_flags(Path(_MODEL_TEMPLATES[0][: -len(".in")]))).encode())
    return f"ode_{h.hexdigest()[:16]}"


@functools.lru_cache(maxsize=None)
def load_model_library(body: str) -> KernelLibrary:
    """Compile (if needed) and load the kernels of a generated model's node
    body (``module.cuda_source``) into
    ``build/torch_kernels/libfbt_<symbol>.so``: the three templates of
    ``csrc/`` with the body included, one nvcc each, built as the ionic
    sources are (``-fmad=false``).  The C entry points are
    ``<symbol>_<scheme>_<form>`` for the schemes ``grl`` and ``fe`` and the
    forms ``step_v``, ``node_step_v`` and ``multi_step_v``.  Raises on a
    failed build."""
    sym = model_symbol(body)
    out = _BUILD_DIR / f"libfbt_{sym}.so"

    def build(work: Path) -> tuple[float, str]:
        (work / "ode_body.cuh").write_text(body)
        sources = []
        for name in _MODEL_TEMPLATES:
            src = work / name[: -len(".in")]
            src.write_text((_CSRC / name).read_text().replace("@SYM@", sym))
            sources.append(src)
        return _compile(sources, out, work, [_CSRC])

    seconds, log = _built(out, build)
    signatures = {f"{sym}_{scheme}_{form}": sig for scheme in _MODEL_SCHEMES for form, sig in _MODEL_FORMS.items()}
    return KernelLibrary(lib=_bind(out, signatures), path=out, build_seconds=seconds, compiler_output=log)


def source_seconds(log: str) -> dict[str, tuple[float, float]]:
    """``{source file name: (wall, cpu)}`` seconds from a build's report:
    the wall from the build's start to the source's end (all run at once),
    and the CPU time of its nvcc and of every process nvcc ran for it."""
    pattern = r"^== (\S+) \(([\d.]+) s wall, ([\d.]+) s cpu\)$"
    return {m.group(1): (float(m.group(2)), float(m.group(3))) for m in re.finditer(pattern, log, re.M)}


def ptxas_resources(log: str) -> dict[str, tuple[int, int, int]]:
    """``{mangled kernel name: (registers, spill store bytes, spill load
    bytes)}`` from nvcc's ``-Xptxas -v`` report."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line):
            name = m.group(1)
        elif name is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name] = (out.get(name, (0,))[0], int(m.group(1)), int(m.group(2)))
        elif name is not None and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = (int(m.group(1)), *out.get(name, (0, 0, 0))[1:])
    return out


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def _require_cuda(dtype: torch.dtype, tensors: dict) -> None:
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs a CUDA tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the other operands on {dev}")
        dev = t.device


def require_cuda_f32(**tensors) -> None:
    """The kernels take contiguous float32 tensors on one CUDA device."""
    _require_cuda(torch.float32, tensors)


def require_f32_like(shape: tuple, device: torch.device, **tensors) -> None:
    """Contiguous float32 tensors of ``shape`` on the CUDA ``device``: the
    check of the kernels bound to an operator, kept short because it runs
    every PCG iteration."""
    for name, t in tensors.items():
        if t.shape != shape or t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}, the kernel takes "
                             f"contiguous {shape} float32 on {device}")


def require_cuda_i32(**tensors) -> None:
    """Index operands: contiguous int32 tensors on a CUDA device."""
    _require_cuda(torch.int32, tensors)


def num_blocks(n: int) -> int:
    """Blocks of a one-element-per-thread launch (``fbt::num_blocks`` in
    ``csrc/common.cuh``, 256 threads): the length of a partial-sum buffer."""
    return -(-n // 256)


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
