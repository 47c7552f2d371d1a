"""Device time of B2 (with its dot) and B2·B4 in the designs that were
measured for them, at the main path's shapes.

- ``kept``: ``csrc/stencil_spmv_sym.cu``, one row a thread, at 128, 256,
  512 and 1024 rows a block (its ``STENCIL_SYM_BLOCK``; the library is
  built at 512);
- ``window``: ``b2_designs/window.cu``, 4 rows a thread with 128-bit
  value loads beside a window of x staged in shared memory with cp.async,
  at 1024 and 2048 rows a block (the value table padded to rows of a
  multiple of 4 floats, so that they are 16-byte aligned);
- ``march``: ``b2_designs/march.cu``, a block marching along x with a
  rolling three-plane window, at 4 and 8 planes a block.

Each source is built by ``nvcc`` into a library of its own (one process
each, all started together), run on the theta-system operator of the
dx=0.1 Niederer slab (n = 442,401, Kp = 8), held against the plain
PyTorch twins (``max|k - w| / max|w| <= 1e-4`` on y, the dot, p', Ap',
pAp and alpha) and timed under ``torch.profiler`` (device time per call,
:func:`~.profile_main.device_us_per_call`).  Prints one line per design
and size, the card's name and power limit, and a JSON object last.  Needs
one card::

    python -m fenicsx_beat_tpu_torch.benchmarks.b2_designs
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .._build import _SIGNATURES, _BUILD_DIR, _CSRC, NVCC_FLAGS, _nvcc, check
from ..ops import cuda_spmv
from .niederer import _build_solver
from .profile_main import device_us_per_call

REL_TOL = 1e-4
_HERE = Path(__file__).with_name("b2_designs")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the designs not kept take the table's row stride and their size as arguments
_STRIDED = {
    "stencil_spmv_sym": (_I, [_P, _L, _P, _P, _L, _P, _I, _I, _P, _P, _P, _P]),
    "stencil_spmv_sym_dir_dot": (_I, [_P, _L, _P, _P, _P, _P, _P, _P, _L, _P, _I, _I, _P, _P, _P, _P, _P]),
}
# (design, source, sizes, sizes built in as STENCIL_SYM_BLOCK)
DESIGNS = (
    ("kept", _CSRC / "stencil_spmv_sym.cu", (128, 256, 512, 1024), True),
    ("window", _HERE / "window.cu", (1024, 2048), False),
    ("march", _HERE / "march.cu", (4, 8), False),
)


def build_all(workdir: Path) -> dict:
    """``{(design, size or None): ctypes library}``: every library compiled
    at once, one nvcc process each."""
    jobs = {}
    for name, src, sizes, built_in in DESIGNS:
        for size in sizes if built_in else (None,):
            out = workdir / f"lib{name}{size or ''}.so"
            defines = [f"-DSTENCIL_SYM_BLOCK={size}"] if built_in else []
            cmd = [_nvcc(), *NVCC_FLAGS, f"-I{_CSRC}", *defines, "-shared", "-o", str(out), str(src)]
            jobs[name, size] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                      text=True))
    libs = {}
    for key, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (res, args) in (_SIGNATURES if key[1] is not None else _STRIDED).items():
            if fn.startswith("stencil_spmv_sym"):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, args
        libs[key] = lib
    return libs


def rel_err(k: torch.Tensor, w: torch.Tensor) -> float:
    return float((k - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b2_designs needs a CUDA card", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    solver = _build_solver(dx=0.1, theta=0.5, device=dev)
    A, pos, n = solver._operators(0.05)[0], solver._pos, solver._n
    kp = len(pos)
    offs = (ctypes.c_int * kp)(*pos)
    ld = -(-n // 4) * 4
    padded = torch.zeros(kp, ld, dtype=torch.float32, device=dev)
    padded[:, :n] = A
    rng = np.random.default_rng(args.seed)
    x, z, p_old = (torch.as_tensor(rng.uniform(-90.0, 40.0, n), dtype=torch.float32, device=dev)
                   for _ in range(3))
    rz_cur = torch.tensor(0.83, dtype=torch.float32, device=dev)
    rz_prev = torch.tensor(1.37, dtype=torch.float32, device=dev)
    want = (*cuda_spmv.stencil_spmv_sym_dot_twin(A, x, pos),
            *cuda_spmv.stencil_spmv_sym_dir_dot_twin(A, z, p_old, pos, rz_cur, rz_prev))
    y, p, apv = (torch.empty(n, device=dev) for _ in range(3))
    scalars = torch.empty(3, device=dev)  # <x, A x>, pAp, alpha
    partials = torch.empty(-(-n // 32), dtype=torch.float64, device=dev)  # more than any design's grid
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    dot_ptr, pap_ptr, alpha_ptr = (scalars.data_ptr() + 4 * i for i in range(3))
    f32 = 4
    bounds_us = {"b2_dot": (kp + 2) * n * f32 / 3.35e12 * 1e6, "b2b4": (kp + 4) * n * f32 / 3.35e12 * 1e6}

    work = _BUILD_DIR.parent / "b2_designs"  # beside the kernel library's builds
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as td:
        libs = build_all(Path(td))
        rows = []
        for name, _, sizes, built_in in DESIGNS:
            for size in sizes:
                lib = libs[name, size if built_in else None]
                if built_in:
                    def b2(lib=lib):
                        check(lib.stencil_spmv_sym(A.data_ptr(), x.data_ptr(), y.data_ptr(), n, offs, kp,
                                                   partials.data_ptr(), counter.data_ptr(), dot_ptr, stream),
                              "stencil_spmv_sym")

                    def b2b4(lib=lib):
                        check(lib.stencil_spmv_sym_dir_dot(
                            A.data_ptr(), z.data_ptr(), p_old.data_ptr(), rz_cur.data_ptr(), rz_prev.data_ptr(),
                            p.data_ptr(), apv.data_ptr(), n, offs, kp, partials.data_ptr(), counter.data_ptr(),
                            pap_ptr, alpha_ptr, stream), "stencil_spmv_sym_dir_dot")
                else:
                    def b2(lib=lib, size=size):
                        check(lib.stencil_spmv_sym(padded.data_ptr(), ld, x.data_ptr(), y.data_ptr(), n, offs, kp,
                                                   size, partials.data_ptr(), counter.data_ptr(), dot_ptr, stream),
                              "stencil_spmv_sym")

                    def b2b4(lib=lib, size=size):
                        check(lib.stencil_spmv_sym_dir_dot(
                            padded.data_ptr(), ld, z.data_ptr(), p_old.data_ptr(), rz_cur.data_ptr(),
                            rz_prev.data_ptr(), p.data_ptr(), apv.data_ptr(), n, offs, kp, size,
                            partials.data_ptr(), counter.data_ptr(), pap_ptr, alpha_ptr, stream),
                            "stencil_spmv_sym_dir_dot")

                b2()
                b2b4()
                torch.cuda.synchronize()
                err = max(rel_err(k, w) for k, w in zip((y, scalars[0], p, apv, scalars[1], scalars[2]), want))
                row = {"design": name, "size": size, "size_unit": "planes" if name == "march" else "rows",
                       "b2_dot_us": device_us_per_call(b2), "b2b4_us": device_us_per_call(b2b4),
                       "max_rel_err": err}
                rows.append(row)
                print(f"[b2_designs] {name}, {size} {row['size_unit']} a block: B2 with its dot "
                      f"{row['b2_dot_us']:.2f} us, B2·B4 {row['b2b4_us']:.2f} us (device, torch.profiler); "
                      f"max|k-w|/max|w| {err:.3e}")
                if not err <= REL_TOL:
                    print(f"[b2_designs] {name} at {size} disagrees with the twins", file=sys.stderr)
                    return 1
    print(f"[b2_designs] bounds (bytes over 3.35 TB/s): B2 with its dot {bounds_us['b2_dot']:.2f} us, "
          f"B2·B4 {bounds_us['b2b4']:.2f} us; n={n}, offsets {pos}")
    print(gpu)
    print(json.dumps({"b2_designs": rows, "bound_us": bounds_us, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
