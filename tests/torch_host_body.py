"""The port's CUDA ionic node bodies (``fenicsx_beat_tpu_torch/csrc/*.cuh``)
built by the host's g++ into a ctypes library, so the CPU tests hold the
card's formulas against the float32 twins: host stand-ins for the CUDA
names the headers use, and the build.  The body is compiled without
contraction (``-ffp-contract=off``), as the card builds it with
``-fmad=false``; the host divides exactly where the card divides
approximately, so this holds the formulas and ``chip_smoke.py`` the card's
build."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from fenicsx_beat_tpu_torch.ops import cuda_ode

CSRC = Path(cuda_ode.__file__).resolve().parent.parent / "csrc"

# host stand-ins for the CUDA names the ionic headers use, so the host's
# g++ compiles the card's node body as it is
CUDA_STUB = r"""
#pragma once
#include <cmath>
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
struct fbt_dim3 { unsigned x = 0; };
static fbt_dim3 threadIdx, blockIdx, blockDim;
template <class T> inline T __shfl_down_sync(unsigned, T v, int) { return v; }
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
"""


def build_host_body(tmp_path_factory, name: str, harness: str) -> ctypes.CDLL:
    """``harness`` (C++ that includes a node body's header and exports
    ``extern "C"`` steps) built by the host's g++ into a ctypes library;
    skips without g++."""
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("needs the host's g++")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(CUDA_STUB)
    (d / "harness.cpp").write_text(harness)
    subprocess.run([gpp, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC", f"-I{d}", f"-I{CSRC}",
                    "-o", str(d / "body.so"), str(d / "harness.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(d / "body.so"))


def run_host_step(fn, states: np.ndarray, v: np.ndarray, params: np.ndarray, t: float, dt: float) -> np.ndarray:
    """One step of a harness function ``fn(states, v, params, n, t, dt)``
    on float32 copies of ``states`` (S, n), ``v`` (n,) and ``params``;
    returns the stepped states."""
    out, vf, pf = (np.ascontiguousarray(a, dtype=np.float32).copy() for a in (states, v, params))
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in (out, vf, pf)), ctypes.c_longlong(states.shape[1]),
       ctypes.c_float(t), ctypes.c_float(dt))
    return out
