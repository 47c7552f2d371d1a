"""Device time of B8 in the designs that were measured for it, at the psize
0.1 LV's theta-system operator (243,518 rows), beside ``torch.mv``.

- ``split``: the library's kernel (``csrc/csr_spmv.cu``) through its
  wrapper :func:`~..ops.cuda_ell.csr_spmv`: a warp for each row longer than
  ``cuda_ell.LONG_ROW`` entries (its entries summed in column order), a
  thread for each other row;
- ``split_tree``: ``b8_designs/split_tree.cu``, the same split with the
  warp's lanes striding the row and summed by a butterfly;
- ``subwarp``: ``b8_designs/subwarp.cu``, 4 or 8 lanes for every row;
- ``parent``: with ``--parent DIR``, ``DIR``'s own ``csrc/csr_spmv.cu``
  (another checkout's kernel, its seven-argument entry point; the parent
  of the split, one thread a row);
- ``torch.mv`` on the same operator as a sparse CSR tensor.

Each design source is built by ``nvcc`` into a library of its own (one
process each, all started together; the split is the kernel library's
own build).  Every design is held against the plain
PyTorch twin (``max|k - w| / max|w| <= 1e-4``), run twice for equal bits,
compared bit for bit with the parent's kernel (when given), and timed
twice, in turns with the others: device time under ``torch.profiler``
(:func:`~.profile_main.device_us_per_call`) and back to back (CUDA events
over 20 calls), on the operator and on the same operator with its rows
longer than 64 entries emptied.  Prints one line per design,
the card's name and power limit, and a JSON object last.  Needs one card::

    python -m fenicsx_beat_tpu_torch.benchmarks.b8_designs [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from .._build import _BUILD_DIR, _CSRC, _SIGNATURES, NVCC_FLAGS, _nvcc, check
from ..ops import cuda_ell
from .lv import build_lv_solver
from .profile_main import device_us_per_call

REL_TOL = 1e-4
EMPTIED = 64  # the "long rows emptied" operator drops rows longer than this
_HERE = Path(__file__).with_name("b8_designs")
_P, _L = ctypes.c_void_p, ctypes.c_longlong
_PLAIN = (ctypes.c_int, [_P, _P, _P, _P, _P, _L, _P])  # indptr, cols, vals, x, y, n_rows, stream


def build_all(workdir: Path, parent: Path | None) -> dict:
    """``{design: ctypes library}``, compiled at once, one nvcc each."""
    sources = {"split_tree": (_HERE / "split_tree.cu", _CSRC), "subwarp": (_HERE / "subwarp.cu", _CSRC)}
    if parent is not None:
        sources["parent"] = (parent / "csr_spmv.cu", parent)
    jobs = {}
    for name, (src, inc) in sources.items():
        out = workdir / f"lib{name}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{inc}", "-shared", "-o", str(out), str(src)]
        jobs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"[b8_designs] {name}: " + " ".join(ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln))
        lib = ctypes.CDLL(str(out))
        fns = ({"csr_spmv_tree": _SIGNATURES["csr_spmv"]} if name == "split_tree" else
               {"csr_spmv_subwarp4": _PLAIN, "csr_spmv_subwarp8": _PLAIN} if name == "subwarp" else
               {"csr_spmv": _PLAIN})
        for fn, (res, args) in fns.items():
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, args
        libs[name] = lib
    return libs


def emptied(A: cuda_ell.CSRMatrix, limit: int) -> cuda_ell.CSRMatrix:
    """``A`` with every row longer than ``limit`` entries emptied."""
    lengths = A.indptr[1:] - A.indptr[:-1]
    short = lengths <= limit
    keep = torch.repeat_interleave(short, lengths.long())
    indptr = torch.zeros_like(A.indptr)
    indptr[1:] = torch.cumsum(torch.where(short, lengths, 0), 0).to(torch.int32)
    return cuda_ell.CSRMatrix(indptr=indptr, cols=A.cols[keep].contiguous(), vals=A.vals[keep].contiguous(),
                              shape=A.shape)


def back_to_back_us(fn, launches: int = 20, reps: int = 7) -> float:
    """Median time per call over ``reps`` runs of ``launches`` calls back to
    back (CUDA events), after a warm-up: launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        runs.append((start, end))
    torch.cuda.synchronize()
    return 1e3 * statistics.median(s.elapsed_time(e) for s, e in runs) / launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="the csrc/ directory of another checkout, whose csr_spmv.cu is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b8_designs needs a CUDA card", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    solver = build_lv_solver(psize=0.1, device=dev, precond="jacobi")
    A = solver._operators(0.05)[0]
    n = A.shape[0]
    lengths = (A.indptr[1:] - A.indptr[:-1]).cpu().numpy()
    A_short = emptied(A, EMPTIED)
    x = torch.as_tensor(np.random.default_rng(args.seed).uniform(-90.0, 40.0, n), dtype=torch.float32,
                        device=dev)
    want = cuda_ell.csr_spmv_twin(A, x)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    f32 = 4
    bound_us = (A.nnz * 2 * f32 + (n + 1) * f32 + 2 * n * f32) / 3.35e12 * 1e6
    print(f"[b8_designs] n={n}, {A.nnz} entries, row length max {int(lengths.max())}, mean "
          f"{lengths.mean():.2f}; rows longer than 16/32/64/128: "
          + "/".join(str(int((lengths > L).sum())) for L in (16, 32, 64, 128))
          + f"; bound {bound_us:.2f} us (bytes over 3.35 TB/s)")

    work = _BUILD_DIR.parent / "b8_designs"  # beside the kernel library's builds
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as td:
        libs = build_all(Path(td), args.parent)

        def split_tree(M, fn=libs["split_tree"].csr_spmv_tree):
            n_long = int(M.long_rows.numel())
            check(fn(M.indptr.data_ptr(), M.cols.data_ptr(), M.vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                     M.long_rows.data_ptr() if n_long else None, n_long, cuda_ell.LONG_ROW, stream),
                  "csr_spmv_tree")
            return y

        def plain(lib, fn):
            def run(M):
                check(getattr(lib, fn)(M.indptr.data_ptr(), M.cols.data_ptr(), M.vals.data_ptr(), x.data_ptr(),
                                       y.data_ptr(), n, stream), fn)
                return y
            return run

        S_A = torch.sparse_csr_tensor(A.indptr, A.cols, A.vals, A.shape)
        S_short = torch.sparse_csr_tensor(A_short.indptr, A_short.cols, A_short.vals, A_short.shape)
        designs = {"split": lambda M: cuda_ell.csr_spmv(M, x), "split_tree": split_tree}
        designs.update({f"subwarp G={g}": plain(libs["subwarp"], f"csr_spmv_subwarp{g}") for g in (4, 8)})
        if "parent" in libs:
            designs["parent"] = plain(libs["parent"], "csr_spmv")

        rows, outs = {}, {}
        for name in sorted(designs, key=lambda d: d != "parent"):  # the parent's output first
            run = designs[name]
            outs[name] = run(A).clone()
            again = run(A)
            torch.cuda.synchronize()
            err = float((outs[name] - want).abs().max()) / float(want.abs().max())
            rows[name] = {"max_rel_err": err, "equal_bits": bool(torch.equal(outs[name], again)),
                          "equal_bits_to_parent": bool(torch.equal(outs[name], outs["parent"]))
                          if "parent" in outs else None,
                          "device_us": [], "short_device_us": [], "back_to_back_us": []}
            if not (err <= REL_TOL and rows[name]["equal_bits"]):
                print(f"[b8_designs] {name}: max|k-w|/max|w| {err:.3e}, equal bits {rows[name]['equal_bits']}",
                      file=sys.stderr)
                return 1
        rows["torch.mv"] = {"max_rel_err": float((torch.mv(S_A, x) - want).abs().max()) / float(want.abs().max()),
                            "device_us": [], "short_device_us": [], "back_to_back_us": []}
        designs["torch.mv"] = lambda M: torch.mv(S_A if M is A else S_short, x)
        for _ in range(2):  # in turns
            for name, run in designs.items():
                r = rows[name]
                r["device_us"].append(device_us_per_call(lambda: run(A)))
                r["short_device_us"].append(device_us_per_call(lambda: run(A_short)))
                r["back_to_back_us"].append(back_to_back_us(lambda: run(A)))
    for name, r in rows.items():
        print(f"[b8_designs] {name}: device {' / '.join(f'{u:.2f}' for u in r['device_us'])} us, "
              f"long rows emptied {' / '.join(f'{u:.2f}' for u in r['short_device_us'])} us, back to back "
              f"{' / '.join(f'{u:.2f}' for u in r['back_to_back_us'])} us; max|k-w|/max|w| {r['max_rel_err']:.3e}"
              + ("" if r.get("equal_bits_to_parent") is None else f"; the parent's bits {r['equal_bits_to_parent']}"))
    print(gpu)
    print(json.dumps({"b8_designs": rows, "bound_us": bound_us, "n": n, "nnz": A.nnz, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
