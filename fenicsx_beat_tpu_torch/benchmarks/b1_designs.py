"""Registers and device time of TP06's ionic kernels in the designs that
were measured for them: B1 at the main path's n = 442,401, its per-node
form at the same n (a field of mixed celltypes), B7 at the psize 0.1 LV's
n = 243,518 (three layers, every 97th node in none).

- ``B x M``: ``csrc/tp06_grl{,_node,_multi}.cu`` built with the library's
  flags and ``-DTP06_BLOCK=B -DTP06_MIN_BLOCKS=M`` (B threads a block for
  B1 and the per-node form, B7 keeping 256; at least M blocks an SM, which
  caps the registers a thread; the library is built at 128 x 6);
- ``ieee-div``: the same sources at 128 x 6 with the IEEE division
  (without ``-prec-div=false``): the two-phase body alone, whose output is
  bit for bit that of the same formulas computed in one phase;
- ``use_fast_math``: at 128 x 6 with ``--use_fast_math`` (denormals
  flushed, approximate division, square roots, exponentials and
  logarithms, contraction into fused multiply-adds);
- ``parent``: with ``--parent DIR``, ``DIR``'s own three sources (another
  checkout's ``csrc/``), built with ``-fmad=false`` and the IEEE division.

Each design is built by ``nvcc`` into a library of its own (one process
each, all started together; ``-Xptxas -v``'s registers and spills
printed).  From one set of states (each state 1 + 5% noise around its
initial value, V and the PDE voltage uniform on [-90, 40] mV) every form
of every design takes one step; the outputs are compared bit for bit with
the parent's (when given) and the library shape's.  B1 is held against its
plain PyTorch twin by ``kernel_check``'s one-step limit for each celltype,
state set and dt; the library shape, ``ieee-div`` and ``use_fast_math``
also by its one-beat limit for each celltype over a paced beat of 4,096
cells; each state row's errors are kept, and the library shape's are
printed beside ``ieee-div``'s: the approximate division's cost in
accuracy, row by row.  Then each form is timed under ``torch.profiler``
(:func:`~.profile_main.device_us_per_call`) twice, in turns over the
designs.  Prints one line per design, the card's name and power limit, and
a JSON object last.  Needs one card::

    python -m fenicsx_beat_tpu_torch.benchmarks.b1_designs [--parent DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .._build import _BUILD_DIR, _CSRC, _SIGNATURES, _bind, _nvcc, _nvcc_flags, ptxas_resources
from ..models import tentusscher_panfilov_2006 as tp06
from ..ops import cuda_ode
from . import kernel_check as kc
from .profile_main import device_us_per_call

N_B1, N_B7 = 442_401, 243_518
SOURCES = ("tp06_grl.cu", "tp06_grl_node.cu", "tp06_grl_multi.cu")
FORMS = ("tp06_grl_step_v", "tp06_grl_node_step_v", "tp06_grl_multi_step_v")
SHAPES = ((256, 1), (256, 3), (256, 4), (128, 6), (128, 8))  # (threads a block, blocks an SM)
LIBRARY = "128x6"
BEAT_CHECKED = (LIBRARY, "ieee-div", "use_fast_math")
BEAT_CELLS = 4_096


def build_all(workdir: Path, parent: Path | None) -> dict:
    """``{design: (ctypes library, {kernel: (registers, spill stores, spill
    loads)})}``, compiled at once, one nvcc each."""
    lib = _nvcc_flags(Path(SOURCES[0]))
    ieee = [f for f in lib if f != "-prec-div=false"]
    jobs = {}
    if parent is not None:
        jobs["parent"] = (parent, ieee)
    for block, blocks in SHAPES:
        jobs[f"{block}x{blocks}"] = (_CSRC, [*lib, f"-DTP06_BLOCK={block}", f"-DTP06_MIN_BLOCKS={blocks}"])
    jobs["ieee-div"] = (_CSRC, ieee)
    jobs["use_fast_math"] = (_CSRC, [*(f for f in ieee if f != "-fmad=false"), "--use_fast_math"])
    procs = {}
    for name, (src, flags) in jobs.items():
        out = workdir / f"lib{name}.so"
        cmd = [_nvcc(), *flags, f"-I{src}", "-shared", "-o", str(out), *(str(src / s) for s in SOURCES)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = (_bind(out, {f: _SIGNATURES[f] for f in FORMS}), ptxas_resources(log))
    return libs


def resources_by_form(res: dict) -> dict:
    """``{form: (registers, spill stores, spill loads)}`` (B7 in its form
    over every block and its block-list form)."""
    out = {}
    for mangled, r in res.items():
        for form in FORMS:
            if f"{form}_kernel" in mangled:
                key = form + ("[blocks]" if "ILb1E" in mangled else "")
                out[key] = r
    return out


def by_row(err: torch.Tensor) -> dict:
    """``{state name: error}`` of every state row."""
    return {nm: float(x) for nm, x in zip(tp06._STATE_NAMES, err)}


def worst(err: torch.Tensor) -> dict:
    """The state rows whose error is over 1e-3, by name."""
    return {nm: x for nm, x in by_row(err).items() if x > 1e-3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="the csrc/ directory of another checkout, whose TP06 kernels are built beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_designs needs a CUDA card", file=sys.stderr)
        return 1
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def on_card(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype).contiguous()

    init = tp06.init_state_values()
    S1 = on_card(np.tile(init[:, None], (1, N_B1)) * (1 + 0.05 * rng.standard_normal((19, N_B1))))
    S1[0] = on_card(rng.uniform(-90.0, 40.0, N_B1))
    v1 = on_card(rng.uniform(-90.0, 40.0, N_B1))
    params = tp06.init_parameter_values(stim_amplitude=0.0)
    table_np = np.stack([tp06.init_parameter_values(stim_amplitude=0.0, celltype=ct) for ct in kc.CELLTYPES])
    field = on_card(table_np[rng.integers(0, 3, N_B1)].T)
    S7, v7 = S1[:, :N_B7].contiguous(), v1[:N_B7].contiguous()
    model = (torch.arange(N_B7, device=dev) * 3 // N_B7).to(torch.int32)
    model[::97] = -1
    table = on_card(table_np)
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS)) * (1 + 0.01 * rng.standard_normal((19, BEAT_CELLS))))

    work = _BUILD_DIR.parent / "b1_designs"  # beside the kernel library's builds
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as td:
        libs = build_all(Path(td), args.parent)
    rows = {}
    for name, (lib, res) in libs.items():
        library = SimpleNamespace(lib=lib)
        b1 = cuda_ode._b1(FORMS[0], tp06, cuda_ode.tp06_grl_step_v_twin, library=lambda library=library: library)
        node = cuda_ode._b1_node(FORMS[1], tp06, cuda_ode.tp06_grl_step_v_twin,
                                 library=lambda library=library: library)
        b7 = cuda_ode._b7(FORMS[2], tp06, cuda_ode.tp06_grl_multi_step_v_twin,
                          library=lambda library=library: library)
        calls = {
            FORMS[0]: (S1, lambda S, b1=b1: b1(S, v1, 1.0, 0.025, params)),
            FORMS[1]: (S1, lambda S, node=node: node(S, v1, 1.0, 0.025, field)),
            FORMS[2]: (S7, lambda S, b7=b7: b7(S, v7, model, 1.0, 0.025, table)),
        }
        outs = {form: fn(S0.clone()) for form, (S0, fn) in calls.items()}
        step_err = torch.zeros(19, dtype=torch.float64, device=dev)
        for ct, p in zip(kc.CELLTYPES, table_np):
            for _, S in kc.step_check_states(S1):
                for dt in (0.025, 0.05):
                    _, e = kc.ionic_step_errors(b1, cuda_ode.tp06_grl_step_v_twin, S, v1, 1.0, dt, p)
                    step_err = torch.maximum(step_err, e)
        beat_err = None
        if name in BEAT_CHECKED:  # the other shapes give the library shape's bits
            beat_err = torch.zeros(19, dtype=torch.float64, device=dev)
            for ct in kc.CELLTYPES:
                beat_err = torch.maximum(beat_err, kc.ionic_beat_errors(
                    b1, cuda_ode.tp06_grl_step_v_twin, beat0, tp06.init_parameter_values(celltype=ct))[1])
        torch.cuda.synchronize()
        rows[name] = {
            "resources": resources_by_form(res),
            "outs": outs,
            "b1_step_err": float(step_err.max()),
            "b1_step_err_rows_over_1e-3": worst(step_err),
            "b1_step_err_by_row": by_row(step_err),
            "b1_beat_err": None if beat_err is None else float(beat_err.max()),
            "b1_beat_err_rows_over_1e-3": None if beat_err is None else worst(beat_err),
            "b1_beat_err_by_row": None if beat_err is None else by_row(beat_err),
            "device_us": {f: [] for f in FORMS},
            "calls": calls,
        }
    failed = [name for name, r in rows.items()
              if not (r["b1_step_err"] <= kc.IONIC_STEP_TOL and (r["b1_beat_err"] or 0.0) <= kc.IONIC_BEAT_TOL)]
    for r in rows.values():
        r["equal_bits"] = {ref: {f: bool(torch.equal(r["outs"][f], rows[ref]["outs"][f])) for f in FORMS}
                           for ref in ("parent", LIBRARY) if ref in rows}
    for r in rows.values():
        del r["outs"]
    for _ in range(2):  # in turns
        for r in rows.values():
            for form, (S0, fn) in r["calls"].items():
                scratch = S0.clone()
                r["device_us"][form].append(device_us_per_call(lambda fn=fn, scratch=scratch: fn(scratch)))
    for name, r in rows.items():
        del r["calls"]
        print(f"[b1_designs] {name}: "
              + "; ".join(f"{f} {' / '.join(f'{u:.2f}' for u in r['device_us'][f])} us" for f in FORMS)
              + " (device); registers, spill stores, spill loads: "
              + ", ".join(f"{k} {v}" for k, v in r["resources"].items())
              + f"; bits equal to: {r['equal_bits']}; B1 one-step error "
              f"{r['b1_step_err']:.3e} (rows over 1e-3: {r['b1_step_err_rows_over_1e-3']})"
              + ("" if r["b1_beat_err"] is None else f", one-beat error {r['b1_beat_err']:.3e} (rows over 1e-3: "
                 f"{r['b1_beat_err_rows_over_1e-3']})"))
    approx, ieee = rows[LIBRARY], rows["ieee-div"]
    print(f"[b1_designs] B1 error by state row, one step / one beat, {LIBRARY} (approximate division) against "
          "ieee-div: " + ", ".join(
              f"{nm} {approx['b1_step_err_by_row'][nm]:.3e} / {approx['b1_beat_err_by_row'][nm]:.3e} against "
              f"{ieee['b1_step_err_by_row'][nm]:.3e} / {ieee['b1_beat_err_by_row'][nm]:.3e}"
              for nm in tp06._STATE_NAMES))
    print(gpu)
    print(json.dumps({"b1_designs": rows, "gpu": gpu}))
    if failed:
        print(f"[b1_designs] beyond the one-step or one-beat limit: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
