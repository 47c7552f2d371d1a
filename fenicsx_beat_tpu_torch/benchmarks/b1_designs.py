"""Registers, SASS census and device time of one hand-written ionic model's
kernels (B1, its per-node form, B7) in the designs that were measured for
them, at the shapes of their paths:

- ``tp06`` (the default): B1 and its per-node form at the main path's
  n = 442,401 (the form on a field of mixed celltypes), B7 at the psize 0.1
  LV's n = 243,518 (three layers, every 97th node in none);
- ``torord_dyncl``: all three at the LV's n = 243,518, as ``chip_smoke.py``
  runs them;
- ``torord_dyncl_land``: B1's forms at n = 442,401, B7 at the LV's;
- both ToR-ORd models: B7's block-list form as Path M launches Land's: 870
  of the n = 442,401 slab's 1,729 blocks (the nodes from block 859's middle
  on; the others another model's).

Designs, each built from ``csrc/`` with the library's flags but for what it
names:

- ``B x M``: B threads a block for B1 and the per-node form and at least M
  blocks an SM, which caps the registers a thread
  (``-D<MODEL>_BLOCK=B -D<MODEL>_MIN_BLOCKS=M``, ``TP06`` or ``TORORD``);
  the library's own shape is the one whose macros' defaults it names;
- ``b7-256xM`` (ToR-ORd's models): B7 over every block at its 256-node
  blocks and at least M blocks an SM (``-DTORORD_MULTI_MIN_BLOCKS=M``, or
  ``TORORD_LAND_MULTI_MIN_BLOCKS``), the library's own M left to the
  library shape;
- ``ieee-div``: the library's shape with the IEEE division (without
  ``-prec-div=false``): the body as reordered into phases, whose output
  is bit for bit that of the same formulas computed in one pass;
- the designs of ToR-ORd's models not kept, in ``b1_designs/`` (the
  library's B1, its per-node form and B7's block-list form are staged:
  ``csrc/staged.cuh``, persistent blocks that load the next tile's states
  into shared memory with ``cp.async`` while they step the current one):
  ``unstaged``, every form one node a thread (``b1_designs/unstaged.cu``);
  ``staged-all``, B7 over every block staged too
  (``b1_designs/staged_all.cu``); ``smem-table``, B7 one node a thread in
  both forms with its ``[nm, NP]`` parameter table copied into shared
  memory once a block (``b1_designs/smem_table.cu``); the last two beside
  the library's B1 and per-node form;
- ``use_fast_math``: a yardstick, never kept: ``--use_fast_math``
  (denormals flushed, approximate division, square roots, exponentials
  and logarithms, contraction into fused multiply-adds);
- ``parent``: with ``--parent DIR``, ``DIR``'s own sources (another
  checkout's ``csrc/``), built with ``-fmad=false`` and the IEEE division.

Each design is built by ``nvcc`` into a library of its own (one process
each, all started together; ``-Xptxas -v``'s registers and spills), and
its SASS is counted from ``cuobjdump -sass``: instructions, and of them
FCHK and CALL (the IEEE division's range check and slow-path call),
BSSY/BSYNC (convergence barriers) and MUFU (the special-function unit).
From one set of states (``kernel_check.check_states``, V and the PDE
voltage uniform on [-90, 40] mV) every form of every design takes one
step; the outputs are compared bit for bit with the parent's (when given:
``ieee-div`` must give its bits in every form) and the library's.  B1 is
held against its plain PyTorch twin by ``kernel_check``'s one-step limit
for each celltype, state set (each slow row scaled) and dt; the library,
``ieee-div`` and ``use_fast_math`` also by its one-beat limit for each
celltype over a paced beat of 4,096 cells; each state row's errors are
kept, and the library's are printed beside ``ieee-div``'s: the approximate
division's cost in accuracy, row by row.  Then each form is timed under
``torch.profiler`` (:func:`~.profile_main.device_us_per_call`) twice, in
turns over the designs.  Prints one line per design, the card's name and
power limit, and a JSON object last.  Needs one card::

    python -m fenicsx_beat_tpu_torch.benchmarks.b1_designs [--model MODEL] [--parent DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace

import numpy as np
import torch

from .._build import _BUILD_DIR, _CSRC, _SIGNATURES, _bind, _nvcc, _nvcc_flags, ptxas_resources
from ..models import tentusscher_panfilov_2006 as tp06
from ..models import torord_dyncl as torord
from ..models import torord_dyncl_land as land
from ..ops import cuda_ode
from . import kernel_check as kc
from .profile_main import device_us_per_call

N_LV, N_SLAB = 243_518, 442_401
BEAT_CELLS = 4_096
# Path M's launch of Land's B7 (benchmarks/mixed.py at dx=0.1): the slab's
# nodes from this one on, 870 of its 1,729 blocks
MIXED_FIRST_NODE = 859 * cuda_ode.BLOCK_NODES + 128
_DESIGNS = Path(__file__).with_name("b1_designs")  # the designs not kept


@dataclass(frozen=True)
class Model:
    """What the script measures of one model."""

    module: ModuleType
    prefix: str  # of its sources and entry points: <prefix>.cu, <prefix>_node.cu, <prefix>_multi.cu
    macro: str  # the prefix of B1's launch-shape macros: <macro>_BLOCK, <macro>_MIN_BLOCKS
    b7_macro: str | None  # B7's blocks an SM over every block, if built apart
    n_b1: int  # nodes of B1's forms
    shapes: tuple  # (threads a block, blocks an SM) of B1 and its per-node form
    b7_blocks: tuple  # blocks an SM of B7's shapes (256 threads)
    stim_off: dict  # the parameter that turns the model's pacing off
    torord: bool  # build the designs of b1_designs/, time B7's block-list form

    @property
    def sources(self) -> tuple:
        return tuple(f"{self.prefix}{s}.cu" for s in ("", "_node", "_multi"))

    @property
    def forms(self) -> tuple:
        return tuple(f"{self.prefix}{s}_step_v" for s in ("", "_node", "_multi"))


_TORORD_SHAPES = ((256, 1), (256, 2), (128, 4), (128, 5), (128, 6))
MODELS = {
    "tp06": Model(tp06, "tp06_grl", "TP06", None, N_SLAB,
                  ((256, 1), (256, 3), (256, 4), (128, 6), (128, 8)), (), {"stim_amplitude": 0.0}, False),
    "torord_dyncl": Model(torord, "torord_grl", "TORORD", "TORORD_MULTI_MIN_BLOCKS", N_LV, _TORORD_SHAPES,
                          (2, 3, 4), {"i_Stim_Amplitude": 0.0}, True),
    "torord_dyncl_land": Model(land, "torord_land_grl", "TORORD", "TORORD_LAND_MULTI_MIN_BLOCKS", N_SLAB,
                               _TORORD_SHAPES, (2, 3, 4), {"i_Stim_Amplitude": 0.0}, True),
}
SASS_OPS = ("FCHK", "CALL", "BSSY", "BSYNC", "MUFU")


def default_macro(name: str) -> int:
    """The default of the launch-shape macro ``name`` (``csrc/*.cuh``)."""
    for header in sorted(_CSRC.glob("*.cuh")):
        if m := re.search(rf"#define {name} (\d+)", header.read_text()):
            return int(m.group(1))
    raise RuntimeError(f"no header defines {name}")


def library_name(model: Model) -> str:
    return f"{default_macro(f'{model.macro}_BLOCK')}x{default_macro(f'{model.macro}_MIN_BLOCKS')}"


def designs(model: Model, parent: Path | None) -> dict:
    """``{design: (include directory, nvcc flags, sources)}``."""
    lib = _nvcc_flags(Path(model.sources[0]))
    ieee = [f for f in lib if f != "-prec-div=false"]
    kept = tuple(_CSRC / s for s in model.sources)
    jobs = {}
    if parent is not None:
        jobs["parent"] = (parent, ieee, tuple(parent / s for s in model.sources))
    shapes = list(model.shapes)
    block0 = default_macro(f"{model.macro}_BLOCK")
    min0 = default_macro(f"{model.macro}_MIN_BLOCKS")
    if (block0, min0) not in shapes:
        shapes.append((block0, min0))
    for block, blocks in shapes:
        jobs[f"{block}x{blocks}"] = (_CSRC, [*lib, f"-D{model.macro}_BLOCK={block}",
                                             f"-D{model.macro}_MIN_BLOCKS={blocks}"], kept)
    if model.b7_macro:
        m7 = default_macro(model.b7_macro)
        for blocks in model.b7_blocks:
            if blocks != m7:  # the library's own B7 shape is the library design's
                jobs[f"b7-256x{blocks}"] = (_CSRC, [*lib, f"-D{model.b7_macro}={blocks}"], kept)
    jobs["ieee-div"] = (_CSRC, ieee, kept)
    if model.torord:
        jobs["unstaged"] = (_CSRC, lib, (_DESIGNS / "unstaged.cu",))
        jobs["staged-all"] = (_CSRC, lib, (*kept[:2], _DESIGNS / "staged_all.cu"))
        jobs["smem-table"] = (_CSRC, lib, (*kept[:2], _DESIGNS / "smem_table.cu"))
    jobs["use_fast_math"] = (_CSRC, [*(f for f in ieee if f != "-fmad=false"), "--use_fast_math"], kept)
    return jobs


def sass_census(lib: Path) -> dict:
    """``{mangled kernel name: {"instructions": n, op: n for op in SASS_OPS}}``
    from ``cuobjdump -sass`` of the library ``lib``."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            out[name] = {"instructions": 0, **{op: 0 for op in SASS_OPS}}
        elif name is not None and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)):
            counts = out[name]
            counts["instructions"] += 1
            op = m.group(1).split(".")[0]
            if op in counts:
                counts[op] += 1
    return out


def build_all(model: Model, workdir: Path, parent: Path | None) -> dict:
    """``{design: (ctypes library, {kernel: (registers, spill stores, spill
    loads)}, {kernel: SASS census})}``, compiled at once, one nvcc each."""
    procs = {}
    for name, (include, flags, sources) in designs(model, parent).items():
        out = workdir / f"lib{name}.so"
        cmd = [_nvcc(), *flags, f"-I{include}", "-shared", "-o", str(out), *map(str, sources)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = (_bind(out, {f: _SIGNATURES[f] for f in model.forms}), ptxas_resources(log), sass_census(out))
    return libs


def by_form(model: Model, per_kernel: dict) -> dict:
    """``{form: value}`` from ``{mangled kernel name: value}`` (B7 in its
    form over every block and its block-list form)."""
    out = {}
    for mangled, r in per_kernel.items():
        for form in model.forms:
            if f"{form}_kernel" in mangled:
                out[form + ("[blocks]" if "ILb1E" in mangled else "")] = r
    return out


def by_row(model: Model, err: torch.Tensor) -> dict:
    """``{state name: error}`` of every state row."""
    return {nm: float(x) for nm, x in zip(model.module._STATE_NAMES, err)}


def worst(model: Model, err: torch.Tensor) -> dict:
    """The state rows whose error is over 1e-3, by name."""
    return {nm: x for nm, x in by_row(model, err).items() if x > 1e-3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="tp06")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="the csrc/ directory of another checkout, whose kernels of the model are built beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_designs needs a CUDA card", file=sys.stderr)
        return 1
    model = MODELS[args.model]
    mod, forms = model.module, model.forms
    spec = cuda_ode.IONIC_MODELS[mod.generalized_rush_larsen]
    n_states = len(mod._STATE_NAMES)
    library = library_name(model)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def on_card(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype).contiguous()

    n1 = model.n_b1
    S1 = on_card(kc.check_states(args.model, n1, rng))
    v1 = on_card(rng.uniform(-90.0, 40.0, n1))
    params = mod.init_parameter_values(**model.stim_off)
    table_np = np.stack([mod.init_parameter_values(**model.stim_off, celltype=ct) for ct in kc.CELLTYPES])
    field = on_card(table_np[rng.integers(0, 3, n1)].T)
    S7, v7 = S1[:, :N_LV].contiguous(), v1[:N_LV].contiguous()
    index = (torch.arange(N_LV, device=dev) * 3 // N_LV).to(torch.int32)
    index[::97] = -1
    table = on_card(table_np)
    init = mod.init_state_values()
    beat0 = on_card(np.tile(init[:, None], (1, BEAT_CELLS)) * (1 + 0.01 * rng.standard_normal((n_states, BEAT_CELLS))))
    if model.torord:  # Path M's launch: endo nodes from MIXED_FIRST_NODE on, the rest another model's
        Sm, vm = (S1, v1) if n1 == N_SLAB else (on_card(kc.check_states(args.model, N_SLAB, rng)),
                                                  on_card(rng.uniform(-90.0, 40.0, N_SLAB)))
        index_m = torch.full((N_SLAB,), cuda_ode.OTHER_MODEL, dtype=torch.int32, device=dev)
        index_m[MIXED_FIRST_NODE:] = 0
        table_m = table[:1].contiguous()
        blocks_m = torch.arange(MIXED_FIRST_NODE // cuda_ode.BLOCK_NODES, -(-N_SLAB // cuda_ode.BLOCK_NODES),
                                dtype=torch.int32, device=dev)

    work = _BUILD_DIR.parent / "b1_designs"  # beside the kernel library's builds
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as td:
        libs = build_all(model, Path(td), args.parent)
    timed = (*forms, f"{forms[2]}[blocks]") if model.torord else forms
    rows = {}
    for name, (lib, res, sass) in libs.items():
        handle = SimpleNamespace(lib=lib)
        b1 = cuda_ode._b1(forms[0], mod, spec.step_twin, library=lambda handle=handle: handle)
        node = cuda_ode._b1_node(forms[1], mod, spec.step_twin, library=lambda handle=handle: handle)
        b7 = cuda_ode._b7(forms[2], mod, spec.multi_step_twin, library=lambda handle=handle: handle)
        calls = {
            forms[0]: (S1, lambda S, b1=b1: b1(S, v1, 1.0, 0.025, params)),
            forms[1]: (S1, lambda S, node=node: node(S, v1, 1.0, 0.025, field)),
            forms[2]: (S7, lambda S, b7=b7: b7(S, v7, index, 1.0, 0.025, table)),
        }
        if model.torord:
            calls[timed[3]] = (Sm, lambda S, b7=b7: b7(S, vm, index_m, 1.0, 0.025, table_m, blocks=blocks_m))
        outs = {form: fn(S0.clone()) for form, (S0, fn) in calls.items()}
        step_err = torch.zeros(n_states, dtype=torch.float64, device=dev)
        step_err_ct = {}
        for ct, p in zip(kc.CELLTYPES, table_np):
            ct_err = torch.zeros(n_states, dtype=torch.float64, device=dev)
            for _, S in kc.step_check_states(S1, args.model):
                for dt in (0.025, 0.05):
                    ct_err = torch.maximum(ct_err, kc.ionic_step_errors(b1, spec.step_twin, S, v1, 1.0, dt, p)[1])
            step_err_ct[f"{ct:g}"] = float(ct_err.max())
            step_err = torch.maximum(step_err, ct_err)
        beat_err = None
        if name in (library, "ieee-div", "use_fast_math"):  # the other shapes give the library's bits
            beat_err = torch.zeros(n_states, dtype=torch.float64, device=dev)
            for ct in kc.CELLTYPES:
                beat_err = torch.maximum(beat_err, kc.ionic_beat_errors(
                    b1, spec.step_twin, beat0, mod.init_parameter_values(celltype=ct))[1])
        torch.cuda.synchronize()
        rows[name] = {
            "resources": by_form(model, res),
            "sass": by_form(model, sass),
            "outs": outs,
            "b1_step_err": float(step_err.max()),
            "b1_step_err_by_celltype": step_err_ct,
            "b1_step_err_rows_over_1e-3": worst(model, step_err),
            "b1_step_err_by_row": by_row(model, step_err),
            "b1_beat_err": None if beat_err is None else float(beat_err.max()),
            "b1_beat_err_rows_over_1e-3": None if beat_err is None else worst(model, beat_err),
            "b1_beat_err_by_row": None if beat_err is None else by_row(model, beat_err),
            "device_us": {f: [] for f in timed},
            "calls": calls,
        }
    failed = [name for name, r in rows.items() if name != "use_fast_math"
              and not (r["b1_step_err"] <= kc.IONIC_STEP_TOL and (r["b1_beat_err"] or 0.0) <= kc.IONIC_BEAT_TOL)]
    for r in rows.values():
        r["equal_bits"] = {ref: {f: bool(torch.equal(r["outs"][f], rows[ref]["outs"][f])) for f in timed}
                           for ref in ("parent", library) if ref in rows}
    if "parent" in rows and not all(rows["ieee-div"]["equal_bits"]["parent"].values()):
        failed.append("ieee-div (not the parent's bits)")
    for r in rows.values():
        del r["outs"]
    for _ in range(2):  # in turns
        for r in rows.values():
            for form, (S0, fn) in r["calls"].items():
                scratch = S0.clone()
                r["device_us"][form].append(device_us_per_call(lambda fn=fn, scratch=scratch: fn(scratch)))
    for name, r in rows.items():
        del r["calls"]
        print(f"[b1_designs] {args.model} {name}{' (the library)' if name == library else ''}: "
              + "; ".join(f"{f} {' / '.join(f'{u:.2f}' for u in r['device_us'][f])} us" for f in timed)
              + " (device); registers, spill stores, spill loads: "
              + ", ".join(f"{k} {v}" for k, v in r["resources"].items())
              + "; SASS " + ", ".join(f"{k} " + " ".join(f"{op} {c}" for op, c in v.items())
                                      for k, v in r["sass"].items())
              + f"; bits equal to: {r['equal_bits']}; B1 one-step error "
              f"{r['b1_step_err']:.3e} (by celltype {r['b1_step_err_by_celltype']}; rows over 1e-3: "
              f"{r['b1_step_err_rows_over_1e-3']})"
              + ("" if r["b1_beat_err"] is None else f", one-beat error {r['b1_beat_err']:.3e} (rows over 1e-3: "
                 f"{r['b1_beat_err_rows_over_1e-3']})"))
    approx, ieee = rows[library], rows["ieee-div"]
    print(f"[b1_designs] {args.model} B1 error by state row, one step / one beat, {library} (approximate division) "
          "against ieee-div: " + ", ".join(
              f"{nm} {approx['b1_step_err_by_row'][nm]:.3e} / {approx['b1_beat_err_by_row'][nm]:.3e} against "
              f"{ieee['b1_step_err_by_row'][nm]:.3e} / {ieee['b1_beat_err_by_row'][nm]:.3e}"
              for nm in mod._STATE_NAMES))
    print(gpu)
    print(json.dumps({"b1_designs": rows, "model": args.model, "library": library, "gpu": gpu}))
    if failed:
        print(f"[b1_designs] failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
