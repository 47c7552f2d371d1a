"""Command-line interface: ``python -m fenicsx_beat_tpu_torch`` or
``beat-tpu-torch``.

Port of ``fenicsx_beat_tpu/cli.py`` (the reference's ``src/beat/cli.py``
with its stubs filled): argparse with ``version`` / ``run`` / ``ecg`` /
``post``.  ``run`` marches the Niederer slab through
:func:`~.benchmarks.niederer.run_niederer_benchmark`, or, with ``--mesh``, a
user's Gmsh mesh (:func:`~.io.read_msh`) through the fused solver, writing
voltage snapshots that ``ecg`` (pseudo-ECG traces, :class:`~.ecg.ECGRecovery`)
and ``post`` (activation times) read back.  One option the JAX package
lacks: ``--device`` on ``run`` and ``ecg``, the card unless ``cpu`` is
named (the JAX package's backend choice).  On the card, ``run`` and ``ecg``
print the launches of each kernel and ``ecg`` the seconds a frame.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["setup_logging", "setup_parser", "display_version_info", "dispatch", "main", "build_mesh_solver",
           "kernel_launches"]


def setup_logging(level: int = logging.INFO) -> None:
    """Rank-aware log format (the reference's MPI-rank formatter and rank-0
    filter, ``cli.py:8-48`` there): records of rank 0 only once
    ``torch.distributed`` is initialized."""

    class RankFilter(logging.Filter):
        def filter(self, record):
            import torch.distributed as dist

            return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0

    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    handler.addFilter(RankFilter())
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = [handler]
    logging.getLogger("matplotlib").setLevel(logging.WARNING)


def setup_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="beat-tpu-torch", description="Cardiac electrophysiology solver on PyTorch and CUDA"
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("version", help="Show version and device info")

    run = sub.add_parser("run", help="Run a monodomain simulation")
    run.add_argument("--dx", type=float, default=0.5, help="slab resolution (mm)")
    run.add_argument("--dt", type=float, default=0.05, help="time step (ms)")
    run.add_argument("-T", type=float, default=20.0, help="end time (ms)")
    run.add_argument("--model", default="tentusscher_panfilov_2006", help="ionic model")
    run.add_argument("--outdir", default="results-run", help="output directory")
    run.add_argument(
        "--mesh",
        default=None,
        help="Gmsh .msh file (ASCII v2.2/v4.1 or binary v4.1) to run on "
        "instead of the built-in Niederer slab",
    )
    run.add_argument(
        "--stim-marker",
        type=int,
        default=None,
        help="cell tag to stimulate on --mesh runs (default: smallest tag "
        "in the file; untagged meshes stimulate a corner ball)",
    )
    run.add_argument(
        "--g",
        type=float,
        default=None,
        help="isotropic conductivity [uA/mV] for --mesh runs (default: the "
        "Niederer harmonic-mean longitudinal value)",
    )
    run.add_argument("--stim-amplitude", type=float, default=50_000.0)
    run.add_argument("--save-freq", type=int, default=20, help="steps per snapshot")
    _device_option(run)

    ecg = sub.add_parser("ecg", help="Compute pseudo-ECG from saved voltage snapshots")
    ecg.add_argument("checkpoint", help="checkpoint file (.npz) with voltage snapshots")
    ecg.add_argument("--electrode", nargs="+", type=float, action="append", default=None)
    _device_option(ecg)

    post = sub.add_parser("post", help="Postprocess results (activation times)")
    post.add_argument("checkpoint", help="checkpoint file (.npz)")
    return parser


def _device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device: the card (cuda) unless cpu is named; float32 on the card, "
                        "float64 on the CPU")


def display_version_info() -> None:
    import torch

    import fenicsx_beat_tpu_torch

    print(f"fenicsx-beat-tpu: {fenicsx_beat_tpu_torch.__version__}")
    print(f"torch: {torch.__version__} (CUDA {torch.version.cuda})")
    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] \
        if torch.cuda.is_available() else []
    print(f"devices: {cards}")
    print(f"default device: {'cuda' if cards else 'none (name --device cpu)'}")


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launches in this process, where it launched
    (the wrappers count launches on the card, never twin calls)."""
    from .ops import cuda_cg, cuda_ell, cuda_ode, cuda_spmv, cuda_stencil

    out = {}
    for mod in (cuda_cg, cuda_ell, cuda_ode, cuda_spmv, cuda_stencil):
        for name in dir(mod):
            n = getattr(getattr(mod, name), "launches", None)
            if isinstance(n, int) and n > 0:
                out[name] = n
    return dict(sorted(out.items()))


def _print_launches(device) -> None:
    if device.type == "cuda":
        print(f"kernel launches: {json.dumps(kernel_launches())}")


def _cmd_run(args) -> int:
    import importlib

    model = importlib.import_module(f"fenicsx_beat_tpu_torch.models.{args.model}")
    if args.mesh is not None:
        return _run_mesh(args, model)
    from .benchmarks.niederer import run_niederer_benchmark
    from .config import resolve_device

    device = resolve_device(args.device)
    res = run_niederer_benchmark(dx=args.dx, dt=args.dt, T=args.T, model=model, device=device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    at_file = outdir / "activation_times.json"  # appended run by run, as the JAX package's
    existing = json.loads(at_file.read_text()) if at_file.is_file() else []
    existing.append(dict(res.activation_times, dx=args.dx, dt=args.dt))
    at_file.write_text(json.dumps(existing, indent=2))
    print(res.summary())
    _print_launches(device)
    return 0


def build_mesh_solver(mesh, cell_tags, model, stim_marker: int | None = None, g: float | None = None,
                      stim_amplitude: float = 50_000.0, device=None):
    """The fused solver of ``run --mesh`` on ``mesh`` and its cell tags:
    the stimulus (2 ms) on the tag ``stim_marker`` (the smallest tag when
    None), or on a ball at the bounding box's low corner of 10% of the
    diagonal in radius on an untagged mesh; an isotropic conductivity
    ``g`` (the Niederer harmonic-mean longitudinal value when None); the
    model's initial states with its own pacing off.  Raises SystemExit for
    a marker the mesh does not carry."""
    import numpy as np

    from . import fem
    from .conductivities import default_conductivities, get_harmonic_mean_conductivity
    from .fused import FusedMonodomainSolver
    from .mesh import locate_entities, meshtags
    from .stimulation import define_stimulus

    chi = default_conductivities("Niederer")["chi"]
    if cell_tags is not None:
        marker = stim_marker if stim_marker is not None else int(np.min(cell_tags.values))
        if marker not in cell_tags.values:
            raise SystemExit(
                f"--stim-marker {marker} not among the mesh's cell tags "
                f"{sorted(set(int(v) for v in cell_tags.values))}"
            )
        tags = cell_tags
    else:
        lo, hi = mesh.coords.min(axis=0), mesh.coords.max(axis=0)
        r = 0.1 * float(np.linalg.norm(hi - lo))
        cells = locate_entities(
            mesh, mesh.tdim, lambda x: sum((x[i] - lo[i]) ** 2 for i in range(mesh.gdim)) <= r * r
        )
        marker = 1
        tags = meshtags(mesh, mesh.tdim, cells, marker)
    I_s = define_stimulus(mesh=mesh, chi=chi, time=fem.Constant(0.0), subdomain_data=tags, marker=marker,
                          mesh_unit="mm", amplitude=stim_amplitude, duration=2.0)
    g = g if g is not None else get_harmonic_mean_conductivity(chi).s_l
    for key in ("stim_amplitude", "i_Stim_Amplitude"):
        try:
            parameters = model.init_parameter_values(**{key: 0.0})
            break
        except KeyError:
            continue
    else:
        parameters = model.init_parameter_values()
    v_name = "V" if "V" in model._STATE_NAMES else "v"
    return FusedMonodomainSolver(
        mesh=mesh,
        M=float(g),
        ode_fun=model.generalized_rush_larsen,
        init_states=model.init_state_values(),
        parameters=parameters,
        v_index=model.state_index(v_name),
        I_s=I_s,
        device=device,
    )


def _run_mesh(args, model) -> int:
    """Monodomain run on a user's Gmsh mesh (the JAX package's
    ``cli.py:116-210``): stimulate a tagged region (or a corner ball),
    march with the fused solver, write voltage snapshots the ``ecg`` and
    ``post`` subcommands read (``voltage.npz``), and each node's activation
    time (``activation_times.npy``, -1 where it did not fire)."""
    import numpy as np

    from . import io as io_mod

    tic = time.perf_counter()
    mesh, cell_tags, _facet_tags = io_mod.read_msh(args.mesh)
    read_s = time.perf_counter() - tic
    logger.info(
        "Loaded %s: %d cells, %d vertices (tdim=%d)",
        args.mesh, mesh.num_cells, mesh.num_vertices, mesh.tdim,
    )
    tic = time.perf_counter()
    solver = build_mesh_solver(mesh, cell_tags, model, stim_marker=args.stim_marker, g=args.g,
                               stim_amplitude=args.stim_amplitude, device=args.device)
    setup_s = time.perf_counter() - tic
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    tic = time.perf_counter()
    with io_mod.CheckpointWriter(outdir / "voltage", mesh) as writer:
        n = solver.V.ndofs
        solver.solve(
            (0.0, args.T),
            dt=args.dt,
            save_freq=args.save_freq,
            save_callback=lambda t, v: writer.write(t, v[:n]),
        )
    run_s = time.perf_counter() - tic
    act = solver.activation_times()[: mesh.num_vertices]
    np.save(outdir / "activation_times.npy", act)
    n_act = int((act >= 0).sum())
    print(f"nodes activated: {n_act}/{act.size}")
    if n_act:
        print(f"activation time range: [{act[act >= 0].min():.2f}, {act.max():.2f}] ms")
    print(f"snapshots: {outdir / 'voltage.npz'}")
    print(f"seconds: read {read_s:.3f}, setup {setup_s:.3f}, run {run_s:.3f} (with the snapshots) on "
          f"{solver.device.type}")
    _print_launches(solver.device)
    return 0


def _cmd_ecg(args) -> int:
    import numpy as np

    from . import fem
    from . import io as io_mod
    from .ecg import ECGRecovery
    from .mesh import CellType, Mesh

    data = io_mod.load_checkpoint(args.checkpoint)
    print(f"Loaded checkpoint with {len(data.times)} snapshots, {data.values.shape[1]} dofs")
    mesh = Mesh(
        coords=np.asarray(data.coords, dtype=np.float64),
        cells=np.asarray(data.cells, dtype=np.int32),
        cell_type=CellType[str(data.cell_type)],
    )
    if args.electrode:
        electrodes = [tuple(p) for p in args.electrode]
    else:
        # default: one electrode one domain-length beyond the max corner
        lo, hi = mesh.coords.min(axis=0), mesh.coords.max(axis=0)
        electrodes = [tuple(hi + (hi - lo))]
    tic = time.perf_counter()
    V = fem.functionspace(mesh, ("P", 1))
    v = fem.Function(V)
    ecg = ECGRecovery(v=v, device=args.device)
    # the electrode forms' quadrature as one device-resident weight matrix
    # (ECGRecovery.eval's rule): a product a frame
    ecg.register_electrodes([np.asarray(p, dtype=np.float64) for p in electrodes])
    setup_s = time.perf_counter() - tic
    traces = np.zeros((len(data.times), len(electrodes)))
    tic = time.perf_counter()
    for i in range(len(data.times)):
        v.x.array[:] = data.values[i]
        ecg.solve_device()
        traces[i] = ecg.electrode_potentials()
    frames_s = time.perf_counter() - tic
    out = str(args.checkpoint).replace(".npz", "") + "_ecg.npz"
    np.savez(out, times=data.times, traces=traces, electrodes=np.asarray(electrodes))
    for j, p in enumerate(electrodes):
        print(f"electrode {p}: phi_e range [{traces[:, j].min():.4e}, {traces[:, j].max():.4e}]")
    print(f"Saved traces to {out}")
    per_frame = frames_s / max(len(data.times), 1)
    print(f"ecg: kernel {ecg.kernel} on {ecg.device.type}, setup {setup_s:.3f} s, {per_frame:.4f} s per frame")
    _print_launches(ecg.device)
    return 0


def _cmd_post(args) -> int:
    import numpy as np

    from . import io as io_mod

    data = io_mod.load_checkpoint(args.checkpoint)
    v = data.values
    act = np.full(v.shape[1], -1.0)
    for i, t in enumerate(data.times):
        newly = (v[i] > 0.0) & (act < 0)
        act[newly] = t
    print(f"activated nodes: {(act >= 0).sum()}/{act.size}")
    if (act >= 0).any():
        print(f"activation time range: [{act[act >= 0].min():.2f}, {act.max():.2f}] ms")
    return 0


def dispatch(args: argparse.Namespace) -> int:
    setup_logging(logging.DEBUG if args.verbose else logging.INFO)
    if args.command == "version":
        display_version_info()
        return 0
    if args.command == "run":
        return _cmd_run(args)
    if args.command == "ecg":
        return _cmd_ecg(args)
    if args.command == "post":
        return _cmd_post(args)
    setup_parser().print_help()
    return 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = setup_parser()
    args = parser.parse_args(argv)
    return dispatch(args)


if __name__ == "__main__":
    raise SystemExit(main())
