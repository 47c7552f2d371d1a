"""Process-group entry points of the sharded solvers.

Port of ``fenicsx_beat_tpu/parallel/distributed.py``.  The JAX package
runs one controller over a ``jax.sharding.Mesh``; the port runs SPMD, one
process per rank and one device per process, over ``torch.distributed``:
NCCL between cards, gloo on the CPU.  The reference's distribution entry
is the MPI communicator behind ``mpirun -n N``; here it is ``torchrun
--nproc-per-node N`` (its environment read by :func:`initialize_distributed`),
explicit arguments, or :func:`spawn_ranks`, which starts the ranks of one
host itself with a time limit on each spawn.

A run with no process group is one rank: :func:`make_device_mesh` then
gives a world of one, whose collectives are the identity.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..config import resolve_device

__all__ = ["DeviceMesh", "initialize_distributed", "make_device_mesh", "is_coordinator", "spawn_ranks"]

logger = logging.getLogger(__name__)


def _check_backend(backend: str) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and not (torch.cuda.is_available() and dist.is_nccl_available()):
        raise RuntimeError("backend 'nccl' requested but no CUDA device with NCCL is available "
                           "(pass backend='gloo' to run on the CPU)")


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank % max(count, 1)


def initialize_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           timeout_s: float = 600.0) -> None:
    """Join the process group (idempotent).

    With explicit ``coordinator_address`` (``tcp://host:port``),
    ``num_processes`` and ``process_id``, joins that group; with none of
    them, reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``); with neither, stays a single process, as the
    reference's scripts run with and without ``mpirun``.  ``backend``:
    ``"nccl"`` or ``"gloo"``; None picks NCCL when CUDA is available and
    gloo otherwise.  NCCL asked for without a card, or failing to start,
    raises: nothing falls back to gloo.  On CUDA each process takes the
    card of its local rank."""
    if dist.is_initialized():
        logger.debug("torch.distributed already initialized")
        return
    explicit = [a is not None for a in (coordinator_address, num_processes, process_id)]
    if any(explicit) and not all(explicit):
        raise ValueError("coordinator_address, num_processes and process_id go together")
    if all(explicit):
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=addr, world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        kwargs = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        logger.info("no cluster environment: single process")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    _check_backend(backend)
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank))
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s), **kwargs)
    logger.info("torch.distributed: rank %d/%d on %s", dist.get_rank(), dist.get_world_size(), backend)


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh of ranks, the port's ``jax.sharding.Mesh``: this
    process's ``rank`` in ``world_size``, its ``device``, the group's
    ``backend`` (None with no process group) and the partition ``axis``."""

    rank: int
    world_size: int
    device: torch.device
    backend: str | None
    axis: str = "x"

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)


def make_device_mesh(n_devices: int | None = None, axis: str = "x", device=None) -> DeviceMesh:
    """The 1-D mesh over every rank of the process group (one rank with
    none).  ``n_devices`` None means every rank; more than the world size
    raises ``ValueError``, and so does fewer (the SPMD solvers span the
    whole group).  ``device``: the card of this rank's local rank unless
    the CPU is named (``"cuda"`` also means that card)."""
    if dist.is_initialized():
        rank, world, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} ranks in the process group")
    if n != world:
        raise ValueError(f"the mesh spans every rank: requested {n} of {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group moves CUDA tensors: pass a CUDA device")
    return DeviceMesh(rank=rank, world_size=world, device=dev, backend=backend, axis=axis)


def is_coordinator() -> bool:
    """True on rank 0: the reference's ``comm.rank == 0`` IO gate."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# ranks of one host


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, args, timeout, queue):
    try:
        torch.set_num_threads(1)
        initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend=backend, timeout_s=timeout)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except Exception:  # every failure goes back to the parent, which raises it
        queue.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn: Callable[..., Any], world_size: int, *, backend: str, args: tuple = (),
                timeout: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one ``backend`` group (``"nccl"`` or ``"gloo"``,
    named by the caller: with CUDA tensors gloo stages every transfer
    through host memory) over ``tcp://127.0.0.1``; returns the ranks'
    results in rank order.  Each rank runs on one torch and one BLAS
    thread.  ``fn`` must be importable by the children (a module-level
    function), its result picklable.

    ``timeout`` bounds the whole spawn: it is the group's collective time
    limit, and a rank still running when it expires is killed and
    :class:`TimeoutError` raised, so no rank can hang the caller.  A rank
    that raises kills the others and the traceback is raised here as a
    ``RuntimeError``."""
    _check_backend(backend)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, backend, port, args, timeout, queue),
                         daemon=True) for r in range(world_size)]
    # the children's BLAS pools take one thread too (set before they import numpy)
    pools = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in pools}
    os.environ.update({k: "1" for k in pools})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    results: dict[int, Any] = {}

    def stop():
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)

    try:
        while len(results) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = queue.get(timeout=max(min(left, 1.0), 0.01))
            except queue_mod.Empty:  # a rank may have died without reporting
                if left <= 0:
                    raise TimeoutError(f"{world_size} ranks of {getattr(fn, '__name__', fn)} did not finish "
                                       f"within {timeout:g} s") from None
                dead = [p for r, p in enumerate(procs) if r not in results and not p.is_alive() and p.exitcode]
                if dead and queue.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0].exitcode} before reporting")
                continue
            if not ok:
                # the first failure often breaks its peers' collectives: give
                # them a moment to report, and raise every traceback
                failed = {rank: out}
                settle = time.monotonic() + 2.0
                while time.monotonic() < settle:
                    try:
                        r, ok_r, out_r = queue.get(timeout=0.1)
                    except queue_mod.Empty:
                        continue
                    if not ok_r:
                        failed[r] = out_r
                raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{tb}"
                                             for r, tb in sorted(failed.items())))
            results[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        stop()
    return [results[r] for r in range(world_size)]
