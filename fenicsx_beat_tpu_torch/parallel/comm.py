"""The sharded solvers' communicator: the only place they touch
``torch.distributed``.

The JAX package's sharded solvers move data with ``lax.ppermute`` (the
halo exchange) and ``lax.psum``/``pmax``/``all_gather`` inside one
``shard_map`` program (``parallel/solver.py:461-468``, ``:546-552``).  The
port runs SPMD, one process per rank, and :class:`Communicator` carries
every cross-rank transfer:

- :meth:`Communicator.halo_extend`: ``[n]`` -> ``[H | n | H]``, the last H
  entries of the left neighbour and the first H of the right one (zeros at
  the ends of the chain), through one ``batch_isend_irecv``;
- :meth:`Communicator.halo_reduce`: its transpose, the halo entries of an
  extended vector sent back and added to their owners' rows (the reverse
  exchange, the ``ppermute`` transpose of the JAX adjoint);
- sum and max all-reduces and an all-gather.

It counts each kind of call and the bytes that leave the rank
(:attr:`Communicator.counts`).  A rank without neighbours exchanges
nothing (its halo is zeros); with no process group at all the reductions
are the identity too, while a group of one (NCCL at world size 1) still
runs them through the backend.

NCCL moves CUDA tensors and gloo CPU tensors.  The one exception is an
explicit ``backend="gloo"`` with CUDA tensors (two ranks on one card, which
NCCL refuses): the transfers then go through pinned host buffers while the
compute stays on the card.  No default selects it, and the communicator
prints when it does.

Three autograd Functions make the sharded adjoint differentiable
(:mod:`.adjoint`): :func:`halo_extend_ad` (backward: the reverse
exchange), :func:`all_reduce_sum_ad` (backward: the identity, since every
rank computes the same loss from the reduced value) and
:func:`replicated_ad` (forward: the identity; backward: the sum
all-reduce of a replicated input's partial cotangents, the ``shard_map``
transpose).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from .distributed import DeviceMesh

__all__ = ["Communicator", "halo_extend_ad", "all_reduce_sum_ad", "replicated_ad"]


class Communicator:
    """Cross-rank transfers of one :class:`~.distributed.DeviceMesh`."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.rank, self.world = mesh.rank, mesh.world_size
        self.device = mesh.device
        if self.world > 1 and not dist.is_initialized():
            raise RuntimeError("a mesh of several ranks needs the process group (initialize_distributed)")
        self.local = mesh.backend is None  # no process group: one rank, its collectives the identity
        self.staged = self.world > 1 and mesh.backend == "gloo" and self.device.type == "cuda"
        if self.staged and self.rank == 0:
            print(f"[comm] backend gloo with CUDA tensors on {self.world} ranks: transfers staged through "
                  "pinned host buffers, compute on the card", flush=True)
        self.counts: Counter = Counter()
        self._pinned: dict = {}

    # ------------------------------------------------------------------
    def reset_counts(self) -> None:
        self.counts.clear()

    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer of ``like``'s shape and dtype, kept per key."""
        buf = self._pinned.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _p2p(self, sends: list, recvs: list) -> None:
        """Send each ``(tensor, peer)`` of ``sends`` and fill each ``(tensor,
        peer)`` of ``recvs``, as one batch."""
        if not sends and not recvs:
            return
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
            hs = []
            for i, (t, peer) in enumerate(sends):
                h = self._host(("s", i), t)
                h.copy_(t)
                hs.append((h, peer))
            hr = [(self._host(("r", i), t), peer) for i, (t, peer) in enumerate(recvs)]
            ops = [dist.P2POp(dist.isend, h, peer) for h, peer in hs]
            ops += [dist.P2POp(dist.irecv, h, peer) for h, peer in hr]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            for (t, _), (h, _) in zip(recvs, hr):
                t.copy_(h, non_blocking=True)
            return
        ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    def halo_extend(self, x: torch.Tensor, H: int, out: torch.Tensor | None = None) -> torch.Tensor:
        """``[H | x | H]`` of a ``[n]`` vector: the left neighbour's last H
        entries, ``x``, the right neighbour's first H; zeros past the ends.
        ``out`` (``[n + 2H]``) receives it when given."""
        n = x.shape[0]
        ext = out if out is not None else torch.empty(n + 2 * H, dtype=x.dtype, device=x.device)
        ext[H : H + n].copy_(x)
        self.counts["exchanges"] += 1
        if H == 0:
            return ext
        left, right = self.rank > 0, self.rank < self.world - 1
        if not left:
            ext[:H].zero_()
        if not right:
            ext[H + n :].zero_()
        sends, recvs = [], []
        if left:
            sends.append((x[:H].contiguous(), self.rank - 1))
            recvs.append((ext[:H], self.rank - 1))
        if right:
            sends.append((x[n - H :].contiguous(), self.rank + 1))
            recvs.append((ext[H + n :], self.rank + 1))
        self.counts["halo_bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        self._p2p(sends, recvs)
        return ext

    def halo_reduce(self, g: torch.Tensor, H: int) -> torch.Tensor:
        """The transpose of :meth:`halo_extend`: ``g[H:H+n]`` plus the
        neighbours' halo entries that read this rank's rows (the left
        neighbour's right halo onto the first H rows, the right one's left
        halo onto the last H)."""
        n = g.shape[0] - 2 * H
        y = g[H : H + n].clone()
        self.counts["exchanges"] += 1
        if H == 0 or self.world == 1:
            return y
        left, right = self.rank > 0, self.rank < self.world - 1
        sends, recvs = [], []
        from_left = torch.empty(H, dtype=g.dtype, device=g.device) if left else None
        from_right = torch.empty(H, dtype=g.dtype, device=g.device) if right else None
        if left:
            sends.append((g[:H].contiguous(), self.rank - 1))
            recvs.append((from_left, self.rank - 1))
        if right:
            sends.append((g[H + n :].contiguous(), self.rank + 1))
            recvs.append((from_right, self.rank + 1))
        self.counts["halo_bytes"] += sum(t.numel() * t.element_size() for t, _ in sends)
        self._p2p(sends, recvs)
        if left:
            y[:H] += from_left
        if right:
            y[n - H :] += from_right
        return y

    # ------------------------------------------------------------------
    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.local:
            return t
        self.counts["reduce_bytes"] += t.numel() * t.element_size()
        if self.staged:
            h = self._host(("a", t.shape, t.dtype), t)
            h.copy_(t)
            dist.all_reduce(h, op=op)
            t.copy_(h, non_blocking=True)
            return t
        dist.all_reduce(t, op=op)
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, in place on ``t`` (contiguous), returned."""
        self.counts["all_reduces"] += 1
        return self._all_reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over ranks, in place on ``t``, returned."""
        self.counts["all_reduces"] += 1
        return self._all_reduce(t, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's equal-shaped ``x`` concatenated along dim 0, in rank order."""
        self.counts["all_gathers"] += 1
        if self.local:
            return x.clone()
        self.counts["gather_bytes"] += x.numel() * x.element_size()
        x = x.contiguous()
        if self.staged:
            hx = x.cpu()
            parts = [torch.empty_like(hx) for _ in range(self.world)]
            dist.all_gather(parts, hx)
            return torch.cat(parts).to(x.device)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def gather_global(self, x_loc: torch.Tensor) -> torch.Tensor:
        """The padded global node array of per-rank ``[..., n_local]``
        blocks: the blocks along the last axis, in rank order."""
        if x_loc.dim() == 1:
            return self.all_gather(x_loc)
        parts = self.all_gather(x_loc.movedim(-1, 0).contiguous())
        return parts.movedim(0, -1)

    def barrier(self) -> None:
        if not self.local:
            dist.barrier()


# ---------------------------------------------------------------------------
# autograd


class _HaloExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, H):
        ctx.comm, ctx.H = comm, H
        return comm.halo_extend(x, H)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.halo_reduce(g.contiguous(), ctx.H), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_sum(g.contiguous().clone()), None


def halo_extend_ad(x: torch.Tensor, comm: Communicator, H: int) -> torch.Tensor:
    """:meth:`Communicator.halo_extend` under autograd; its backward is
    :meth:`Communicator.halo_reduce`."""
    return _HaloExtend.apply(x, comm, H)


def all_reduce_sum_ad(x: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """The sum over ranks under autograd, for a value every rank then uses
    alike: the cotangent reaching it is the same on every rank, so its
    backward passes it through."""
    return _AllReduceSum.apply(x, comm)


def replicated_ad(x: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """A replicated input (the same on every rank) under autograd: the
    identity, whose backward sums the ranks' partial cotangents."""
    return _Replicated.apply(x, comm)
