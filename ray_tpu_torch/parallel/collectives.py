"""Collective communication API: the port of ray_tpu/parallel/collectives.py.

Two planes, as in the reference:

1. **Device plane** - ``DeviceCollectiveGroup``: collectives over one mesh
   dim's process group (NCCL on the card, gloo on the CPU). Where the JAX
   group is traced inside ``shard_map``, this one is called by each rank on
   its own piece, imperatively, with the JAX semantics: ``allgather``,
   ``reducescatter`` and ``all_to_all`` are tiled (pieces concatenated or
   split along an existing dim, in rank order along the mesh dim);
   ``permute`` takes ``(source, destination)`` positions along the dim and
   leaves zeros where no source sends; ``rank`` and ``size`` are ints.
   Autograd passes through ``allreduce`` (sum, mean), ``allgather``,
   ``reducescatter``, ``broadcast``, ``all_to_all`` and ``permute``: each is
   an autograd Function whose backward is its adjoint (all-reduce,
   reduce-scatter, all-gather, a sum to the root, the inverse all-to-all,
   the inverse permutation). ``torch.distributed.nn.functional`` has such
   Functions too, but on gloo its all-gather's backward scatters from a
   group-local rank as if it were a global one and fails on any subgroup
   of a mesh (torch 2.13). ``allreduce`` max/min does not differentiate.
   On a dim of size 1 every call is the identity, with no communication.

2. **Host plane** - ``HostCollectiveGroup``: barrier and rank-0 broadcast
   for control coordination, over a named thread actor of the port's
   in-process runtime (``ray_tpu_torch.remote``), as the reference's is a
   named actor of its runtime.
"""

from __future__ import annotations

import threading
from typing import Any

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import axis_ranks

_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _exchange(x: torch.Tensor, dst: int | None, src: int | None) -> torch.Tensor:
    """Send ``x`` to global rank ``dst`` and receive a tensor like it from
    ``src`` (either may be None), in one batch of point-to-point ops."""
    out = torch.zeros_like(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dst))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, src))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _permute(x: torch.Tensor, ranks: list[int], me: int, perm) -> torch.Tensor:
    """``x`` moved along ``perm`` ((source, destination) positions in
    ``ranks``); zeros where nothing arrives."""
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"permutation {perm} sends or receives twice at position {me}")
    dst, src = (dsts or [None])[0], (srcs or [None])[0]
    if dst == me and src == me:
        return x.clone()
    return _exchange(x, None if dst is None else ranks[dst], None if src is None else ranks[src])


def _all_reduce(x, group):
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x, group, n: int, dim: int):
    pieces = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(pieces, x.detach().contiguous(), group=group)
    return torch.cat(pieces, dim=dim)


def _reduce_scatter(x, group, n: int, me: int, dim: int):
    if dist.get_backend(group) == dist.Backend.NCCL:
        chunks = [c.contiguous() for c in x.detach().chunk(n, dim=dim)]
        out = torch.empty_like(chunks[me])
        dist.reduce_scatter(out, chunks, group=group)
        return out
    # gloo: a sum of the whole, then this rank's chunk (reduce_scatter is not
    # in gloo on every torch version)
    return _all_reduce(x, group).chunk(n, dim=dim)[me].contiguous()


def _all_to_all(x, group, n: int, split_dim: int, concat_dim: int):
    chunks = [c.contiguous() for c in x.detach().chunk(n, dim=split_dim)]
    got = [torch.empty_like(c) for c in chunks]
    dist.all_to_all(got, chunks, group=group)
    return torch.cat(got, dim=concat_dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dim):
        ctx.args = group, n, me, dim
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, me, dim = ctx.args
        return _reduce_scatter(g, group, n, me, dim), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, dim):
        ctx.args = group, n, dim
        return _reduce_scatter(x, group, n, me, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return _all_gather(g, group, n, dim), None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root_global, is_root):
        ctx.args = group, is_root
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=root_global, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        group, is_root = ctx.args
        total = _all_reduce(g, group)
        return (total if is_root else torch.zeros_like(total)), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = group, n, split_dim, concat_dim
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, n, concat_dim, split_dim), None, None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, me, perm):
        ctx.args = ranks, me, perm
        return _permute(x, ranks, me, perm)

    @staticmethod
    def backward(ctx, g):
        ranks, me, perm = ctx.args
        return _permute(g, ranks, me, [(d, s) for s, d in perm]), None, None, None


class DeviceCollectiveGroup:
    """Collectives bound to one mesh dim; each rank calls them on its piece.

    API parity with ray.util.collective (allreduce/allgather/reducescatter/
    broadcast/send/recv), as the JAX group has it."""

    def __init__(self, mesh, axis_name: str):
        self.mesh = mesh
        self.axis_name = axis_name
        self.group = mesh.get_group(axis_name)
        self.ranks = axis_ranks(mesh, axis_name)  # global ranks along the dim

    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis_name)

    def size(self) -> int:
        return len(self.ranks)

    def _split(self, x, dim: int) -> None:
        if x.shape[dim] % self.size():
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {self.size()} ways")

    def allreduce(self, x, op: str = "sum"):
        if op == "mean":
            return self.allreduce(x, "sum") / self.size()
        if op not in _REDUCE:
            raise ValueError(f"Unsupported reduce op: {op}")
        if self.size() == 1:
            return x
        if op == "sum":
            return _AllReduceSum.apply(x, self.group)
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_REDUCE[op], group=self.group)
        return out

    def allgather(self, x, axis: int = 0, tiled: bool = True):
        if not tiled:
            x = x.unsqueeze(axis)
        if self.size() == 1:
            return x
        return _AllGather.apply(x, self.group, self.size(), self.rank(), axis)

    def reducescatter(self, x, axis: int = 0):
        self._split(x, axis)
        if self.size() == 1:
            return x
        return _ReduceScatter.apply(x, self.group, self.size(), self.rank(), axis)

    def broadcast(self, x, root: int = 0):
        if self.size() == 1:
            return x
        return _Broadcast.apply(x, self.group, self.ranks[root], self.rank() == root)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        self._split(x, split_axis)
        if self.size() == 1:
            return x
        return _AllToAll.apply(x, self.group, self.size(), split_axis, concat_axis)

    def permute(self, x, perm: list[tuple[int, int]]):
        if self.size() == 1:
            return x if (0, 0) in perm else torch.zeros_like(x)
        return _Permute.apply(x, self.ranks, self.rank(), [tuple(p) for p in perm])

    def send_recv_ring(self, x, shift: int = 1):
        n = self.size()
        return self.permute(x, [(i, (i + shift) % n) for i in range(n)])


# ---------------------------------------------------------------- host plane
class _Coordinator:
    """Rendezvous actor: barriers + rank-0 broadcast (reference: sync_actor.py)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._barrier_gen = 0
        self._barrier_count = 0
        self._cv = threading.Condition()
        self._values: dict[str, Any] = {}

    def barrier(self, timeout: float = 60.0) -> bool:
        with self._cv:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count >= self.world_size:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._cv.notify_all()
                return True
            return self._cv.wait_for(lambda: self._barrier_gen > gen, timeout)

    def put_value(self, key: str, value: Any) -> None:
        with self._cv:
            self._values[key] = value
            self._cv.notify_all()

    def get_value(self, key: str, timeout: float = 60.0) -> Any:
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._values, timeout):
                raise TimeoutError(f"broadcast key {key!r} never arrived")
            return self._values[key]


class HostCollectiveGroup:
    """Host-side barrier/broadcast across the members of a gang (threads of
    one process, over the port's runtime, which must be initialized)."""

    def __init__(self, name: str, world_size: int, rank: int):
        import ray_tpu_torch

        self.name = name
        self.world_size = world_size
        self.rank = rank
        # barrier() blocks inside the actor until all ranks arrive, so the actor
        # needs one execution lane per rank (plus slack for broadcast gets).
        actor_cls = ray_tpu_torch.remote(num_cpus=0, max_concurrency=2 * world_size + 1)(
            _Coordinator)
        self._coord = actor_cls.options(name=f"_collective_{name}",
                                        get_if_exists=True).remote(world_size)

    def barrier(self, timeout: float = 60.0) -> None:
        import ray_tpu_torch

        if not ray_tpu_torch.get(self._coord.barrier.remote(timeout), timeout=timeout + 5):
            raise TimeoutError(f"barrier '{self.name}' timed out")

    def broadcast_from_rank_zero(self, key: str, value: Any = None, timeout: float = 60.0) -> Any:
        """Reference: train/collective/collectives.py:16."""
        import ray_tpu_torch

        if self.rank == 0:
            ray_tpu_torch.get(self._coord.put_value.remote(key, value))
            return value
        return ray_tpu_torch.get(self._coord.get_value.remote(key, timeout), timeout=timeout + 5)


def init_collective_group(world_size: int, rank: int, group_name: str = "default") -> HostCollectiveGroup:
    """API parity with ray.util.collective.init_collective_group (collective.py:149)."""
    return HostCollectiveGroup(group_name, world_size, rank)
