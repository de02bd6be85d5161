"""MPI -> torch collective analogues (paper Sec. IV phase mapping).

The port's counterpart of the reference's ``distributed/collectives.py``.
A ``ShardGroup`` stands where the reference's mesh axis stands: the list
of this process's shards, one ``torch.device`` each (one card may be named
several times), and, when ``torch.distributed`` is initialized with more
than one process, every process's shards after it in rank order.  Each
collective takes one value per local shard, reduces over the local list
first and then across processes, so both forms give the same result.

| paper                          | here                                   |
|--------------------------------|----------------------------------------|
| MPI_Allreduce(MIN/MAX) ratios  | ``allreduce_minmax``                   |
| MPI_Allreduce(SUM) histogram   | ``allreduce_sum``                      |
| MPI_Scan block boundaries      | ``exclusive_scan_sum``                 |
| MPI_Send/Recv index alignment  | ``right_edge_exchange``                |

Every reduction is exact: min and max of float32 values and sums of
integers, so any backend order gives the same bits; no float is ever
summed through a collective.  Only metadata crosses processes (two
scalars, a histogram, one block of edge indices per step), staged through
the host because gloo's point-to-point ops take CPU tensors.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist


class ShardGroup:
    """This process's shards and its place among the processes."""

    def __init__(self, devices: Sequence, distributed: bool):
        """``distributed``: take in every process of torch.distributed's
        default group (which must be initialized)."""
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        self.distributed = distributed and dist.get_world_size() > 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.num_ranks = dist.get_world_size() if self.distributed else 1
        if self.distributed:
            counts = [None] * self.num_ranks
            dist.all_gather_object(counts, len(self.devices))
            if len(set(counts)) != 1:
                raise ValueError(f"every process must hold the same number "
                                 f"of shards, got {counts}")

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process (the mesh axis size)."""
        return self.n_local * self.num_ranks

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.n_local


def axis_size(group: ShardGroup) -> int:
    return group.size


def allreduce_minmax(los: Sequence, his: Sequence, group: ShardGroup):
    """(min of ``los``, max of ``his``) over every shard, as float32.

    Ties go to the first shard in global order, as the reference's
    ``lax.pmin``/``pmax`` resolve them on XLA's host backend: of a -0 and
    a +0 end, the lower shard's zero is the result.  Python's ``min`` and
    ``max`` keep the first of equal values, so each process folds its
    shards in order; across processes every rank's two ends are gathered
    and folded in rank order (a ``ReduceOp.MIN`` would keep either
    zero)."""
    lo = min(float(v) for v in los)
    hi = max(float(v) for v in his)
    if group.distributed:
        every = [torch.empty(2, dtype=torch.float32)
                 for _ in range(group.num_ranks)]
        dist.all_gather(every, torch.tensor([lo, hi], dtype=torch.float32))
        lo = min(float(e[0]) for e in every)
        hi = max(float(e[1]) for e in every)
    return np.float32(lo), np.float32(hi)


def allreduce_sum(xs: Sequence[torch.Tensor], group: ShardGroup
                  ) -> torch.Tensor:
    """Sum of one integer tensor per shard, on the first shard's device."""
    if any(x.is_floating_point() for x in xs):
        raise TypeError("allreduce_sum takes integer tensors only: a float "
                        "sum would depend on the reduction order")
    dev = xs[0].device
    total = xs[0].clone()
    for x in xs[1:]:
        total += x.to(dev)
    if group.distributed:
        host = total.to("cpu", torch.int64)
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        total = host.to(dev, total.dtype)
    return total


def exclusive_scan_sum(xs: Sequence[int], group: ShardGroup) -> List[int]:
    """MPI_Exscan analogue: for each local shard, the sum of ``xs`` over
    every lower-ranked shard (integers)."""
    local = [int(x) for x in xs]
    if group.distributed:
        every = [None] * group.num_ranks
        dist.all_gather_object(every, local)
        flat = [v for part in every for v in part]
    else:
        flat = local
    prefix = np.concatenate([[0], np.cumsum(flat, dtype=np.int64)])
    return [int(prefix[group.first + j]) for j in range(len(local))]


def right_edge_exchange(heads: Sequence[torch.Tensor], group: ShardGroup,
                        fill: torch.Tensor) -> List[torch.Tensor]:
    """Every shard receives the *head* slice of its right neighbour.

    The paper's "index alignment": a block straddling a shard boundary is
    completed from the right neighbour's first elements.  The last shard
    of the last process receives ``fill``.  Across processes the head of
    each process's first shard goes to the process before it.
    """
    recv: List[torch.Tensor] = list(heads[1:])
    last = group.n_local - 1
    if group.distributed:
        reqs = []
        if group.rank > 0:
            send = heads[0].cpu().contiguous()
            reqs.append(dist.isend(send, group.rank - 1))
        buf = None
        if group.rank < group.num_ranks - 1:
            buf = torch.empty(heads[last].shape, dtype=heads[last].dtype)
            reqs.append(dist.irecv(buf, group.rank + 1))
        for req in reqs:
            req.wait()
        recv.append(fill if buf is None else buf)
    else:
        recv.append(fill)
    return [r.to(group.devices[j]) for j, r in enumerate(recv)]


__all__ = ["ShardGroup", "allreduce_minmax", "allreduce_sum", "axis_size",
           "exclusive_scan_sum", "right_edge_exchange"]
