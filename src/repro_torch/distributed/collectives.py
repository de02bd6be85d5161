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
scalars, a histogram, and the part of a block that straddles a shard
boundary, if any).

Backends: the default group (``launch/distributed.py``: gloo) carries the
edge exchange and the scan, staged through the host.  The range and the
histogram go through an NCCL subgroup on the cards when every shard of
the fleet is a CUDA card of its own (``collective_backend``, decided from
the card identities that ``ShardGroup`` gathers, so every rank decides
alike); otherwise (CPU shards, ranks that share a card, which NCCL
refuses, or one process) through gloo as well, staged through the host.

Telemetry: each call is one span, from its local fold through its
exchange to the copy back: ``coll.range`` (``allreduce_minmax``),
``coll.hist`` (``allreduce_sum``), ``coll.edge``
(``right_edge_exchange``) and ``coll.scan`` (``exclusive_scan_sum``),
with the attributes ``bytes`` (what this process sends: 0 when the group
has one process), ``ranks`` and ``backend`` (``"nccl"`` or ``"gloo"``).
The blocking copy of a device tensor to the host inside one is a
``sync.coll_hist`` (gloo), ``sync.coll_range`` (NCCL: the gathered ends)
or ``sync.coll_edge`` span of its own.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs import telemetry

GLOO, NCCL = "gloo", "nccl"


def _card_id(device: torch.device) -> Optional[str]:
    """The identity of a shard's card (its UUID), None for a CPU shard."""
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def collective_backend(cards: Sequence[Sequence[Optional[str]]]) -> str:
    """The backend of the range and histogram collectives, from every
    process's ``_card_id`` of each shard, in rank order: NCCL when there
    is more than one process and every shard is a CUDA card that no other
    shard names; else gloo (CPU shards, one card named twice, which NCCL
    refuses, or one process)."""
    flat = [c for rank in cards for c in rank]
    if (len(cards) > 1 and None not in flat
            and len(set(flat)) == len(flat)):
        return NCCL
    return GLOO


class ShardGroup:
    """This process's shards and its place among the processes."""

    def __init__(self, devices: Sequence, distributed: bool):
        """``distributed``: take in every process of torch.distributed's
        default group (which must be initialized).  Every process must
        build its group at the same point: on a fleet of one card a shard
        (``collective_backend``) they make the NCCL subgroup together."""
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one device")
        self.distributed = distributed and dist.get_world_size() > 1
        self.rank = dist.get_rank() if self.distributed else 0
        self.num_ranks = dist.get_world_size() if self.distributed else 1
        self.backend = GLOO
        self._cards = None            # the NCCL subgroup, under NCCL
        if self.distributed:
            cards = [None] * self.num_ranks
            dist.all_gather_object(cards, [_card_id(d) for d in self.devices])
            counts = [len(c) for c in cards]
            if len(set(counts)) != 1:
                raise ValueError(f"every process must hold the same number "
                                 f"of shards, got {counts}")
            self.backend = collective_backend(cards)
        if self.backend == NCCL:
            self._cards = dist.new_group(backend=NCCL)
            # The first collective starts the communicator: in set-up, not
            # in a step.
            dist.all_reduce(torch.zeros(1, dtype=torch.int64,
                                        device=self.devices[0]),
                            group=self._cards)
            torch.cuda.synchronize(self.devices[0])

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
    zero).  A gather copies bit patterns, so signed zeros survive it on
    either backend."""
    with telemetry.span("coll.range", bytes=8 if group.distributed else 0,
                        ranks=group.num_ranks, backend=group.backend):
        lo = min(float(v) for v in los)
        hi = max(float(v) for v in his)
        if group.backend == NCCL:
            dev = group.devices[0]
            # Two fills (the ends as kernel arguments): no copy, no wait.
            mine = torch.full((2,), lo, dtype=torch.float32, device=dev)
            mine[1].fill_(hi)
            every = torch.empty(2 * group.num_ranks, dtype=torch.float32,
                                device=dev)
            dist.all_gather_into_tensor(every, mine, group=group._cards)
            with telemetry.span("sync.coll_range"):
                ends = every.tolist()
            lo, hi = min(ends[0::2]), max(ends[1::2])
        elif group.distributed:
            every = [torch.empty(2, dtype=torch.float32)
                     for _ in range(group.num_ranks)]
            dist.all_gather(every, torch.tensor([lo, hi],
                                                dtype=torch.float32))
            lo = min(float(e[0]) for e in every)
            hi = max(float(e[1]) for e in every)
    return np.float32(lo), np.float32(hi)


def allreduce_sum(xs: Sequence[torch.Tensor], group: ShardGroup
                  ) -> torch.Tensor:
    """Sum of one integer tensor per shard, on the first shard's device.
    Across processes the sum is taken in int64 (order-free, so either
    backend gives the same bits): in place on the card under NCCL, staged
    through the host under gloo."""
    if any(x.is_floating_point() for x in xs):
        raise TypeError("allreduce_sum takes integer tensors only: a float "
                        "sum would depend on the reduction order")
    dev = xs[0].device
    with telemetry.span("coll.hist", ranks=group.num_ranks,
                        backend=group.backend) as sp:
        total = xs[0].clone()
        for x in xs[1:]:
            total += x.to(dev)
        sent = 0
        if group.backend == NCCL:
            wide = total.to(torch.int64)
            dist.all_reduce(wide, op=dist.ReduceOp.SUM, group=group._cards)
            sent = wide.nbytes
            total = wide.to(total.dtype)
        elif group.distributed:
            # Cast on the device both ways: the host only copies.
            with telemetry.span("sync.coll_hist"):
                host = total.to(torch.int64).cpu()
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            sent = host.nbytes
            total = host.to(dev).to(total.dtype)
        sp.set(bytes=sent)
    return total


def exclusive_scan_sum(xs: Sequence[int], group: ShardGroup) -> List[int]:
    """MPI_Exscan analogue: for each local shard, the sum of ``xs`` over
    every lower-ranked shard (integers)."""
    local = [int(x) for x in xs]
    sent = 8 * len(local) if group.distributed else 0
    with telemetry.span("coll.scan", bytes=sent, ranks=group.num_ranks,
                        backend=GLOO):
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
    completed from the right neighbour's first elements.  ``heads[j]`` is
    what the shard before local shard j needs, and ``fill`` has the length
    that the last local shard needs from its right, which the last shard
    of the last process receives as it is.  Across processes the head of
    each process's first shard goes to the process before it; an empty
    head (no block straddles that boundary) crosses nothing.
    """
    recv: List[torch.Tensor] = list(heads[1:])
    with telemetry.span("coll.edge", ranks=group.num_ranks,
                        backend=GLOO) as sp:
        sent = 0
        if group.distributed:
            reqs = []
            if group.rank > 0 and heads[0].numel():
                with telemetry.span("sync.coll_edge"):
                    send = heads[0].cpu().contiguous()
                sent = send.nbytes
                reqs.append(dist.isend(send, group.rank - 1))
            buf = None
            if group.rank < group.num_ranks - 1:
                buf = torch.empty(fill.shape, dtype=fill.dtype)
                if buf.numel():
                    reqs.append(dist.irecv(buf, group.rank + 1))
            for req in reqs:
                req.wait()
            recv.append(fill if buf is None else buf)
        else:
            recv.append(fill)
        sp.set(bytes=sent)
        return [r.to(group.devices[j]) for j, r in enumerate(recv)]


__all__ = ["GLOO", "NCCL", "ShardGroup", "allreduce_minmax", "allreduce_sum",
           "axis_size", "collective_backend", "exclusive_scan_sum",
           "right_edge_exchange"]
