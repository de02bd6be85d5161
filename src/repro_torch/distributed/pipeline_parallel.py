"""GPipe-style pipeline parallelism over a mesh dim (library feature).

The port's counterpart of the reference's
``distributed/pipeline_parallel.py``.  One rank per stage along mesh dim
`axis`; microbatches flow right by point-to-point ops of that dim's
process group, staged through the host (gloo's point-to-point ops take
CPU tensors).  The forward runs the classic GPipe schedule in M + P - 1
ticks: at tick t stage s works on microbatch t - s, and skips the ticks
where that is no microbatch (the reference masks them; their gradient is
zero).

Each transfer is an autograd Function: its forward sends right, its
backward sends the gradient left.  So ``torch.autograd.grad`` of a loss
over the output runs the reverse schedule too, and gives each rank the
gradient of its own stage's slice of `stage_params`, as ``jax.grad``
through the reference's ``ppermute`` does.  The output reaches every
rank through a broadcast from the last stage (the reference's closing
``psum`` over one non-zero term); every rank computes the same loss over
it, and the broadcast's backward keeps each rank's own cotangent, so
the last stage's gradient is that of the one loss.

Messages carry a tag per microbatch and direction.  The forward's sends
do not block, and its receives come in tick order.  In the backward each
rank's autograd engine picks its own order of microbatches, so the
first gradient a stage needs from its right neighbour posts the
receives of all M at once (``_Inbox``): a blocking send of a gradient to
the left then always finds its receive posted, whatever order the two
ranks walk the microbatches in.  (A stage's first backward transfer is
always such a receive: a gradient it sends left flows back through its
``stage_fn`` from the one it received.)
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import leaves_with_keys, map_with_keys


class _Ring:
    """This rank's place on mesh dim `axis`: its stage, the stage count
    and the dim's process group."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.stage = mesh.get_local_rank(axis)
        self.n = mesh.size(mesh.mesh_dim_names.index(axis))

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


class _Inbox:
    """The gradients a stage receives from the next one in the backward,
    one per microbatch: the first that is asked for posts non-blocking
    receives of all `n` (tag 2 m + 1), and each is taken once."""

    def __init__(self, ring, n: int):
        self.ring, self.n = ring, n
        self.like = None                 # (shape, dtype) of an output
        self.posted = {}

    def take(self, m: int) -> torch.Tensor:
        if not self.posted:
            shape, dtype = self.like
            for i in range(self.n):
                buf = torch.empty(shape, dtype=dtype)
                self.posted[i] = (dist.irecv(
                    buf, self.ring.peer(self.ring.stage + 1),
                    group=self.ring.group, tag=2 * i + 1), buf)
        work, buf = self.posted.pop(m)
        work.wait()
        return buf


class _SendRight(torch.autograd.Function):
    """Forward: start sending the stage's output `y` (microbatch `m`) to
    the next stage.  Returns an empty token that the closing broadcast
    keeps in the graph.  Backward: take the gradient of `y` from the
    next stage through `inbox`."""

    @staticmethod
    def forward(ctx, y, ring, m, pending, inbox):
        buf = _host(y)
        pending.append((dist.isend(buf, ring.peer(ring.stage + 1),
                                   group=ring.group, tag=2 * m), buf))
        inbox.like = (y.shape, y.dtype)
        ctx.m, ctx.inbox, ctx.device = m, inbox, y.device
        return y.new_zeros(0)

    @staticmethod
    def backward(ctx, _token):
        return (ctx.inbox.take(ctx.m).to(ctx.device), None, None, None,
                None)


class _RecvLeft(torch.autograd.Function):
    """Forward: receive the previous stage's output.  Backward: send its
    gradient back.  `anchors` (the tensors this rank's gradient may be
    taken for) tie the node into every such graph so its backward runs;
    they get no gradient from it."""

    @staticmethod
    def forward(ctx, ring, tag, like, *anchors):
        shape, dtype, device = like
        buf = torch.empty(shape, dtype=dtype)
        dist.recv(buf, ring.peer(ring.stage - 1), group=ring.group,
                  tag=tag)
        ctx.ring, ctx.tag, ctx.n_anchors = ring, tag, len(anchors)
        return buf.to(device)

    @staticmethod
    def backward(ctx, g):
        dist.send(_host(g), ctx.ring.peer(ctx.ring.stage - 1),
                  group=ctx.ring.group, tag=ctx.tag + 1)
        return (None, None, None) + (None,) * ctx.n_anchors


class _FromLast(torch.autograd.Function):
    """Forward: every rank gets the last stage's outputs.  Backward: each
    rank keeps its own cotangent (every rank's loss is the one loss);
    the tokens get empty gradients, which start their stage's sends'
    backward."""

    @staticmethod
    def forward(ctx, out, ring, *tokens):
        ctx.n_tokens = len(tokens)
        if ring.n == 1:
            return out.clone()
        buf = _host(out)
        dist.broadcast(buf, ring.peer(ring.n - 1), group=ring.group)
        return buf.to(out.device)

    @staticmethod
    def backward(ctx, g):
        empty = g.new_zeros(0)
        return (g, None) + (empty,) * ctx.n_tokens


def _stage_slice(leaf, ring: _Ring):
    """This stage's slice of a stacked leaf: a DTensor sharded over the
    stage dim holds it as its (1, ...) local shard; a plain tensor holds
    every stage's."""
    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage's local shard has leading dim "
                             f"{local.shape[0]}, not 1")
        return local[0]
    return leaf[ring.stage]


def pipeline_apply(mesh, axis: str, stage_fn: Callable, stage_params,
                   microbatches: torch.Tensor) -> torch.Tensor:
    """Run `stage_fn` as a P-stage pipeline, one rank a stage along mesh
    dim `axis` of DeviceMesh `mesh`.

    stage_params: tree whose leaves have leading dim P (one slice per
                  stage): plain tensors, or DTensors sharded over `axis`
                  on that dim.
    microbatches: (M, mb, ...) tensor on every rank (stage 0 consumes
                  it); every stage maps mb-sized activations to
                  same-shaped activations (homogeneous pipeline).
    Returns the (M, mb, ...) outputs of the last stage on every rank.
    """
    ring = _Ring(mesh, axis)
    s, n_stages = ring.stage, ring.n
    M = microbatches.shape[0]
    params_me = map_with_keys(lambda _, leaf: _stage_slice(leaf, ring),
                              stage_params)
    anchors = [t for _, t in leaves_with_keys(params_me)
               if isinstance(t, torch.Tensor) and t.requires_grad]
    if microbatches.requires_grad:
        anchors.append(microbatches)
    like = (microbatches.shape[1:], microbatches.dtype,
            microbatches.device)

    pending: List = []
    inbox = _Inbox(ring, M)
    tokens, ys = [], []
    for t in range(M + n_stages - 1):
        m = t - s                       # my microbatch at tick t
        if not 0 <= m < M:
            continue
        x = (microbatches[m] if s == 0
             else _RecvLeft.apply(ring, 2 * m, like, *anchors))
        y = stage_fn(params_me, x)
        if s < n_stages - 1:
            tokens.append(_SendRight.apply(y, ring, m, pending, inbox))
        else:
            ys.append(y)
    for work, _buf in pending:
        work.wait()
    out = (torch.stack(ys) if ys
           else microbatches.new_zeros(microbatches.shape))
    return _FromLast.apply(out, ring, *tokens)


def stack_stages(layer_params_list):
    """[per-stage trees] -> one tree, each leaf stacked on a leading stage
    dim."""
    flats = [dict(leaves_with_keys(t)) for t in layer_params_list]
    return map_with_keys(lambda key, _: torch.stack([f[key] for f in flats]),
                         layer_params_list[0])


__all__ = ["pipeline_apply", "stack_stages"]
