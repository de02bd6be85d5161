"""Elastic restore: load a checkpoint onto a *different* mesh.

The port's counterpart of the reference's ``checkpoint/elastic.py``.
Checkpoints are stored mesh-agnostic (full logical tensors), so elastic
scaling reduces to laying each restored leaf out on the new mesh with
the parameter rules' placements (``sharding.named_shardings``).  Every
rank restores the whole tree, so each takes its own shard of it where it
stands (``distribute_tensor(..., src_data_rank=None)``): no collective
runs.  This is the restart path after growing or shrinking the fleet.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.core.tree import leaves_with_keys, map_with_keys
from repro_torch.distributed import sharding as shd


def reshard_tree(tree: Any, cfg, mesh, dp=("data",), tp="model"):
    """A tree of tensors -> the same tree of DTensors on DeviceMesh `mesh`
    (params rules), each on the mesh's device; other leaves (scalars)
    stay as they are."""
    ns = dict(leaves_with_keys(shd.named_shardings(tree, cfg, mesh, dp,
                                                   tp)))

    def one(key, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        sh = ns[key]
        return distribute_tensor(leaf, sh.mesh, sh.placements,
                                 src_data_rank=None)

    return map_with_keys(one, tree)


def restore_elastic(manager, template, cfg, mesh, dp=("data",),
                    tp="model"):
    """``restore_latest`` + reshard onto `mesh`.  Returns (step, tree) or
    None."""
    out = manager.restore_latest(template=template)
    if out is None:
        return None
    step, tree = out
    return step, reshard_tree(tree, cfg, mesh, dp, tp)


__all__ = ["reshard_tree", "restore_elastic"]
