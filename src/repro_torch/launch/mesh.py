"""Production mesh construction over torch.distributed.

The port's counterpart of the reference's ``launch/mesh.py``: the same
shapes and axis names, (16, 16) ("data", "model") for one pod and (2, 16,
16) ("pod", "data", "model") for two, as a ``DeviceMesh`` over the
default group's ranks in rank order (row-major).  Functions, not
module-level constants, so importing this module touches no device and
starts no process group.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

from repro_torch.launch.distributed import join_alone


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of `shape` named `axis_names`.  A mesh of one rank
    joins a one-rank group when no group is up; a larger one needs the
    fleet's group (``launch.distributed.initialize``) or torch's
    ``env://`` variables."""
    from torch.distributed.device_mesh import init_device_mesh

    if math.prod(shape) == 1 and not dist.is_initialized():
        join_alone()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def dp_axes(mesh) -> tuple:
    """Batch/FSDP axes: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def mesh_chips(mesh) -> int:
    return mesh.size()


__all__ = ["make_mesh", "make_production_mesh", "dp_axes", "tp_axis",
           "mesh_chips"]
