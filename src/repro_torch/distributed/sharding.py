"""Sharding rules: 2-D (FSDP x TP) weight layouts as DTensor placements.

The port's counterpart of the reference's ``distributed/sharding.py``.
Weights carry ``PartitionSpec``s over ("data", "model"): FSDP shards a
large non-TP dim over "data", Megatron TP shards heads / ffn-hidden /
vocab / experts over "model".  Dims that don't divide the axis fall back
to replication (e.g. minicpm3's 40 heads on a 16-way axis shard the LoRA
rank instead).

The rules are pure functions of axis names and sizes: a mesh is a
``torch.distributed.device_mesh.DeviceMesh``, an object whose ``shape``
maps axis names to sizes, or such a mapping itself, so a layout of
(16, 16) can be asked for without 256 ranks.  ``PartitionSpec`` has the
elements of jax's: per tensor dim an axis name, a tuple of axis names
(major to minor) or None.

``named_shardings`` turns specs into what ``distribute_tensor`` takes:
a ``NamedSharding`` of mesh and placements, one per mesh dim -- ``Shard(i)`` on
every mesh dim a spec element names for tensor dim i, ``Replicate()``
elsewhere.  DTensor splits a dim as ``torch.chunk`` does where GSPMD pads
(10 over 4: 3, 3, 3, 1), and each rank holds the same data either way.

Activation constraints go through a process-global active mesh so model
code stays mesh-agnostic: ``constrain`` returns its input unchanged when
no mesh is active or the input is a plain tensor, and redistributes a
DTensor.  The model calls it at the reference's four sites and at the
layouts DTensor needs (``models/layers.py``); outside the dry run it runs
on plain tensors, where every call is the identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.tree import leaves_with_keys, map_with_keys

_ACTIVE = {"mesh": None, "dp": ("data",), "tp": "model",
           "shard_seq": False}


class PartitionSpec:
    """jax's ``PartitionSpec``: one element per tensor dim.  Tuple-like
    (iterates, indexes and compares equal to the tuple of its elements)
    but not a tuple, so a tree of specs has one leaf per tensor."""

    __slots__ = ("_elems",)

    def __init__(self, *elems):
        self._elems = tuple(elems)

    def __iter__(self):
        return iter(self._elems)

    def __len__(self) -> int:
        return len(self._elems)

    def __getitem__(self, i):
        return self._elems[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._elems
        return isinstance(other, tuple) and self._elems == other

    def __hash__(self) -> int:
        return hash(self._elems)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._elems!r}"


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its DeviceMesh, the DTensor placements (one per
    mesh dim) and the spec they come from.  Not a tuple, so a tree of
    them has one leaf per tensor."""

    mesh: Any
    placements: tuple
    spec: PartitionSpec


def activate(mesh, dp_axes=("data",), tp_axis="model",
             shard_seq: bool = False):
    _ACTIVE.update(mesh=mesh, dp=tuple(dp_axes), tp=tp_axis,
                   shard_seq=shard_seq)


def deactivate():
    _ACTIVE.update(mesh=None)


def active_axes():
    """(dp axes, tp axis) of the active mesh."""
    return _ACTIVE["dp"], _ACTIVE["tp"]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh, of an object whose ``shape``
    maps names to sizes, or of such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(getattr(mesh, "shape", mesh))


def axis_size(mesh, name) -> int:
    sizes = mesh_axes(mesh)
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= sizes[n]
        return out
    return sizes[name]


def _dp_name(dp):
    dp = tuple(dp)
    return dp if len(dp) > 1 else dp[0]


def logical_to_spec(logical: Tuple, mesh, dp, tp,
                    shape=None) -> PartitionSpec:
    """('dp'|'tp'|'tp!'|None, ...) -> PartitionSpec.

    'tp' falls back to replication when the dim doesn't divide; 'tp!'
    forces the sharding (uneven shards -- padded expert parallelism, E=8
    on a 16-way axis)."""
    elems = []
    for i, ax in enumerate(logical):
        if ax == "dp":
            elems.append(_dp_name(dp))
        elif ax == "tp!":
            elems.append(tp)
        elif ax == "tp":
            if shape is not None and shape[i] % axis_size(mesh, tp) != 0:
                elems.append(None)
            else:
                elems.append(tp)
        else:
            elems.append(None)
    return PartitionSpec(*elems)


def placements(spec, mesh) -> tuple:
    """DTensor placements on DeviceMesh `mesh` for `spec`."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, elem in enumerate(spec):
        if elem is None:
            continue
        axes = elem if isinstance(elem, tuple) else (elem,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            # DTensor shards one tensor dim over several mesh dims in mesh
            # order, major to minor; another order has no plain placement.
            raise ValueError(f"spec element {elem!r} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for m in dims:
            out[m] = Shard(i)
    return tuple(out)


def constrain(x, *logical):
    """Redistribute a DTensor to the active mesh's layout for `logical`
    ('dp', 'tp', 'seq' (tp iff shard_seq is on) or None per dim); the
    input itself when no mesh is active or it is a plain tensor."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, layout(x.shape, *logical))


def layout(shape, *logical) -> tuple:
    """The placements on the active mesh of a tensor of `shape` laid out
    by `logical`, as ``constrain`` resolves it.  "dp" falls back to
    replication where the dim does not divide (a batch of 1): DTensor's
    views refuse the uneven shards GSPMD pads."""
    mesh, dp, tp = _ACTIVE["mesh"], _ACTIVE["dp"], _ACTIVE["tp"]
    dp_size = axis_size(mesh, _dp_name(dp))
    resolved = tuple(
        ("tp" if _ACTIVE["shard_seq"] else None) if ax == "seq"
        else (None if ax == "dp" and shape[i] % dp_size else ax)
        for i, ax in enumerate(logical))
    spec = logical_to_spec(resolved, mesh, dp, tp, shape=shape)
    return placements(spec, mesh)


def heads_axis(n: int):
    """The logical axis of a dim of `n` heads: "tp" where `n` divides over
    the active mesh's tp axis (or no mesh is active), else None
    (replicated)."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or n % axis_size(mesh, _ACTIVE["tp"]) == 0:
        return "tp"
    return None


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _ep_ok(cfg) -> bool:
    # Expert parallelism keeps experts resident (FSDP-gathering expert
    # weights every step is the costlier layout); moe_ep_split fans each
    # expert into FFN slices so slots = n_experts * split matches the
    # 16-way model axis (mixtral: 8 x 2).
    slots = (getattr(cfg, "n_experts", 0)
             * getattr(cfg, "moe_ep_split", 1))
    return slots >= 16


def param_logical(path_s: str, ndim: int, cfg) -> Tuple:
    """Map a parameter path to logical axes ('dp', 'tp', None)."""
    name = path_s.split("/")[-1]
    # stacked layer params may sit under a wrapper key ("params/layers/...")
    stacked = "layers/" in path_s or path_s.startswith("layers")
    lead = ("layer",) if stacked else ()
    body_ndim = ndim - len(lead)
    ep = _ep_ok(cfg)

    table = {
        "embed": ("tp", "dp"),
        "unembed": ("dp", "tp"),
        "wq": ("dp", "tp", None),
        "wk": ("dp", "tp", None),
        "wv": ("dp", "tp", None),
        "wo": ("tp", None, "dp"),
        "bq": ("tp", None),
        "bk": ("tp", None),
        "bv": ("tp", None),
        "w_gate": ("dp", "tp"),
        "w_up": ("dp", "tp"),
        "w_down": ("tp", "dp"),
        "router": ("dp", None),
        # MoE experts: EP over 'model' when the slot count fills the
        # axis, else TP inside the expert
        "we_gate": ("tp", "dp", None) if ep else (None, "dp", "tp"),
        "we_up": ("tp", "dp", None) if ep else (None, "dp", "tp"),
        "we_down": ("tp", None, "dp") if ep else (None, "tp", "dp"),
        # MLA
        "wq_a": ("dp", "tp"),
        "wq_b": ("tp", None, None),     # shard q_lora rank (heads may not
        "wk_b": ("tp", None, None),     # divide the axis: 40 on 16)
        "wv_b": ("tp", None, None),
        "wkv_a": ("dp", None),
        # SSD
        "in_proj": ("dp", "tp"),
        "out_proj": ("tp", "dp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "A_log": ("tp",),
        "D": ("tp",),
        "dt_bias": ("tp",),
        "scale": (None,),
    }
    logical = table.get(name, (None,) * body_ndim)
    if len(logical) != body_ndim:
        logical = (None,) * body_ndim
    return (None,) * len(lead) + tuple(logical)


def _shape(leaf) -> Optional[tuple]:
    """A tensor's or array's shape; None for a scalar leaf."""
    shape = getattr(leaf, "shape", None)
    return None if shape is None else tuple(shape)


def _param_spec(path: str, leaf, cfg, mesh, dp, tp):
    shape = _shape(leaf)
    if shape is None:
        return None
    dp_name = _dp_name(dp)
    # fsdp ('dp') dims must also divide; else replicate.  'tp!' forces the
    # sharding.
    elems = []
    for i, ax in enumerate(param_logical(path, len(shape), cfg)):
        if ax == "dp":
            elems.append(None if shape[i] % axis_size(mesh, dp_name)
                         else dp_name)
        elif ax == "tp!":
            elems.append(tp)
        elif ax == "tp":
            elems.append(None if shape[i] % axis_size(mesh, tp) else tp)
        else:
            elems.append(None)
    return PartitionSpec(*elems)


def param_specs(params_tree, cfg, mesh, dp=("data",), tp="model"):
    """Tree of PartitionSpecs matching `params_tree` (tensors, "meta"
    tensors or arrays); a scalar leaf gets None."""
    return map_with_keys(
        lambda path, leaf: _param_spec(path, leaf, cfg, mesh, dp, tp),
        params_tree)


def named_shardings(params_tree, cfg, mesh, dp=("data",), tp="model"):
    """Tree of ``NamedSharding``s on DeviceMesh `mesh`, one per tensor
    leaf (None for a scalar leaf)."""
    def one(path, leaf):
        spec = _param_spec(path, leaf, cfg, mesh, dp, tp)
        return None if spec is None else NamedSharding(
            mesh, placements(spec, mesh), spec)

    return map_with_keys(one, params_tree)


# ---------------------------------------------------------------------------
# serve-cache rules
# ---------------------------------------------------------------------------

_CACHE_TABLE = {
    # name: logical spec for the *unstacked* leaf.  "tp>" = shard this
    # dim over tp, falling back to the dim marked "alt" when it doesn't
    # divide (e.g. 8 or 24 kv heads on a 16-way axis -> shard head_dim).
    "k": ("batch", None, "tp>", "alt"),
    "v": ("batch", None, "tp>", "alt"),
    "ckv": ("batch", None, "alt"),
    "krope": ("batch", None, None),
    "pos_map": (None,),
    "conv": ("batch", None, "tp"),
    "h": ("batch", "tp>", "alt", None),
}


def cache_specs(cache_tree, mesh, dp=("data",), tp="model",
                stacked: bool = True):
    """PartitionSpecs for a decode cache tree (KV over batch + TP heads).

    Falls back to replication per dim when sizes don't divide (e.g. a
    global batch of 1, or 8 kv heads on a 16-way axis)."""
    dp_name = _dp_name(dp)
    dp_size = axis_size(mesh, dp_name)
    tp_size = axis_size(mesh, tp)

    def one(path, leaf):
        name = path.split("/")[-1]
        logical = _CACHE_TABLE.get(name)
        shape = _shape(leaf)
        if logical is None:
            return PartitionSpec(*([None] * len(shape)))
        lead = len(shape) - len(logical)
        elems = [None] * lead
        primary_failed = False
        used_tp = False
        for i, ax in enumerate(logical):
            dim = shape[lead + i]
            if ax == "batch" and dim % dp_size == 0:
                elems.append(dp_name)
            elif ax == "tp" and dim % tp_size == 0 and dim > 1:
                elems.append(tp)
            elif ax == "tp>":
                if dim % tp_size == 0 and dim > 1:
                    elems.append(tp)
                    used_tp = True
                else:
                    elems.append(None)
                    primary_failed = True
            elif ax == "alt":
                if ((primary_failed or not used_tp)
                        and dim % tp_size == 0 and dim > 1):
                    elems.append(tp)
                    used_tp = True
                else:
                    elems.append(None)
            else:
                elems.append(None)
        return PartitionSpec(*elems)

    return map_with_keys(one, cache_tree)


def place_cache(cache_tree, stacked: bool = True):
    """A decode cache as DTensors laid out by ``cache_specs`` on the
    active mesh (each rank its shard, no collective); the tree itself
    when no mesh is active."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return cache_tree
    from torch.distributed.tensor import distribute_tensor
    specs = dict(leaves_with_keys(cache_specs(
        cache_tree, mesh, _ACTIVE["dp"], _ACTIVE["tp"], stacked)))
    return map_with_keys(
        lambda key, t: distribute_tensor(t, mesh, placements(specs[key],
                                                             mesh),
                                         src_data_rank=None), cache_tree)


def batch_specs(batch_tree, mesh, dp=("data",)):
    """Input batches: shard the leading (global batch) dim over dp."""
    dp_name = _dp_name(dp)
    dp_size = axis_size(mesh, dp_name)

    def one(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return PartitionSpec()
        elems = [None] * len(shape)
        if shape[0] % dp_size == 0:
            elems[0] = dp_name
        return PartitionSpec(*elems)

    return map_with_keys(one, batch_tree)


__all__ = ["PartitionSpec", "NamedSharding", "activate", "deactivate",
           "active_axes", "constrain", "layout", "heads_axis",
           "param_specs",
           "named_shardings", "logical_to_spec", "axis_size", "mesh_axes",
           "placements", "param_logical", "cache_specs", "place_cache",
           "batch_specs"]
