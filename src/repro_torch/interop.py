"""State carried across between the port and other NUMARCK code.

Plain data in and out -- dicts of numpy arrays, bytes and scalars -- so a
step, a parameter set or a model's weights cross between the port and the
JAX package without either importing the other.  ``step_to_fields``
duck-types over attributes: it takes the port's ``CompressedStep`` or any
object with the same fields (the JAX package's, for one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.chain import resolve_device
from repro_torch.core.pipeline import StepMeta
from repro_torch.core.tree import leaves_with_keys
from repro_torch.core.types import (CompressedStep, NumarckParams,
                                    host_storage, storage_tensor)

STEP_FIELDS = tuple(f.name for f in dataclasses.fields(CompressedStep))


def params_from_dict(d: Dict[str, Any]) -> NumarckParams:
    """The port's ``NumarckParams`` from a plain dict (``to_json`` keys)."""
    return NumarckParams(**d)


def step_to_fields(step) -> Dict[str, Any]:
    """A step as a dict of its ``CompressedStep`` fields: numpy arrays,
    lists of bytes, scalars and a plain ``meta`` dict."""
    out = {name: getattr(step, name) for name in STEP_FIELDS}
    out["index_blocks"] = [bytes(b) for b in step.index_blocks]
    out["meta"] = dict(step.meta)
    if out["block_codecs"] is not None:
        out["block_codecs"] = list(out["block_codecs"])
    for name in ("centers", "index_block_nbytes", "incomp_values",
                 "incomp_block_offsets"):
        if out[name] is not None:
            out[name] = np.array(out[name], copy=True)
    return out


def step_from_fields(fields: Dict[str, Any]) -> CompressedStep:
    """The port's ``CompressedStep`` from ``step_to_fields`` output."""
    kw = dict(fields)
    kw["shape"] = tuple(kw["shape"])
    kw["meta"] = StepMeta(kw["meta"])
    return CompressedStep(**kw)


def _reference_key(name: str) -> str:
    """The reference tree's key of one of the port's parameter names:
    ``layers.3.attn.wq`` is layer 3 of ``layers/attn/wq``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:])
    return "/".join(parts)


@torch.no_grad()
def model_params_from_reference(tree, cfg, device=None):
    """The port's ``LM`` module (on `device`, CUDA unless the caller asks
    for another) holding the JAX package's parameter tree: nested dicts
    of numpy arrays whose layer leaves carry a leading L axis, bfloat16
    leaves as ml_dtypes arrays (read through their uint16 bits, so
    ml_dtypes is never imported).  Every leaf must have the shape and
    dtype of its parameter, and every leaf is used."""
    from repro_torch.models import lm
    from repro_torch.models.model import check_supported
    check_supported(cfg)
    dev = resolve_device(device)
    flat = dict(leaves_with_keys(tree))
    p = lm.LM(cfg, dev)
    used = set()
    for name, param in p.named_parameters():
        key = _reference_key(name)
        if key not in flat:
            raise KeyError(f"the reference tree has no {key!r} for {name}")
        arr, dtype_name = host_storage(flat[key])
        t = storage_tensor(np.array(arr), dtype_name)
        if name.startswith("layers."):
            t = t[int(name.split(".")[1])]
        if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {name} {tuple(param.shape)} {param.dtype}")
        param.copy_(t)
        used.add(key)
    if set(flat) - used:
        raise ValueError(f"reference leaves with no parameter here: "
                         f"{sorted(set(flat) - used)}")
    return p


__all__ = ["STEP_FIELDS", "params_from_dict", "step_to_fields",
           "step_from_fields", "model_params_from_reference"]
