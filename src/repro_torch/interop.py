"""State carried across between the port and other NUMARCK code.

Plain data in and out -- dicts of numpy arrays, bytes and scalars -- so a
step or a parameter set crosses between the port and the JAX package
without either importing the other.  ``step_to_fields`` duck-types over
attributes: it takes the port's ``CompressedStep`` or any object with the
same fields (the JAX package's, for one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.core.pipeline import StepMeta
from repro_torch.core.types import CompressedStep, NumarckParams

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


__all__ = ["STEP_FIELDS", "params_from_dict", "step_to_fields",
           "step_from_fields"]
