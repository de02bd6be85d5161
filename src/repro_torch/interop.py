"""State carried across between the port and other NUMARCK code.

Plain data in and out -- dicts of numpy arrays, bytes and scalars -- so a
step, a parameter set, a model's weights or a train state cross between
the port and the JAX package without either importing the other.
``step_to_fields`` duck-types over attributes: it takes the port's
``CompressedStep`` or any object with the same fields (the JAX
package's, for one); so does ``train_state_from_reference`` for the
optimizer and compression states.  A bfloat16 leaf comes out of the
port as its uint16 bits (``.view(ml_dtypes.bfloat16)`` on the JAX side)
and goes in as an ml_dtypes array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from repro_torch.core.chain import resolve_device
from repro_torch.core.pipeline import StepMeta
from repro_torch.core.tree import leaves_with_keys, map_with_keys
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


def _to_numpy(tree):
    return map_with_keys(lambda _, t: np.array(host_storage(t)[0]), tree)


def _to_device(tree, dev):
    def put(_, leaf):
        arr, dtype_name = host_storage(leaf)
        return storage_tensor(np.array(arr), dtype_name).to(dev)
    return map_with_keys(put, tree)


def _reference_params(tree, cfg, dev):
    """A reference parameter tree on `dev`, its leaves the model's: one
    for every parameter, in its shape and dtype, and no other."""
    from repro_torch.models import lm
    from repro_torch.models.model import check_supported
    check_supported(cfg)
    params = _to_device(tree, dev)
    want = {lm.reference_key(n) for n, _ in lm.LM(cfg, "meta")
            .named_parameters()}
    got = {k for k, _ in leaves_with_keys(params)}
    if got != want:
        raise ValueError(f"reference leaves {sorted(got - want)} have no "
                         f"parameter in {cfg.name}, and its parameters "
                         f"{sorted(want - got)} no leaf")
    lm.bind_params(params, cfg)          # raises on a shape or dtype
    return params


def model_params_from_reference(tree, cfg, device=None):
    """The port's ``LM`` module (on `device`, CUDA unless the caller asks
    for another) holding the JAX package's parameter tree: nested dicts
    of numpy arrays whose layer leaves carry a leading L axis, bfloat16
    leaves as ml_dtypes arrays (read through their uint16 bits, so
    ml_dtypes is never imported).  Every leaf must have the shape and
    dtype of its parameter, and every leaf is used.  The layers'
    parameters are views of the stacked leaves, and require no grad."""
    from repro_torch.models import lm
    params = _reference_params(tree, cfg, resolve_device(device))
    return lm.bind_params(params, cfg).requires_grad_(False)


def model_params_to_reference(params) -> Dict:
    """The port's ``LM`` as the JAX package's parameter tree: nested dicts
    of numpy arrays, the layers stacked on a leading L axis (the inverse
    of ``model_params_from_reference``)."""
    from repro_torch.models import lm
    return _to_numpy(lm.param_tree(params))


def train_state_to_reference(state) -> Dict:
    """A port ``TrainState`` as the reference's ``TrainState.tree()``:
    {"params", "opt_state": AdamState(step, m, v)[, "gc_state":
    GradCompState(residual)]} of numpy arrays; the NamedTuples are the
    port's, which jax flattens and keys as it does the reference's."""
    return _to_numpy(state.tree())


def train_state_from_reference(tree, cfg, device=None):
    """A port ``TrainState`` on `device` (CUDA unless the caller asks for
    another) from the reference's ``TrainState.tree()`` as numpy
    (``jax.device_get``): the params in its layout, checked against
    `cfg`'s parameters leaf for leaf, and any objects with the
    ``step``/``m``/``v`` and ``residual`` fields for the states."""
    from repro_torch.train.gradcomp import GradCompState
    from repro_torch.train.optim import AdamState
    from repro_torch.train.trainer import TrainState
    dev = resolve_device(device)
    params = _reference_params(tree["params"], cfg, dev)
    opt = tree["opt_state"]
    opt_state = AdamState(*(_to_device(getattr(opt, f), dev)
                            for f in AdamState._fields))
    gc = tree.get("gc_state")
    gc_state = (None if gc is None
                else GradCompState(_to_device(gc.residual, dev)))
    return TrainState(params, opt_state, gc_state)


__all__ = ["STEP_FIELDS", "params_from_dict", "step_to_fields",
           "step_from_fields", "model_params_from_reference",
           "model_params_to_reference", "train_state_to_reference",
           "train_state_from_reference"]
