"""AdamW (the port of the reference's ``train/optim.py``).

Trees are the reference's layout (``models.lm.param_tree``: nested dicts
of tensors, the layers stacked on a leading L axis), so the moments key,
shape and checkpoint as the reference's do and weight decay reaches the
same leaves (``ndim >= 2`` of the stacked leaf: the layers' norm scales
decay, ``ln_f`` does not).

The arithmetic is the reference's float32, one rounding per operation in
its order: moments are float32 masters, each update is
``(p.f32 - lr * step).to(p.dtype)``, and every division by a computed
scalar divides by a 0-d tensor on the tensors' device (PyTorch on CUDA
multiplies by the reciprocal of a Python scalar).  ``global_norm`` is a
float32 sum whose order is not XLA's, so it and what it scales agree
with the reference to a tolerance, not bit for bit.

Unlike the reference, ``apply_updates`` writes the moments and the
parameters in place (the same values; at Llama-3.2-1B's full width it
saves a second copy of the 9.9 GB of moments on the card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves_with_keys, map_with_keys


class AdamState(NamedTuple):
    step: torch.Tensor            # int32, 0-d
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def init_state(params) -> AdamState:
    """Zero float32 moments beside each parameter (also for bf16 ones)
    and a 0-d int32 step on the parameters' device."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = next(leaves_with_keys(params))[1].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m=map_with_keys(zeros, params),
                     v=map_with_keys(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; float32 0-d."""
    dev = step.device
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / _f32(
        max(cfg.decay_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for _, x in leaves_with_keys(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(_f32(max_norm, gn.device)
                           / torch.clamp_min(gn, 1e-12), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return map_with_keys(lambda _, g: g * scale, grads), gn


@torch.no_grad()
def apply_updates(params, grads, state: AdamState, cfg: AdamWConfig):
    """One AdamW step on trees of one layout; returns (params, new state,
    {"grad_norm", "lr"}) where params and the state's m and v are the
    given tensors, updated in place, and the step is a new tensor."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    dev = gn.device
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, dev), stepf)
    bc2 = 1 - torch.pow(_f32(b2, dev), stepf)
    grads, ms, vs = (dict(leaves_with_keys(t))
                     for t in (grads, state.m, state.v))
    for key, p in leaves_with_keys(params):
        # the f32 cast and the clip, one leaf at a time
        g = grads[key].to(torch.float32) * scale
        m, v = ms[key], vs[key]
        m.mul_(b1).add_(g * (1 - b1))            # b1 * m + (1 - b1) * g
        v.mul_(b2).add_(g * (1 - b2) * g)        # b2 * v + (1 - b2) * g * g
        del g
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:                          # decoupled decay on matrices
            step_ = step_ + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step_).to(p.dtype))
    return params, AdamState(step, state.m, state.v), {
        "grad_norm": gn, "lr": lr}


__all__ = ["AdamWConfig", "AdamState", "init_state", "apply_updates",
           "schedule", "global_norm", "clip_by_global_norm"]
