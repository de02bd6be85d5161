"""Training loop (the port of the reference's ``train/trainer.py``).

A step is eager PyTorch (the reference jits it): the forward through an
``LM`` bound to the parameter tree (``lm.bind_params``), the backward by
``torch.autograd.grad`` under the model's matmul numerics (bf16 GEMMs
reduced in float32, no TF32, in the backward too), the per-layer
gradients stacked into the reference's layout, optional NUMARCK gradient
compression (the histogram kernel once per leaf on the card), and AdamW.

The state is the reference's: ``TrainState.tree()`` gives its keys,
shapes and dtypes (``params/layers/attn/wq`` (L, d, H, hd),
``opt_state/.m/...``, ``opt_state/.step``, ``gc_state/.residual/...``),
so a checkpoint of either package's trainer restores in the other's.
The parameters, the moments and the residual are kept in that stacked
layout throughout and updated in place; nothing is stacked at save
time.

Checkpointing goes through ``CheckpointManager`` (NUMARCK anchors and
deltas every ``checkpoint_every`` steps), and ``restore_or_init``
restarts from the newest valid checkpoint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.chain import resolve_device
from repro_torch.core.tree import map_with_keys
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.model import Model
from repro_torch.train import gradcomp, optim


@dataclass
class TrainerConfig:
    opt: optim.AdamWConfig = field(default_factory=optim.AdamWConfig)
    grad_compression_bits: int = 0        # 0 = off
    log_every: int = 10
    watchdog_factor: float = 5.0          # step > factor * median -> flag
    checkpoint_every: int = 0             # steps; 0 = off


class TrainState:
    def __init__(self, params, opt_state, gc_state=None):
        self.params = params              # the reference's layout
        self.opt_state = opt_state
        self.gc_state = gc_state

    def tree(self):
        t = {"params": self.params, "opt_state": self.opt_state}
        if self.gc_state is not None:
            t["gc_state"] = self.gc_state
        return t


def loss_and_grads(model: Model, params, batch):
    """(loss, metrics, grads) of one batch: the total loss, the model's
    {"loss", "aux"} (detached) and the gradients in the reference's
    layout, each in its parameter's dtype."""
    module = lm.bind_params(params, model.cfg)
    names, leaves = zip(*module.named_parameters())
    with L.matmul_numerics():
        loss, metrics = model.loss(module, batch)
        # an unused leaf (musicgen's token table under frame embeds)
        # gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        lm.stack_layers(zip(names, grads))


def make_train_step(model: Model, tcfg: TrainerConfig) -> Callable:
    """(params, opt_state, gc_state, batch) -> (params, opt_state,
    gc_state, metrics), the state's tensors updated in place."""

    def step(params, opt_state, gc_state, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        if tcfg.grad_compression_bits:
            grads, gc_state = gradcomp.compress_grads(
                grads, gc_state, b_bits=tcfg.grad_compression_bits)
        params, opt_state, om = optim.apply_updates(params, grads,
                                                    opt_state, tcfg.opt)
        metrics = dict(metrics, **om, loss=loss)
        return params, opt_state, gc_state, metrics

    return step


class Trainer:
    def __init__(self, model: Model, tcfg: TrainerConfig = TrainerConfig(),
                 checkpoint_manager=None, device=None):
        """Trains on `device` (CUDA unless the caller asks for another)."""
        self.model = model
        self.tcfg = tcfg
        self.ckpt = checkpoint_manager
        self.device = resolve_device(device)
        self._step_fn = make_train_step(model, tcfg)
        self._times: list = []
        self.straggler_events = 0

    def _state(self, params) -> TrainState:
        return TrainState(params, optim.init_state(params),
                          gradcomp.init_state(params)
                          if self.tcfg.grad_compression_bits else None)

    def init_state(self, seed=0) -> TrainState:
        """Fresh parameters from ``Model.init(seed)`` (torch's draws),
        zero moments and residual, on the trainer's device."""
        return self._state(lm.param_tree(self.model.init(seed, self.device)))

    def restore_or_init(self, seed=0) -> tuple:
        """(state, start_step); restores from the checkpoint manager if a
        valid checkpoint exists (fault-tolerant restart path)."""
        if self.ckpt is not None:
            template = self._state(lm.param_tree(
                lm.LM(self.model.cfg, "meta"))).tree()
            restored = self.ckpt.restore_latest(template=template)
            if restored is not None:
                step, tree = restored
                tree = map_with_keys(lambda _, t: t.to(self.device), tree)
                return TrainState(tree["params"], tree["opt_state"],
                                  tree.get("gc_state")), step
        return self.init_state(seed), 0

    def _watchdog(self, dt: float):
        """Step-time watchdog: deterministic data + even sharding means a
        slow step signals an infrastructure straggler.  On a real fleet this
        hooks the preemption/replacement API; here we count + log."""
        self._times.append(dt)
        hist = self._times[-50:]
        med = float(np.median(hist))
        if len(hist) >= 10 and dt > self.tcfg.watchdog_factor * med:
            self.straggler_events += 1
            return True
        return False

    def fit(self, state: TrainState, batches, start_step: int = 0,
            n_steps: Optional[int] = None, log: Callable = print):
        """Train on `batches` (dicts of numpy arrays, moved to the
        trainer's device) until `n_steps`; returns (state, step, losses).
        Each step syncs once, for its loss."""
        step = start_step
        history = []
        for batch in batches:
            if n_steps is not None and step >= n_steps:
                break
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batch.items()}
            (state.params, state.opt_state, state.gc_state,
             metrics) = self._step_fn(state.params, state.opt_state,
                                      state.gc_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = self._watchdog(dt)
            step += 1
            history.append(loss)
            if step % self.tcfg.log_every == 0:
                log(f"step {step} loss {loss:.4f} "
                    f"gnorm {float(metrics['grad_norm']):.3f} "
                    f"dt {dt*1e3:.1f}ms" + (" [straggler]" if slow else ""))
            if (self.ckpt is not None and self.tcfg.checkpoint_every
                    and step % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(step, state.tree())
        return state, step, history


__all__ = ["Trainer", "TrainerConfig", "TrainState", "loss_and_grads",
           "make_train_step"]
