"""Public model API: --arch <id> -> Model(init/loss/forward/prefill/decode)
(the port of the reference's ``models/model.py``: the dense and MoE
families with GQA or MLA attention, the SSM family, the hybrid family
and the two frontend families, paligemma's patch and musicgen's frame
embeddings).

The model runs on the CUDA device unless the caller passes
``device="cpu"``; without a GPU a CUDA device raises.  Its parameters
never require grad, so serving builds no graph; training binds views of
the reference-layout tree that do (``lm.bind_params``).
``shape_params`` gives the parameter tree's shapes on "meta"; the
reference's dry-run stand-in ``input_specs`` comes with the dry run.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.chain import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig

# What the port does not have yet, and where the ROADMAP queues it:
# (test of a config, what it needs, the item).  Every family of the
# reference is ported.
_UNPORTED = ()


def check_supported(cfg: ModelConfig) -> None:
    for test, what, item in _UNPORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name} needs {what}, not yet ported to PyTorch "
                f"({item})")


class Model:
    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg

    # ---- parameters ------------------------------------------------------
    def init(self, generator: Union[int, torch.Generator] = 0,
             device=None) -> lm.LM:
        """Random parameters on `device` (CUDA unless the caller asks for
        another) from a seeded generator: an int seeds a new one."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(generator)
        return lm.init_params(generator, self.cfg, dev)

    def shape_params(self) -> Dict:
        """The parameter tree in the reference's layout (``lm.param_tree``:
        its keys, the layers stacked) as "meta" tensors: shapes and
        dtypes, nothing allocated."""
        return lm.param_tree(lm.LM(self.cfg, "meta"))

    def param_count(self) -> int:
        """Elements of every parameter (shapes only; nothing allocated)."""
        return sum(p.numel() for p in lm.LM(self.cfg, "meta").parameters())

    # ---- steps -----------------------------------------------------------
    def loss(self, params, batch):
        """(loss, {"loss", "aux"}); a graph to `params` where they require
        grad (``lm.bind_params``)."""
        return lm.lm_loss(params, self.cfg, batch)

    def forward(self, params, batch):
        return lm.forward(params, self.cfg, tokens=batch.get("tokens"),
                          extra_embeds=batch.get("embeds"))

    def prefill(self, params, batch, s_max: Optional[int] = None):
        return lm.prefill(params, self.cfg, tokens=batch.get("tokens"),
                          extra_embeds=batch.get("embeds"), s_max=s_max)

    def decode(self, params, cache, token=None, pos=None, embed=None):
        return lm.decode_step(params, self.cfg, cache, token=token, pos=pos,
                              embed=embed)

    def empty_cache(self, batch, s_max, device=None):
        return lm.empty_cache(self.cfg, batch, s_max,
                              stacked=not lm.uses_layer_loop(self.cfg),
                              device=resolve_device(device))

    # ---- concrete sample batches (smoke tests / examples) -----------------
    def sample_batch(self, generator: torch.Generator, batch_size: int,
                     seq_len: int) -> Dict[str, torch.Tensor]:
        """The reference's shapes on the generator's device: {tokens,
        labels} (B, S) int64; for frames {embeds (B, S, d), labels (B,
        S)}; for patches {embeds (B, n_prefix, d), tokens and labels (B,
        S - n_prefix)}; embeds standard normal in ``cfg.dtype``."""
        cfg = self.cfg
        kw = dict(generator=generator, device=generator.device)
        B, V = batch_size, cfg.vocab_size
        n_text = seq_len - (cfg.n_prefix if cfg.frontend == "patches"
                            else 0)
        dt = getattr(torch, cfg.dtype)
        batch = {}
        if cfg.frontend == "frames":
            batch["embeds"] = torch.randn((B, seq_len, cfg.d_model),
                                          dtype=dt, **kw)
        elif cfg.frontend == "patches":
            batch["embeds"] = torch.randn((B, cfg.n_prefix, cfg.d_model),
                                          dtype=dt, **kw)
        if cfg.frontend != "frames":
            batch["tokens"] = torch.randint(0, V, (B, n_text), **kw)
        batch["labels"] = torch.randint(0, V, (B, n_text), **kw)
        return batch


def build(arch_id: str, smoke: bool = False) -> Model:
    from repro_torch.configs import get_config, get_smoke_config
    return Model(get_smoke_config(arch_id) if smoke else get_config(arch_id))


__all__ = ["Model", "build", "check_supported"]
