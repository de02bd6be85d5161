"""Decoder-only LM assembly: the dense and MoE families with GQA or MLA
attention, the SSM (SSD) family and the hybrid family, whose layers run
attention and SSD side by side (the port of the reference's
``models/lm.py``).

The parameters are one ``LM`` module: ``embed`` (V, d), ``ln_f``, one
``Layer`` per decoder layer (the reference's keys: ``ln_attn``,
``attn``, ``ln_ssm`` (SSM only), ``ssm``, ``ln_attn_out`` and
``ln_ssm_out`` (hybrid), ``ln_mlp``, ``mlp``) and, untied, ``unembed``
(d, V).  The reference stacks the layers on a leading L axis and scans
them; here a Python loop runs them in turn
(``interop.model_params_from_reference`` unstacks a reference tree).

The decode cache keeps the reference's stacked layout, so a session file
carries its keys, shapes and dtypes: ``{"attn": {"k": (L,B,S,K,hd), "v":
..., "pos_map": (L,S) int32}}`` (a per-layer list for mixed-window
stacks, hymba's among them), for MLA the latent ``{"attn": {"ckv":
(L,B,S,kv_lora), "krope": (L,B,S,qk_rope), "pos_map": (L,S)}}``, and
for an SSD layer the float32 recurrent state ``{"ssm": {"conv":
(L,B,w-1,din+2N), "h": (L,B,nh,hd,N)}}`` beside it.  Each layer's decode
writes its slice of the cache in place.

Training keeps the parameters in the reference's layout (``param_tree``:
nested dicts by the reference's keys, the layers stacked on a leading L
axis), the layout its optimizer, gradient compression and checkpoints
work on; ``bind_params`` gives the forward an ``LM`` whose parameters
are views of those stacked tensors, and ``stack_layers`` stacks the
per-layer gradients back.  ``lm_loss`` is the reference's cross-entropy
plus the MoE layers' load-balance loss; ``remat="block"`` recomputes
each layer in the backward (``torch.utils.checkpoint``).

Every layer window is a Python int, so ``chunked_sdpa`` skips the fully
masked blocks of hymba's sliding-window layers too, where the reference
traces mixed windows and visits every block (the skipped blocks add
exactly nothing).  ``shd.constrain`` sits where the reference's does,
on the residual stream of every layer and on the loss's logits; on
plain tensors it is the identity, and only the dry run's DTensors are
redistributed.

The frontends are stubs, as in the reference: paligemma (``family ==
"vlm"``) takes ``n_prefix`` precomputed patch embeddings ahead of its
text tokens, attended under the prefix-LM mask and scaled with the
token embeddings by ``d_model**0.5`` rounded to the compute dtype;
musicgen (``frontend == "frames"``) takes frame embeddings in place of
tokens.  One deliberate divergence: ``decode_step(token=)`` of a vlm
scales the token's embedding as ``embed_inputs`` does, where the
reference's ``decode_step`` leaves it unscaled (ROADMAP Queue 3); an
``embed=`` input is used as given in both.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import leaves_with_keys, nest
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig


class Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        if cfg.n_heads:
            self.ln_attn = L.RMSNorm(d, device)
            self.attn = (L.MLA(cfg, device) if cfg.attn_kind == "mla"
                         else L.GQA(cfg, device))
        if cfg.ssm_state:
            if not cfg.n_heads:
                self.ln_ssm = L.RMSNorm(d, device)
            self.ssm = S.SSD(cfg, device)
            if cfg.family == "hybrid":
                self.ln_attn_out = L.RMSNorm(d, device)
                self.ln_ssm_out = L.RMSNorm(d, device)
        if cfg.d_ff:
            self.ln_mlp = L.RMSNorm(d, device)
            self.mlp = (L.MoE(cfg, device) if cfg.n_experts
                        else L.FFN(cfg, device))


class LM(nn.Module):
    """The model's parameters, with the reference's names and shapes."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = L.cdtype(cfg)
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt,
                        device=device), requires_grad=False)
        self.ln_f = L.RMSNorm(cfg.d_model, device)
        self.layers = nn.ModuleList(Layer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                torch.empty((cfg.d_model, cfg.vocab_size), dtype=dt,
                            device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> LM:
    """Random weights at the reference's scales, drawn from `gen` (a
    generator on `device`): embed N(0, 0.02), dense weights fan-in^-1/2,
    ``wo`` (H*hd)^-1/2, untied unembed d^-1/2, biases 0, norm scales 1,
    the SSD's values as ``ssm.ssd_init`` gives them.  Drawn in float32
    one layer's weight at a time and stored in ``cfg.dtype``; norm
    scales stay float32.  The draws are torch's, not
    jax's: only the scales match."""
    p = LM(cfg, device)
    p.embed.copy_(torch.randn(p.embed.shape, generator=gen,
                              dtype=torch.float32, device=device) * 0.02)
    for layer in p.layers:
        if cfg.n_heads:
            (L.mla_init if cfg.attn_kind == "mla" else L.gqa_init)(
                layer.attn, gen)
        if cfg.ssm_state:
            S.ssd_init(layer.ssm, gen)
        if cfg.d_ff:
            (L.moe_init if cfg.n_experts else L.ffn_init)(layer.mlp, gen)
    if not cfg.tie_embeddings:
        p.unembed.copy_(torch.randn(p.unembed.shape, generator=gen,
                                    dtype=torch.float32, device=device)
                        * cfg.d_model ** -0.5)
    return p


def layer_flags(cfg: ModelConfig):
    """(L,) int32 per-layer attention window (0 = global), on the host."""
    if not cfg.sliding_window:
        return np.zeros((cfg.n_layers,), np.int32)
    w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    for g in cfg.global_attn_layers:
        w[g] = 0
    return w


def _whole_seq(t):
    """A block's normed input or output with its sequence whole.  Under
    shard_seq (Megatron sequence parallelism) a DTensor residual is
    sharded over the sequence, and the matmuls take it gathered, as in
    Megatron; on the output too, so that the backward's gradients meet
    the matmuls in that layout (the identity on plain tensors, and a
    no-op redistribution without shard_seq)."""
    return shd.constrain(t, "dp", None, None)


def _norm_in(p, x, eps):
    return _whole_seq(L.rms_norm(p, x, eps))


# ---------------------------------------------------------------------------
# one layer, prefill form
# ---------------------------------------------------------------------------

def _attn_block(p, x, cfg: ModelConfig, positions, window: int):
    """-> (out, (k, v)) for GQA, (out, (c_kv, k_rope)) for MLA."""
    h = _norm_in(p.ln_attn, x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        return L.mla_apply(p.attn, h, cfg=cfg, positions=positions,
                           prefix=cfg.n_prefix)
    return L.gqa_apply(p.attn, h, cfg=cfg, positions=positions,
                       window=window, prefix=cfg.n_prefix,
                       has_window=bool(cfg.sliding_window))


def _mlp_block(p, x, cfg: ModelConfig, a_out=None):
    """The residual add of the attention's output `a_out` (if any) and the
    FFN or MoE block after it -> (x', the MoE's aux loss or None)."""
    if a_out is not None:
        x = x + _whole_seq(a_out)
    if not cfg.d_ff:
        return x, None
    h = _norm_in(p.ln_mlp, x, cfg.norm_eps)
    if cfg.n_experts:
        m_out, aux = L.moe_apply(p.mlp, h, cfg=cfg)
        return x + _whole_seq(m_out), aux
    return x + _whole_seq(L.ffn_apply(p.mlp, h)), None


def _ssm_branch(p, h, cfg: ModelConfig, valid_len, with_cache: bool):
    """The SSD on the normed input `h` -> (out, its decode cache or None):
    the prefill's ``ssd_prefill_cache`` (run without `valid_len`, as the
    reference runs it) or the forward's ``ssd_apply``."""
    if with_cache:
        return S.ssd_prefill_cache(p.ssm, h, cfg=cfg)
    return S.ssd_apply(p.ssm, h, cfg=cfg, valid_len=valid_len)[0], None


def _mixer(p, x, cfg: ModelConfig, positions, window: int, valid_len=None,
           with_cache: bool = False):
    """The layer's token mixer -> (out or None, the attention's (k, v) or
    MLA's latents or None, the SSD's decode cache or None).  Hybrid runs
    attention and SSD on the same normed input, normalises each branch's
    output and averages them."""
    if cfg.family == "hybrid":
        h = _norm_in(p.ln_attn, x, cfg.norm_eps)
        a_out, kv = L.gqa_apply(p.attn, h, cfg=cfg, positions=positions,
                                window=window, prefix=cfg.n_prefix,
                                has_window=bool(cfg.sliding_window))
        s_out, sc = _ssm_branch(p, h, cfg, valid_len, with_cache)
        a_out = L.rms_norm(p.ln_attn_out, a_out, cfg.norm_eps)
        s_out = L.rms_norm(p.ln_ssm_out, s_out, cfg.norm_eps)
        return 0.5 * (a_out + s_out), kv, sc
    if cfg.n_heads:
        a_out, kv = _attn_block(p, x, cfg, positions, window)
        return a_out, kv, None
    if cfg.ssm_state:
        h = _norm_in(p.ln_ssm, x, cfg.norm_eps)
        s_out, sc = _ssm_branch(p, h, cfg, valid_len, with_cache)
        return s_out, None, sc
    return None, None, None


def layer_apply(p, x, *, cfg: ModelConfig, positions, window: int,
                valid_len=None):
    """x (B,T,d) -> (x', aux_loss); the token mixer (attention, SSD or
    both) and the FFN branch.  `valid_len`: the SSD's state ignores the
    positions from it on."""
    a_out, _, _ = _mixer(p, x, cfg, positions, window, valid_len)
    x, aux = _mlp_block(p, x, cfg, a_out)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# backbone forward (prefill logits)
# ---------------------------------------------------------------------------

def embed_inputs(params: LM, cfg: ModelConfig, tokens=None,
                 extra_embeds=None):
    """Token embeddings (B, T, d) in the compute dtype, prefixed with the
    frontend's embeddings `extra_embeds` (B, P, d) where given; a vlm's
    are scaled by ``d_model**0.5`` rounded to the compute dtype (the
    reference's ``jnp.asarray(d_model**0.5, dt)``: 45.25 in bfloat16 at
    d = 2048)."""
    dt = L.cdtype(cfg)
    parts = []
    if extra_embeds is not None:
        parts.append(extra_embeds.to(dt))
    if tokens is not None:
        table = params.embed.to(dt)
        if isinstance(table, DTensor):
            # gathered (FSDP), and looked up by the embedding op, whose
            # sharding rules DTensor has in every version
            table = shd.constrain(table, None, None)
            parts.append(torch.nn.functional.embedding(tokens, table))
        else:
            parts.append(table[tokens])
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if cfg.family == "vlm":
        x = x * L._weak_scalar(cfg.d_model ** 0.5, dt)
    return x


def unembed(params: LM, cfg: ModelConfig, x, table=None):
    """f32 logits of `x`; a tied model reads `table` where the caller
    passes a view of its token table (``forward``), else the table."""
    if cfg.tie_embeddings:
        w = (params.embed if table is None else table).t()
    else:
        w = params.unembed
    w = w.to(x.dtype)
    return torch.matmul(x, w).to(torch.float32)


def forward(params: LM, cfg: ModelConfig, tokens=None, extra_embeds=None,
            valid_len=None):
    """-> (logits (B,T,V) f32, aux_loss) over the frontend's embeddings
    and the tokens (``embed_inputs``).  Builds a graph only for
    parameters that require grad (training's ``bind_params``).
    `valid_len` goes to every SSD layer (``ssm.ssd_apply``)."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    with L.matmul_numerics():
        x = embed_inputs(params, cfg, tokens, extra_embeds)
        T = x.shape[1]
        positions = torch.arange(T, dtype=torch.int32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params.layers, layer_flags(cfg)):
            # residual stream: batch over dp; sequence over tp when
            # shard_seq (Megatron-style sequence parallelism)
            x = shd.constrain(x, "dp", "seq", None)
            kw = dict(cfg=cfg, positions=positions, window=int(w),
                      valid_len=valid_len)
            if remat:
                # keep the layer's input, recompute its inside in the
                # backward (the reference saves only "block_out")
                x, a = checkpoint(layer_apply, lp, x, use_reentrant=False,
                                  **kw)
            else:
                x, a = layer_apply(lp, x, **kw)
            aux = aux + a
        x = _norm_in(params.ln_f, x, cfg.norm_eps)
        # A tied DTensor table reaches the unembedding through a
        # redistribute of its own, as it reaches the lookup (gathered over
        # dp, the vocabulary over tp: the layout DTensor's matmul picks).
        # Each redistribute's backward returns its gradient in the table's
        # own placements, so the two gradients add with no redistribute:
        # torch 2.11's DTensor cannot plan their sum when one arrives
        # Partial and the other sharded (Shard -> Partial).
        table = (shd.constrain(params.embed, "tp!", None)
                 if cfg.tie_embeddings else None)
        return unembed(params, cfg, x, table), aux


def lm_loss(params: LM, cfg: ModelConfig, batch):
    """Cross-entropy over next-token labels; labels == -100 are masked.
    batch: "labels" (B, T_lab) and "tokens" and/or "embeds" (B, P, d) on
    the params' device; the labels cover the last T_lab positions (a
    patch prefix carries none).  -> (loss + 0.01 * aux / L, {"loss",
    "aux"})."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          batch.get("embeds"))
    logits = shd.constrain(logits, "dp", None, "tp")   # vocab-sharded CE
    labels = batch["labels"].to(torch.int64)
    logits = logits[:, -labels.shape[1]:]
    mask = labels != -100
    labels_safe = torch.where(mask, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1)
    return loss + 0.01 * aux / max(cfg.n_layers, 1), {
        "loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# the reference's parameter layout (training)
# ---------------------------------------------------------------------------

def reference_key(name: str) -> str:
    """The reference tree's key of one of the port's parameter names:
    ``layers.3.attn.wq`` is layer 3 of ``layers/attn/wq``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:])
    return "/".join(parts)


def stack_layers(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """The reference's layout of (name, tensor) pairs in the order of an
    ``LM``'s ``named_parameters()`` (its parameters, or values aligned
    with them such as their gradients): nested dicts by reference key,
    each layer leaf the layers' tensors stacked on a leading L axis (a
    copy)."""
    groups: Dict[str, list] = {}
    for name, t in named:
        groups.setdefault(reference_key(name), []).append(t)
    return nest({k: torch.stack(v) if k.startswith("layers/") else v[0]
                 for k, v in groups.items()})


@torch.no_grad()
def param_tree(params: LM) -> Dict:
    """A copy of the module's parameters in the reference's layout."""
    return stack_layers(params.named_parameters())


def bind_params(tree, cfg: ModelConfig) -> LM:
    """An ``LM`` whose parameters are views of `tree`'s tensors (the
    reference's layout): layer i's ``attn.wq`` is
    ``tree["layers"]["attn"]["wq"][i]``, sharing its storage, so an
    update of the tree in place is the module's too.  They require
    grad: the forward builds a graph to them."""
    flat = dict(leaves_with_keys(tree))
    p = LM(cfg, "meta")
    for name, meta in list(p.named_parameters()):
        t = flat[reference_key(name)]
        if name.startswith("layers."):
            t = t[int(name.split(".")[1])]
        if tuple(t.shape) != tuple(meta.shape) or t.dtype != meta.dtype:
            raise ValueError(f"{reference_key(name)}: {tuple(t.shape)} "
                             f"{t.dtype} does not fit {name} "
                             f"{tuple(meta.shape)} {meta.dtype}")
        owner, _, attr = name.rpartition(".")
        setattr(p.get_submodule(owner), attr,
                nn.Parameter(t))
    return p


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _attn_cache_spec(cfg: ModelConfig, window: int, batch, s_max, dtype,
                     device):
    if cfg.attn_kind == "mla":
        return L.mla_empty_cache(cfg, batch, s_max, dtype, device)
    return L.gqa_empty_cache(cfg, batch, s_max, window, dtype, device)


def _one_cache(cfg: ModelConfig, window: int, batch, s_max, device):
    """One layer's zeroed cache: {"attn"?, "ssm"?}."""
    c = {}
    if cfg.n_heads:
        c["attn"] = _attn_cache_spec(cfg, window, batch, s_max,
                                     L.cdtype(cfg), device)
    if cfg.ssm_state:
        c["ssm"] = S.ssd_empty_cache(cfg, batch, device)
    return c


def empty_cache(cfg: ModelConfig, batch, s_max, stacked: bool = True,
                device=None):
    """Decode cache.  stacked=True -> leading L axis (uniform windows)."""
    windows = [int(w) for w in layer_flags(cfg)]
    if stacked:
        one = _one_cache(cfg, windows[0], batch, s_max, device)
        return {g: {k: torch.stack([v] * cfg.n_layers)
                    for k, v in leaves.items()}
                for g, leaves in one.items()}
    return [_one_cache(cfg, w, batch, s_max, device) for w in windows]


def uses_layer_loop(cfg: ModelConfig) -> bool:
    """Heterogeneous caches (mixed SWA/global) -> a per-layer cache list."""
    return bool(cfg.global_attn_layers)


def _layer_cache(cache, i: int):
    """Layer i's cache, as views into the stacked tensors."""
    if isinstance(cache, list):
        return cache[i]
    return {g: {k: v[i] for k, v in leaves.items()}
            for g, leaves in cache.items()}


def layer_decode(p, x, cache, *, cfg: ModelConfig, pos, window: int,
                 prefix: int = 0):
    """One layer, one token.  cache: {"attn"?, "ssm"?} for this layer,
    updated in place."""
    a_out = None
    if cfg.family == "hybrid":
        h = L.rms_norm(p.ln_attn, x, cfg.norm_eps)
        a, _ = L.gqa_decode(p.attn, h, cache["attn"], cfg=cfg, pos=pos,
                            window=window, prefix=prefix)
        s, _ = S.ssd_decode(p.ssm, h, cache["ssm"], cfg=cfg)
        a_out = 0.5 * (L.rms_norm(p.ln_attn_out, a, cfg.norm_eps)
                       + L.rms_norm(p.ln_ssm_out, s, cfg.norm_eps))
    elif cfg.ssm_state:
        h = L.rms_norm(p.ln_ssm, x, cfg.norm_eps)
        a_out, _ = S.ssd_decode(p.ssm, h, cache["ssm"], cfg=cfg)
    elif cfg.n_heads:
        h = L.rms_norm(p.ln_attn, x, cfg.norm_eps)
        if cfg.attn_kind == "mla":
            a_out, _ = L.mla_decode(p.attn, h, cache["attn"], cfg=cfg,
                                    pos=pos)
        else:
            a_out, _ = L.gqa_decode(p.attn, h, cache["attn"], cfg=cfg,
                                    pos=pos, window=window, prefix=prefix)
    x, _ = _mlp_block(p, x, cfg, a_out)     # MoE at T = 1: capacity 1
    return x, cache


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache, token=None, pos=None,
                embed=None):
    """One new token for the whole batch.

    token (B,1) int, or `embed` (B,1,d) for the frontend archs (used as
    given, unscaled, as in the reference); pos a 0-d int32 tensor
    (absolute position); cache as from `empty_cache`/`prefill`, written
    in place.  A vlm's token goes through ``embed_inputs`` and is scaled
    as in the prefill (the reference's token path leaves it unscaled).
    Returns (logits (B,1,V) f32, cache).
    """
    with L.matmul_numerics():
        x = (embed.to(L.cdtype(cfg)) if embed is not None
             else embed_inputs(params, cfg, token))
        windows = layer_flags(cfg)
        for i, lp in enumerate(params.layers):
            x, _ = layer_decode(lp, x, _layer_cache(cache, i), cfg=cfg,
                                pos=pos, window=int(windows[i]),
                                prefix=cfg.n_prefix)
        x = L.rms_norm(params.ln_f, x, cfg.norm_eps)
        return unembed(params, cfg, x), cache


@torch.no_grad()
def prefill(params: LM, cfg: ModelConfig, tokens=None, extra_embeds=None,
            s_max: Optional[int] = None):
    """Full forward over the frontend's embeddings and the tokens + build
    the decode cache.

    Returns (logits_last (B,1,V), cache, next_pos 0-d int32).
    """
    with L.matmul_numerics():
        dt = L.cdtype(cfg)
        x = embed_inputs(params, cfg, tokens, extra_embeds)
        B, T, _ = x.shape
        s_max = s_max or T
        dev = x.device
        positions = torch.arange(T, dtype=torch.int32, device=dev)
        windows = [int(w) for w in layer_flags(cfg)]
        stacked = not uses_layer_loop(cfg)
        cache = empty_cache(cfg, B, s_max, stacked=stacked, device=dev)
        if isinstance(x, DTensor):
            cache = shd.place_cache(cache, stacked)
        for i, lp in enumerate(params.layers):
            a_out, kv, sc = _mixer(lp, x, cfg, positions, windows[i],
                                   with_cache=True)
            c = _layer_cache(cache, i)
            if kv is not None and cfg.attn_kind == "mla":
                _mla_to_cache(c["attn"], *kv, T, dt)
            elif kv is not None:
                _kv_to_cache(c["attn"], *kv, T, windows[i], dt)
            if sc is not None:
                for k, v in sc.items():
                    c["ssm"][k].copy_(v)
            x, _ = _mlp_block(lp, x, cfg, a_out)
        x = L.rms_norm(params.ln_f, x[:, -1:, :], cfg.norm_eps)
        logits = unembed(params, cfg, x)
        return logits, cache, torch.tensor(T, dtype=torch.int32, device=dev)


def _kv_to_cache(c, k, v, T: int, window: int, dt) -> None:
    """Prefill K/V (B,T,K,hd) -> the layer's decode cache `c` (its
    zeroed tensors, written in place; a ring for SWA)."""
    ring = c["k"].shape[1]
    dev = k.device
    if window and T > ring:
        # keep the trailing `ring` positions, placed at their ring slots
        keep = torch.arange(T - ring, T, dtype=torch.int32, device=dev)
        slots = (keep % ring).to(torch.int64)
        L.write_slots(c["k"], 1, slots, k[:, -ring:].to(dt))
        L.write_slots(c["v"], 1, slots, v[:, -ring:].to(dt))
        L.write_slots(c["pos_map"], 0, slots, keep)
    else:
        c["k"][:, :T] = k.to(dt)
        c["v"][:, :T] = v.to(dt)
        c["pos_map"][:T] = torch.arange(T, dtype=torch.int32, device=dev)


def _mla_to_cache(c, ckv, krope, T: int, dt) -> None:
    """Prefill latents (B,T,kv_lora) and roped keys (B,T,qk_rope) -> the
    layer's MLA cache `c` (its zeroed tensors, written in place)."""
    c["ckv"][:, :T] = ckv.to(dt)
    c["krope"][:, :T] = krope.to(dt)
    c["pos_map"][:T] = torch.arange(T, dtype=torch.int32, device=ckv.device)


__all__ = ["LM", "Layer", "init_params", "layer_flags", "layer_apply",
           "embed_inputs", "forward", "lm_loss", "reference_key",
           "stack_layers", "param_tree", "bind_params", "unembed",
           "empty_cache", "uses_layer_loop", "layer_decode", "decode_step",
           "prefill"]
