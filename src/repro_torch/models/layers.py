"""Transformer building blocks: norms, RoPE, GQA/SWA and MLA attention,
the SwiGLU FFN and the MoE FFN (the port of the reference's
``models/layers.py``).

Parameters live in ``nn.Module``s with the reference's shapes (``wq``
(d, H, hd), ``wo`` (H, hd, d), ...), stored in ``cfg.dtype`` with norm
scales in float32 as the reference stores them; the functions take a
module and tensors.  Softmax and norms accumulate in float32, and every
formula keeps the reference's order of operations: ``chunked_sdpa``
multiplies by ``hd**-0.5`` where decode's ``_sdpa`` divides by
``hd**0.5``, masks are ``-inf`` in one and ``NEG_INF`` in the other.
``chunked_sdpa``'s scale is rounded to the compute dtype (jax's weak
typing) and applied in float32 to the rounded scores, as XLA fuses the
reference's compiled block loop; at MLA's head dim of 96 the bfloat16
scale is not the float32 one.

Decode caches (the reference's layout, so session files carry its keys):
  * full attention -- (B, S_max, K, hd) written at `pos` (the start
    clamped to S_max - 1, as ``dynamic_update_slice`` clamps it)
  * sliding window -- ring buffer of W slots + `pos_map` of absolute
    positions (RoPE is applied pre-cache at absolute positions)
  * MLA -- compressed latent ``ckv`` (B, S_max, kv_lora) + shared roped
    key ``krope`` (B, S_max, r), written at the clamped `pos`
Unlike the reference's functional update, ``gqa_decode`` and
``mla_decode`` write the new slot into the cache tensors in place.

Sharding constraints (``shd.constrain``) sit where the reference's do,
on the MoE's dispatch and expert buffers, and where DTensor needs a
layout the reference's GSPMD finds itself: the projections' weights
(gathered over dp) and outputs, and attention's inputs.  Each is the
identity on plain tensors, which is how the model runs outside the dry
run (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@contextlib.contextmanager
def matmul_numerics():
    """The matmul settings the model runs under: float32 products in full
    float32 (no TF32) and bfloat16 products reduced in float32 (PyTorch
    allows reduced-precision bf16 reductions by default; XLA accumulates
    bf16 dots in float32).  Set around every model entry point and
    restored after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _weight(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, gen: torch.Generator, scale=None) -> None:
    """The reference's ``_dense_init``: N(0, 1) * fan_in^-1/2 (or
    `scale`) drawn in float32, then cast to the weight's dtype."""
    shape = tuple(w.shape)
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    scale = scale if scale is not None else fan_in ** -0.5
    w.copy_(torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=w.device) * scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)


def rms_norm(p, x, eps):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split / llama style)
# ---------------------------------------------------------------------------

def rope_tables(positions, dim, theta):
    """positions (T,) int -> cos/sin (T, dim/2) f32."""
    ar = torch.arange(0, dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv = 1.0 / (theta ** (ar / dim))
    ang = positions.to(torch.float32)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., T, H, dim); cos/sin (T, dim/2), cast to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _weak_scalar(value: float, dtype: torch.dtype) -> float:
    """A Python float as jax's weak typing applies it to a `dtype` tensor:
    rounded to `dtype`.  Exact in float32, so a float32 product by it is
    the product by the rounded constant."""
    return torch.tensor(value, dtype=dtype).item()


def causal_mask(q_pos, kv_pos, window: int = 0, prefix: int = 0,
                has_window: bool = False):
    """(Tq, Tk) bool: True = attend.  window == 0 means full causal;
    prefix > 0 makes the first `prefix` kv positions visible to all."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if has_window and window:
        m &= kv_pos[None, :] > (q_pos[:, None] - window)
    if prefix:
        m |= kv_pos[None, :] < prefix
    return m


def chunked_sdpa(q, k, v, *, q_pos, kv_pos, window: int = 0, prefix=0,
                 has_window=False, n_rep=1, q_block=512, kv_block=1024,
                 block_skip=False):
    """Blockwise online-softmax attention (the reference's flash-style
    ``chunked_sdpa``): a loop over query blocks, an inner loop over kv
    blocks carrying (m, lse, acc) running statistics, never the (T, S)
    score matrix.

    block_skip: when q/kv positions are the aligned 0..T-1 prefill layout
    each query block visits only the kv blocks inside its causal (and
    SWA) band, as in the reference (blocks outside it are fully masked
    and would add exactly nothing).  `window` is a Python int here, also
    for hymba's mixed windows, which the reference traces and does not
    skip.

    q (B,T,H,hd), k (B,S,K,hd), v (B,S,K,hdv); H = K * n_rep.
    Returns (B,T,H,hdv).  DTensor inputs run on their local shards
    (``_on_shards``).
    """
    if isinstance(q, DTensor):
        return _on_shards(
            chunked_sdpa, q, k, v, q_pos=q_pos, kv_pos=kv_pos, window=window,
            prefix=prefix, has_window=has_window, n_rep=n_rep,
            q_block=q_block, kv_block=kv_block, block_skip=block_skip)
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    qb = min(q_block, T)
    kb = min(kv_block, S)
    Tp, Sp = -(-T // qb) * qb, -(-S // kb) * kb
    dev = q.device

    def pad(x, n):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))

    q, k, v = pad(q, Tp - T), pad(k, Sp - S), pad(v, Sp - S)
    q_pos = torch.cat([q_pos, torch.full((Tp - T,), -2, dtype=q_pos.dtype,
                                         device=dev)])    # masked rows
    kv_pos = torch.cat([kv_pos, torch.full((Sp - S,), 1 << 30,
                                           dtype=kv_pos.dtype, device=dev)])

    qs = q.reshape(B, Tp // qb, qb, K, n_rep, hd).movedim(1, 0)
    ks = k.reshape(B, Sp // kb, kb, K, hd).movedim(1, 0)
    vs = v.reshape(B, Sp // kb, kb, K, hdv).movedim(1, 0)
    qps = q_pos.reshape(Tp // qb, qb)
    kps = kv_pos.reshape(Sp // kb, kb)
    scale = _weak_scalar(hd ** -0.5, q.dtype)

    def q_block_out(qi, kv_blocks):
        """One query block over the kv blocks `kv_blocks`."""
        qblk, qp = qs[qi], qps[qi]
        m = torch.full((B, K, n_rep, qb), -1e30, dtype=torch.float32,
                       device=dev)
        lse = torch.zeros((B, K, n_rep, qb), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((B, K, n_rep, qb, hdv), dtype=torch.float32,
                          device=dev)
        for j in kv_blocks:
            kblk, vblk = ks[j], vs[j]
            s = torch.einsum("bqkrh,bskh->bkrqs", qblk, kblk).to(
                torch.float32) * scale
            msk = causal_mask(qp, kps[j], window, prefix, has_window)
            s = torch.where(msk[None, None, None], s, -torch.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_new = torch.clamp_min(m_new, -1e30)          # keep finite
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lse = lse * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bkrqs,bskh->bkrqh", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv.to(torch.float32)
            m = m_new
        out = acc / torch.where(lse == 0, 1.0, lse)[..., None]
        return out.to(q.dtype)                       # (B,K,R,qb,hdv)

    nqb, nkb = Tp // qb, Sp // kb
    skip_ok = block_skip and prefix == 0 and T == S
    if skip_ok and window and window < S:
        # SWA: every q block reads a fixed-size kv band starting at
        # clip(lo_pos // kb, 0, nkb - nb_band)
        nb_band = min(nkb, (window + qb) // kb + 1)
        outs = []
        for qi in range(nqb):
            lo_pos = max(qi * qb - window, 0)
            b0 = min(max(lo_pos // kb, 0), nkb - nb_band)
            outs.append(q_block_out(qi, range(b0, b0 + nb_band)))
    elif skip_ok and not window and nqb <= 8:
        # causal: each q block scans its causal kv prefix
        outs = [q_block_out(qi, range(min(nkb, -(-((qi + 1) * qb) // kb))))
                for qi in range(nqb)]
    else:
        outs = [q_block_out(qi, range(nkb)) for qi in range(nqb)]
    out = torch.stack(outs)                      # (nqb,B,K,R,qb,hdv)
    out = out.movedim(0, 1).movedim(4, 2)        # (B,nqb,qb,K,R,hdv)
    return out.reshape(B, Tp, H, hdv)[:, :T]


def _on_shards(fn, q, k, v, *args, **kw):
    """Attention `fn` (``chunked_sdpa``, ``_sdpa``) of DTensors: attention
    is local to each batch and kv-head shard, so q, k and v are laid out
    by batch over dp and by head over tp (where the kv heads divide it),
    each rank runs `fn` on its own shards, with no collective, and the
    output takes q's placements (a replicated DTensor mask is read
    whole)."""
    heads = shd.heads_axis(k.shape[2])
    q, k, v = (shd.constrain(t, "dp", None, heads, None) for t in (q, k, v))
    args = [a.full_tensor() if isinstance(a, DTensor) else a for a in args]
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args, **kw)
    shape = (*q.shape[:3], v.shape[-1])
    stride = (shape[1] * shape[2] * shape[3], shape[2] * shape[3],
              shape[3], 1)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False, shape=shape, stride=stride)


# ---------------------------------------------------------------------------
# GQA attention (covers MHA kv=H and MQA kv=1)
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """wq (d,H,hd), wk/wv (d,K,hd), wo (H,hd,d); bq/bk/bv with qkv_bias."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cdtype(cfg)
        self.wq = _weight(d, H, hd, dtype=dt, device=device)
        self.wk = _weight(d, K, hd, dtype=dt, device=device)
        self.wv = _weight(d, K, hd, dtype=dt, device=device)
        self.wo = _weight(H, hd, d, dtype=dt, device=device)
        self.qkv_bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = _weight(H, hd, dtype=dt, device=device)
            self.bk = _weight(K, hd, dtype=dt, device=device)
            self.bv = _weight(K, hd, dtype=dt, device=device)



@torch.no_grad()
def gqa_init(p: GQA, gen: torch.Generator) -> None:
    """The reference's ``gqa_init`` scales, drawn into `p` in place."""
    H, hd = p.wo.shape[0], p.wo.shape[1]
    for w in (p.wq, p.wk, p.wv):
        dense_init_(w, gen)
    dense_init_(p.wo, gen, scale=(H * hd) ** -0.5)
    if p.qkv_bias:
        for b in (p.bq, p.bk, p.bv):
            b.zero_()


def _proj(x, w, heads=None):
    """einsum("btd,dhk->bthk") as one matmul.  `heads` ("tp" or None):
    where a DTensor's head dim lies after the product (a no-op on plain
    tensors)."""
    d = w.shape[0]
    # a DTensor weight is gathered over dp (FSDP), so that its gradient
    # comes back in the layout the unflattened weight can take
    w2 = shd.constrain(w.to(x.dtype).reshape(d, -1), None, heads)
    y = shd.constrain(torch.matmul(x, w2), "dp", None, heads)
    # after the view too: the backward's gradient meets it in this layout
    return shd.constrain(y.unflatten(-1, w.shape[1:]), "dp", None, heads,
                         *(None,) * (w.dim() - 2))


def _qkv(p, x, cfg: ModelConfig, positions):
    # by kv head: the query heads are grouped by kv head in chunked_sdpa
    heads = shd.heads_axis(cfg.n_kv_heads)
    q, k, v = (_proj(x, w, heads) for w in (p.wq, p.wk, p.wv))
    if p.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out(out, wo, dt):
    """einsum("bthk,hkd->btd") as one matmul."""
    heads = shd.heads_axis(out.shape[2])
    out = shd.constrain(out, "dp", None, heads, None)
    # after the view too: the backward's gradient meets it in this layout
    flat = shd.constrain(out.flatten(-2), "dp", None, heads)
    return torch.matmul(flat, wo.to(dt).reshape(-1, wo.shape[-1]))


def _sdpa(q, k, v, mask, n_rep):
    """q (B,T,H,hd), k (B,S,K,hd), v (B,S,K,hdv); mask (T,S)/(B,T,S).
    DTensors whose kv heads shard over tp run on their local shards
    (``_on_shards``)."""
    if isinstance(q, DTensor) and shd.heads_axis(k.shape[2]):
        return _on_shards(_sdpa, q, k, v, mask, n_rep)
    B, T, H, hd = q.shape
    hdv = v.shape[-1]
    # grouped by kv head, as below
    q = shd.constrain(q, "dp", None, shd.heads_axis(k.shape[2]), None)
    q = q.reshape(B, T, k.shape[2], n_rep, hd)
    scores = torch.einsum("btkrh,bskh->bkrts", q, k) / (hd ** 0.5)
    scores = scores.to(torch.float32)
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrts,bskh->btkrh", w, v)
    return out.reshape(B, T, H, hdv)


def gqa_apply(p, x, *, cfg: ModelConfig, positions, window: int = 0,
              prefix: int = 0, has_window: bool = False):
    """Prefill path.  x (B,T,d); positions (T,) absolute.
    Returns (out (B,T,d), (k, v) after RoPE)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_sdpa(q, k, v, q_pos=positions, kv_pos=positions,
                       window=window, prefix=prefix, has_window=has_window,
                       n_rep=cfg.n_heads // cfg.n_kv_heads, block_skip=True)
    return _out(out, p.wo, x.dtype), (k, v)


def write_slots(cache, dim: int, slots, new) -> None:
    """``cache.index_copy_(dim, slots, new)``.  A DTensor cache (the dry
    run's) is written shard by shard: `dim` (the sequence) is never
    sharded, so each rank writes its own slice of `new`, laid out as the
    cache (no DTensor sharding rule for ``index_copy_`` is needed)."""
    if isinstance(cache, DTensor):
        if isinstance(new, DTensor):
            new = new.redistribute(cache.device_mesh, cache.placements)
        else:
            new = DTensor.from_local(new, cache.device_mesh,
                                     [Replicate()] * cache.device_mesh.ndim,
                                     run_check=False).redistribute(
                cache.device_mesh, cache.placements)
        if isinstance(slots, DTensor):
            slots = slots.full_tensor()
        cache.to_local().index_copy_(dim, slots, new.to_local())
        return
    cache.index_copy_(dim, slots, new)


def _clamped_slot(pos, S: int):
    """The slot ``dynamic_update_slice`` writes a one-token update at:
    the start clamped so that the update fits, S - 1 at pos >= S."""
    return torch.clamp(pos, 0, S - 1).reshape(1).to(torch.int64)


def gqa_decode(p, x, cache, *, cfg: ModelConfig, pos, window: int,
               prefix: int = 0):
    """One-token decode.  x (B,1,d); cache dict(k, v (B,S,K,hd), pos_map
    (S,)), written in place at the new slot; pos a 0-d int tensor (the
    absolute position).  Returns (y (B,1,d), cache)."""
    q, k, v = _qkv(p, x, cfg, pos.reshape(1))
    S = cache["k"].shape[1]
    # a full-attention write at pos >= S lands in slot S - 1
    slot = (torch.remainder(pos, S).reshape(1).to(torch.int64) if window > 0
            else _clamped_slot(pos, S))
    write_slots(cache["k"], 1, slot, k.to(cache["k"].dtype))
    write_slots(cache["v"], 1, slot, v.to(cache["v"].dtype))
    pos_map = cache["pos_map"]
    write_slots(pos_map, 0, slot, pos.reshape(1).to(pos_map.dtype))
    occupied = (pos_map >= 0) & (pos_map <= pos)
    valid = occupied
    if window:
        valid = valid & ((pos_map > pos - window) | (pos_map < prefix))
    elif prefix:
        valid = valid | (occupied & (pos_map < prefix))
    out = _sdpa(q, cache["k"], cache["v"], valid[None, None, :],
                cfg.n_heads // cfg.n_kv_heads)
    return _out(out, p.wo, x.dtype), cache


def gqa_empty_cache(cfg: ModelConfig, batch, s_max, window: int, dtype,
                    device=None):
    S = min(window, s_max) if window else s_max
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, S, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, S, K, hd), dtype=dtype, device=device),
        "pos_map": torch.full((S,), -1, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# MLA attention (minicpm3 / deepseek-v2 style multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """wq_a (d, q_lora), q_norm, wq_b (q_lora, H, qk_nope + qk_rope),
    wkv_a (d, kv_lora + qk_rope), kv_norm, wk_b (kv_lora, H, qk_nope),
    wv_b (kv_lora, H, v_head), wo (H, v_head, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, H, dt = cfg.d_model, cfg.n_heads, cdtype(cfg)
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        kw = dict(dtype=dt, device=device)
        self.wq_a = _weight(d, cfg.q_lora_rank, **kw)
        self.q_norm = RMSNorm(cfg.q_lora_rank, device)
        self.wq_b = _weight(cfg.q_lora_rank, H, qk, **kw)
        self.wkv_a = _weight(d, cfg.kv_lora_rank + cfg.qk_rope_dim, **kw)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, device)
        self.wk_b = _weight(cfg.kv_lora_rank, H, cfg.qk_nope_dim, **kw)
        self.wv_b = _weight(cfg.kv_lora_rank, H, cfg.v_head_dim, **kw)
        self.wo = _weight(H, cfg.v_head_dim, d, **kw)


@torch.no_grad()
def mla_init(p: MLA, gen: torch.Generator) -> None:
    """The reference's ``mla_init`` scales, drawn into `p` in place."""
    H, v_dim = p.wo.shape[0], p.wo.shape[1]
    for w in (p.wq_a, p.wq_b, p.wkv_a, p.wk_b, p.wv_b):
        dense_init_(w, gen)
    dense_init_(p.wo, gen, scale=(H * v_dim) ** -0.5)


def _mla_latents(p, x, cfg: ModelConfig):
    kv_a = torch.matmul(x, p.wkv_a.to(x.dtype))
    c_kv = rms_norm(p.kv_norm, kv_a[..., : cfg.kv_lora_rank], cfg.norm_eps)
    return c_kv, kv_a[..., cfg.kv_lora_rank:]


def _mla_q(p, x, cfg: ModelConfig, positions):
    q_a = rms_norm(p.q_norm, torch.matmul(x, p.wq_a.to(x.dtype)),
                   cfg.norm_eps)
    q = _proj(q_a, p.wq_b)
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], cos, sin)
    return torch.cat([q[..., : cfg.qk_nope_dim], q_rope], dim=-1)


def _rope_shared_key(k_rope, cfg: ModelConfig, positions):
    """RoPE of the one key every head shares: a singleton head axis,
    squeezed after."""
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def _mla_expand_kv(p, c_kv, k_rope_roped, cfg: ModelConfig):
    k_nope = _proj(c_kv, p.wk_b)
    v = _proj(c_kv, p.wv_b)
    k_rope_h = k_rope_roped[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_dim)
    return torch.cat([k_nope, k_rope_h], dim=-1), v


def mla_apply(p, x, *, cfg: ModelConfig, positions, prefix: int = 0):
    """Prefill path.  x (B,T,d); positions (T,) absolute.
    Returns (out (B,T,d), (c_kv, k_rope after RoPE))."""
    c_kv, k_rope = _mla_latents(p, x, cfg)
    k_rope = _rope_shared_key(k_rope, cfg, positions)
    q = _mla_q(p, x, cfg, positions)
    k, v = _mla_expand_kv(p, c_kv, k_rope, cfg)
    out = chunked_sdpa(q, k, v, q_pos=positions, kv_pos=positions,
                       prefix=prefix, n_rep=1, block_skip=True)
    return _out(out, p.wo, x.dtype), (c_kv, k_rope)


def _mla_write(p, x, cache, cfg: ModelConfig, pos):
    """The new token's latent and roped key written into `cache` in place
    at the clamped slot; returns the token's query (B,1,H,qk)."""
    c_kv_new, k_rope_new = _mla_latents(p, x, cfg)
    k_rope_new = _rope_shared_key(k_rope_new, cfg, pos.reshape(1))
    slot = _clamped_slot(pos, cache["ckv"].shape[1])
    write_slots(cache["ckv"], 1, slot, c_kv_new.to(cache["ckv"].dtype))
    write_slots(cache["krope"], 1, slot,
                k_rope_new.to(cache["krope"].dtype))
    pm = cache["pos_map"]
    write_slots(pm, 0, slot, pos.reshape(1).to(pm.dtype))
    return _mla_q(p, x, cfg, pos.reshape(1))


def mla_decode(p, x, cache, *, cfg: ModelConfig, pos):
    """Absorbed-form MLA decode: attention runs in the compressed latent
    space, never expanding per-head K/V over the cache.

        q_abs = q_nope . W_kb          (B,1,H,rank)
        s     = q_abs . ckv^T + q_rope . krope^T
        o_lat = softmax(s) . ckv       (B,1,H,rank)
        o     = o_lat . W_vb           (B,1,H,v_dim)

    x (B,1,d); cache dict(ckv, krope, pos_map), written in place; pos a
    0-d int tensor.  Returns (y (B,1,d), cache)."""
    dt = x.dtype
    q = _mla_write(p, x, cache, cfg, pos)
    q = shd.constrain(q, "dp", None, shd.heads_axis(cfg.n_heads), None)
    ckv, krope, pos_map = cache["ckv"], cache["krope"], cache["pos_map"]
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    q_abs = torch.einsum("bthn,rhn->bthr", q_nope, p.wk_b.to(dt))
    s = (torch.einsum("bthr,bsr->bhts", q_abs, ckv)
         + torch.einsum("bthd,bsd->bhts", q_rope, krope)).to(torch.float32)
    s = s * ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5)
    valid = (pos_map >= 0) & (pos_map <= pos)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.einsum("bhts,bsr->bthr", w, ckv)
    out = torch.einsum("bthr,rhv->bthv", o_lat, p.wv_b.to(dt))
    return _out(out, p.wo, dt), cache


def mla_decode_naive(p, x, cache, *, cfg: ModelConfig, pos):
    """The expanded MLA decode (per-head K/V over the whole cache): the
    reference's oracle for the absorbed form.  Same cache update."""
    q = _mla_write(p, x, cache, cfg, pos)
    k, v = _mla_expand_kv(p, cache["ckv"], cache["krope"], cfg)
    pos_map = cache["pos_map"]
    valid = (pos_map >= 0) & (pos_map <= pos)
    out = _sdpa(q, k, v, valid[None, None, :], 1)
    return _out(out, p.wo, x.dtype), cache


def mla_empty_cache(cfg: ModelConfig, batch, s_max, dtype, device=None):
    return {
        "ckv": torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, s_max, cfg.qk_rope_dim), dtype=dtype,
                             device=device),
        "pos_map": torch.full((s_max,), -1, dtype=torch.int32,
                              device=device),
    }


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

class FFN(nn.Module):
    """w_gate, w_up (d, f), w_down (f, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cdtype(cfg)
        self.w_gate = _weight(d, f, dtype=dt, device=device)
        self.w_up = _weight(d, f, dtype=dt, device=device)
        self.w_down = _weight(f, d, dtype=dt, device=device)



@torch.no_grad()
def ffn_init(p: FFN, gen: torch.Generator) -> None:
    """The reference's ``ffn_init`` scales, drawn into `p` in place."""
    for w in (p.w_gate, p.w_up, p.w_down):
        dense_init_(w, gen)


def ffn_apply(p, x):
    dt = x.dtype
    g = torch.matmul(x, p.w_gate.to(dt))
    u = torch.matmul(x, p.w_up.to(dt))
    return torch.matmul(torch.nn.functional.silu(g) * u, p.w_down.to(dt))


# ---------------------------------------------------------------------------
# MoE FFN (top-k routing, grouped capacity dispatch; Switch-style groups)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """router (d, E); we_gate, we_up (E*s, d, f/s), we_down (E*s, f/s, d)
    stored slot-wise: slot e*s + j holds expert e's j-th FFN slice (s =
    ``moe_ep_split``; exact for SwiGLU, the slices' outputs sum)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f, E, s = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_ep_split
        if f % s:
            raise ValueError("d_ff must divide moe_ep_split")
        kw = dict(dtype=cdtype(cfg), device=device)
        self.router = _weight(d, E, **kw)
        self.we_gate = _weight(E * s, d, f // s, **kw)
        self.we_up = _weight(E * s, d, f // s, **kw)
        self.we_down = _weight(E * s, f // s, d, **kw)


@torch.no_grad()
def moe_init(p: MoE, gen: torch.Generator) -> None:
    """The reference's ``moe_init`` scales (a 3-D weight's fan-in is the
    product of all but its last dimension), drawn into `p` in place."""
    for w in (p.router, p.we_gate, p.we_up, p.we_down):
        dense_init_(w, gen)


def top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as ``lax.top_k`` orders them
    (``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, x, cfg: ModelConfig):
    """The router and the capacity assignment of ``moe_apply``.

    Returns (probs (B,T,E) f32, top_e (B,T,k), slot_e (B,T,k*s) int64,
    slot_p (B,T,k*s) in x's dtype, pos (B,T,k*s) int64, keep (B,T,k*s)
    bool, cap).  Capacity is granted in router-weight priority order (a
    stable sort of -slot_p in float32, ties by sequence position): under
    overflow the lowest-weight choices drop."""
    B, T, _ = x.shape
    E, k, s = cfg.n_experts, cfg.moe_top_k, cfg.moe_ep_split
    ES, ks_ = E * s, k * s
    cap = max(1, int(T * k * cfg.capacity_factor / E))
    dt = x.dtype
    logits = torch.matmul(x, p.router.to(dt))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = (top_p / torch.sum(top_p, -1, keepdim=True)).to(dt)
    slot_e = (top_e[..., None] * s + torch.arange(s, device=x.device)
              ).reshape(B, T, ks_)
    slot_p = torch.repeat_interleave(top_p, s, dim=-1)
    # position of each (token, choice) inside its slot's buffer: the
    # count of higher-priority choices of the same slot
    flat = torch.nn.functional.one_hot(slot_e, ES).reshape(B, T * ks_, ES)
    prio = torch.argsort(-slot_p.to(torch.float32).reshape(B, T * ks_),
                         dim=1, stable=True)
    ranked = torch.gather(flat, 1, prio[..., None].expand(-1, -1, ES))
    pos_ranked = torch.cumsum(ranked, dim=1) - 1
    inv = torch.argsort(prio, dim=1, stable=True)
    pos_in_e = torch.gather(pos_ranked, 1, inv[..., None].expand(-1, -1, ES))
    pos = torch.gather(pos_in_e.reshape(B, T, ks_, ES), -1,
                       slot_e[..., None])[..., 0]
    return probs, top_e, slot_e, slot_p, pos, pos < cap, cap


def _experts(p, buf):
    """The slots' SwiGLU over buf (B, ES, cap, d): one batched matmul per
    projection, slot-major."""
    B, ES, cap, d = buf.shape
    dt = buf.dtype
    xs = buf.transpose(0, 1).reshape(ES, B * cap, d)
    g = torch.bmm(xs, p.we_gate.to(dt))
    u = torch.bmm(xs, p.we_up.to(dt))
    h = torch.bmm(torch.nn.functional.silu(g) * u, p.we_down.to(dt))
    return h.reshape(ES, B, cap, d).transpose(0, 1)


def moe_apply(p, x, *, cfg: ModelConfig):
    """x (B, T, d) -> (out (B, T, d), aux f32).  Each sequence is a
    dispatch group (Switch-style); capacity drops overflow choices.

    With moe_ep_split = s > 1 every chosen expert fans out to its s slots
    (the slot outputs sum); capacity per slot stays T*k*cf/E.
    """
    B, T, d = x.shape
    probs, top_e, slot_e, slot_p, pos, keep, cap = moe_route(p, x, cfg)
    ES = cfg.n_experts * cfg.moe_ep_split
    n = slot_e.shape[1] * slot_e.shape[2]
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, n)
    e_flat = slot_e.reshape(B, n)
    keep_flat = keep.reshape(B, n)
    # a dropped choice goes to a spare slot `cap`, cut off after the
    # scatter (the reference's out-of-range index under mode="drop")
    p_drop = torch.where(keep_flat, pos.reshape(B, n), cap)
    xk = torch.repeat_interleave(x, slot_e.shape[2], dim=1)
    buf = torch.zeros((B, ES, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((b_idx, e_flat, p_drop), xk)[:, :, :cap]
    # expert-parallel dispatch: buf's slot dim follows the expert-weight
    # sharding (EP when ES >= 16), a token all-to-all in place of the
    # expert weights' FSDP gathers
    ep = ES >= 16
    if ep:
        buf = shd.constrain(buf, "dp", "tp", None, None)
    h = _experts(p, buf)
    if ep:
        # the capacity-bounded expert outputs gathered, so that the
        # combine below is local
        h = shd.constrain(h, "dp", None, None, None)
    got = h[b_idx, e_flat, torch.clamp(pos.reshape(B, n), 0, cap - 1)]
    got = got * (slot_p.reshape(B, n) * keep_flat.to(x.dtype))[..., None]
    out = got.reshape(B, T, -1, d).sum(dim=2)
    onehot = torch.nn.functional.one_hot(top_e, cfg.n_experts)
    return out, _load_balance_loss(probs, onehot, cfg.n_experts)


def _load_balance_loss(probs, onehot, E: int):
    """Switch-style auxiliary loss over the experts (not the slots):
    E * sum_e f_e * p_e."""
    f = torch.mean(onehot.to(torch.float32).sum(2), dim=(0, 1))
    pmean = torch.mean(probs, dim=(0, 1))
    return E * torch.sum(f * pmean)


__all__ = [
    "NEG_INF", "cdtype", "matmul_numerics", "RMSNorm", "rms_norm",
    "rope_tables", "apply_rope", "causal_mask", "chunked_sdpa", "GQA",
    "gqa_init", "gqa_apply", "gqa_decode", "gqa_empty_cache", "MLA",
    "mla_init", "mla_apply", "mla_decode", "mla_decode_naive",
    "mla_empty_cache", "FFN", "ffn_init", "ffn_apply", "MoE", "moe_init",
    "top_k", "moe_route", "moe_apply", "write_slots",
]
