"""Transformer building blocks of the dense GQA model: norms, RoPE,
GQA/SWA attention, the SwiGLU FFN (the port of the reference's
``models/layers.py``, dense subset).

Parameters live in ``nn.Module``s with the reference's shapes (``wq``
(d, H, hd), ``wo`` (H, hd, d), ...), stored in ``cfg.dtype`` with norm
scales in float32 as the reference stores them; the functions take a
module and tensors.  Softmax and norms accumulate in float32, and every
formula keeps the reference's order of operations: ``chunked_sdpa``
multiplies by ``hd**-0.5`` where decode's ``_sdpa`` divides by
``hd**0.5``, masks are ``-inf`` in one and ``NEG_INF`` in the other.

Decode caches (the reference's layout, so session files carry its keys):
  * full attention -- (B, S_max, K, hd) written at `pos` (the start
    clamped to S_max - 1, as ``dynamic_update_slice`` clamps it)
  * sliding window -- ring buffer of W slots + `pos_map` of absolute
    positions (RoPE is applied pre-cache at absolute positions)
Unlike the reference's functional update, ``gqa_decode`` writes the new
slot into the cache tensors in place.

MLA and MoE wait for later slices (ROADMAP Queue 1, item 7).
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

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
    and would add exactly nothing).  `window` is a Python int here (the
    reference's traced-window case is hymba's, a later slice).

    q (B,T,H,hd), k (B,S,K,hd), v (B,S,K,hdv); H = K * n_rep.
    Returns (B,T,H,hdv).
    """
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
    scale = hd ** -0.5

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
            s = torch.einsum("bqkrh,bskh->bkrqs", qblk, kblk) * scale
            s = s.to(torch.float32)
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


def _proj(x, w):
    """einsum("btd,dhk->bthk") as one matmul."""
    d = w.shape[0]
    return torch.matmul(x, w.to(x.dtype).reshape(d, -1)).unflatten(
        -1, w.shape[1:])


def _qkv(p, x, cfg: ModelConfig, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if p.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _out(out, wo, dt):
    """einsum("bthk,hkd->btd") as one matmul."""
    return torch.matmul(out.flatten(-2), wo.to(dt).reshape(-1, wo.shape[-1]))


def _sdpa(q, k, v, mask, n_rep):
    """q (B,T,H,hd), k (B,S,K,hd), v (B,S,K,hdv); mask (T,S)/(B,T,S)."""
    B, T, H, hd = q.shape
    hdv = v.shape[-1]
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


def gqa_decode(p, x, cache, *, cfg: ModelConfig, pos, window: int,
               prefix: int = 0):
    """One-token decode.  x (B,1,d); cache dict(k, v (B,S,K,hd), pos_map
    (S,)), written in place at the new slot; pos a 0-d int tensor (the
    absolute position).  Returns (y (B,1,d), cache)."""
    q, k, v = _qkv(p, x, cfg, pos.reshape(1))
    S = cache["k"].shape[1]
    # dynamic_update_slice clamps its start so that the update fits: a
    # full-attention write at pos >= S lands in slot S - 1.
    slot = torch.remainder(pos, S) if window > 0 else torch.clamp(pos, 0,
                                                                  S - 1)
    slot = slot.reshape(1).to(torch.int64)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    pos_map = cache["pos_map"]
    pos_map.index_copy_(0, slot, pos.reshape(1).to(pos_map.dtype))
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


__all__ = [
    "NEG_INF", "cdtype", "matmul_numerics", "RMSNorm", "rms_norm",
    "rope_tables", "apply_rope", "causal_mask", "chunked_sdpa", "GQA",
    "gqa_init", "gqa_apply", "gqa_decode", "gqa_empty_cache", "FFN",
    "ffn_init", "ffn_apply",
]
