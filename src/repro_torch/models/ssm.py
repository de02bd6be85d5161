"""Mamba-2 SSD (state-space duality) block -- arXiv:2405.21060 (the port
of the reference's ``models/ssm.py``).

Training and prefill use the chunked dual form: block-diagonal
(intra-chunk) attention-like einsums plus a low-rank inter-chunk state
recurrence.  The recurrence (the reference's ``lax.scan``) is a Python
loop over the T / chunk chunks; it and the einsums stay plain PyTorch.

Decode is the O(1) recurrence h <- a*h + dt*B (x) , y = C.h + D*x, the
layer's slice of the cache (``conv`` (B, w-1, din+2N) float32, ``h``
(B, nh, hd, N) float32) written in place.

Layout: ngroups = 1 (B/C shared across heads), d_inner = expand*d_model,
heads = d_inner / head_dim.  Every leaf is stored in ``cfg.dtype`` (the
norm's scale in float32), and every formula keeps the reference's order
of operations and its promotions (a bfloat16 leaf meeting a float32
tensor is widened).

Two XLA rules of the reference's compiled bfloat16 program are kept,
both in the SSD (without them hymba's bfloat16 logits leave the 5e-2 of
the JAX package's): ``jax.nn.silu`` lowers to x * 1/(1 + exp(-x)) with
every step rounded to the compute dtype (``_silu_xla``; its backward is
silu's exact derivative, so it stays finite where exp(-x) overflows),
and the gate's product ``y * silu(z)`` is not rounded before
``gate_norm`` widens it (``_gate``).  The reference's hymba prefill and
decode loops run op by op outside ``jit`` and round that product; the
port follows the compiled form.

One departure: ``_segsum_decay`` masks the pairwise log-decays before
``exp``, where the reference takes ``exp`` of every pair and masks
after.  The forward is the same bit for bit (``exp(-inf)`` is the 0 that
the reference's ``where`` picks), but above the diagonal the reference's
differences reach past 88 in a chunk of 256, ``exp`` overflows to inf,
and its backward computes 0 * inf = NaN (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (RMSNorm, _weight, cdtype,
                                       dense_init_, rms_norm)


class SSD(nn.Module):
    """in_proj (d, 2*din + 2N + nh), conv_w (w, din + 2N), conv_b, A_log,
    D, dt_bias (nh,), gate_norm (din), out_proj (din, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, din, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, w = cfg.ssm_heads, cfg.conv_width
        kw = dict(dtype=cdtype(cfg), device=device)
        self.in_proj = _weight(d, 2 * din + 2 * N + nh, **kw)
        self.conv_w = _weight(w, din + 2 * N, **kw)
        self.conv_b = _weight(din + 2 * N, **kw)
        self.A_log = _weight(nh, **kw)
        self.D = _weight(nh, **kw)
        self.dt_bias = _weight(nh, **kw)
        self.gate_norm = RMSNorm(din, device)
        self.out_proj = _weight(din, d, **kw)


@torch.no_grad()
def ssd_init(p: SSD, gen: torch.Generator) -> None:
    """The reference's ``ssd_init`` values, drawn into `p` in place:
    in_proj and out_proj fan-in^-1/2, conv_w w^-1/2, conv_b 0, A_log
    log(linspace(1, 16)), D 1, dt_bias the softplus inverse of
    linspace(1e-3, 1e-1), computed in float32."""
    nh, w = p.A_log.shape[0], p.conv_w.shape[0]
    dev = p.A_log.device
    dense_init_(p.in_proj, gen)
    dense_init_(p.conv_w, gen, scale=w ** -0.5)
    p.conv_b.zero_()
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, device=dev)))
    p.D.fill_(1.0)
    p.dt_bias.copy_(torch.log(torch.expm1(
        torch.linspace(1e-3, 1e-1, nh, device=dev))))
    dense_init_(p.out_proj, gen)


class _SiluSteps(torch.autograd.Function):
    """silu as XLA computes it in a low-precision dtype: every step of
    x * 1/(1 + exp(-x)) rounded; the backward is silu's exact derivative
    in float32."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.to(torch.float32)
        s = torch.sigmoid(xf)
        return (g.to(torch.float32) * s * (1 + xf * (1 - s))).to(x.dtype)


def _silu_xla(x):
    if x.dtype == torch.float32:
        return F.silu(x)
    return _SiluSteps.apply(x)


def _split_proj(p, x, cfg: ModelConfig):
    din, N = cfg.d_inner, cfg.ssm_state
    proj = torch.matmul(x, p.in_proj.to(x.dtype))
    return (proj[..., :din], proj[..., din: 2 * din + 2 * N],
            proj[..., 2 * din + 2 * N:])


def _causal_conv(p, xBC, w: int):
    """Depthwise causal conv via w static shifts.  A DTensor input (the
    dry run's) runs on each rank's batch shard with its channels whole:
    torch 2.11's DTensor cannot plan the pad."""
    if isinstance(xBC, DTensor):
        x = shd.constrain(xBC, "dp", None, None)
        out = _conv_shifts(x.to_local(), p.conv_w.full_tensor(),
                           p.conv_b.full_tensor(), w)
        return DTensor.from_local(out, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return _conv_shifts(xBC, p.conv_w, p.conv_b, w)


def _conv_shifts(xBC, conv_w, conv_b, w: int):
    pad = F.pad(xBC, (0, 0, w - 1, 0))
    T = xBC.shape[1]
    out = sum(pad[:, i: i + T, :] * conv_w[i].to(xBC.dtype)
              for i in range(w))
    return _silu_xla(out + conv_b.to(xBC.dtype))


def _segsum_decay(a_cum):
    """L[q, s] = exp(a_cum[q] - a_cum[s]) masked to q >= s, the mask
    applied before ``exp`` (finite gradients; module docstring).

    a_cum: (..., Q, nh) inclusive cumulative log-decay.
    Returns (..., Q, Q, nh) in f32.
    """
    diff = a_cum[..., :, None, :] - a_cum[..., None, :, :]
    Q = a_cum.shape[-2]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                device=a_cum.device))
    return torch.exp(torch.where(tri[..., None], diff, -torch.inf))


def _gate(p, y, z, cfg: ModelConfig):
    """gate_norm(y * silu(z)), the product taken in float32 from the
    rounded factors: XLA drops the product's rounding to the compute dtype
    where the norm widens it again."""
    f32 = torch.float32
    return rms_norm(p.gate_norm, y.to(f32) * _silu_xla(z).to(f32),
                    cfg.norm_eps).to(y.dtype)


def _scan(xBC, dt_raw, A_log, D, dt_bias, cfg: ModelConfig, valid_len=None,
          init_state=None, heads=slice(None)):
    """The SSD on the conv's output xBC (B, T, din + 2N) and dt_raw (B, T,
    nh'): the chunked dual form and the recurrence over chunks -> (y (B,
    T, nh' hd) in xBC's dtype, final state (B, nh', hd, N) f32), for the
    heads `heads` of xBC's din (nh' of them; A_log, D, dt_bias theirs)."""
    B_, T, _ = xBC.shape
    din, N, hd, Q = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, \
        cfg.ssm_chunk
    nh = dt_raw.shape[-1]
    dt_ = xBC.dtype
    f32 = torch.float32

    xs = xBC[..., :din].reshape(B_, T, -1, hd)[:, :, heads]
    Bm = xBC[..., din: din + N]
    Cm = xBC[..., din + N:]

    dt = F.softplus(dt_raw.to(f32) + dt_bias)          # (B,T,nh) f32
    if valid_len is not None:
        tpos = torch.arange(T, device=xBC.device)
        dt = torch.where(tpos[None, :, None] < valid_len, dt, 0.0)
    A = -torch.exp(A_log)                              # (nh,)
    a = dt * A                                         # log-decay, <= 0

    # pad T to a chunk multiple (causal: pads can't affect real outputs;
    # dt = 0 there keeps the carried state exact)
    Tp = -(-T // Q) * Q
    if Tp != T:
        pad = Tp - T
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
    nc = Tp // Q

    xdt = (xs.to(f32) * dt[..., None]).to(dt_)
    xdt_c = xdt.reshape(B_, nc, Q, nh, hd)
    B_c, C_c = Bm.reshape(B_, nc, Q, N), Cm.reshape(B_, nc, Q, N)
    a_cum = torch.cumsum(a.reshape(B_, nc, Q, nh), dim=2)  # (B,nc,Q,nh)

    # ---- intra-chunk (block-diagonal attention-dual) --------------------
    L = _segsum_decay(a_cum)                           # (B,nc,Q,Q,nh)
    scores = torch.einsum("bcqn,bcsn->bcqs", C_c, B_c)  # shared by heads
    w_att = (scores[..., None] * L).to(dt_)            # (B,nc,Q,Q,nh)
    y_diag = torch.einsum("bcqsh,bcshd->bcqhd", w_att, xdt_c)

    # ---- chunk boundary states -----------------------------------------
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B,nc,Q,nh)
    S = torch.einsum("bcqn,bcqhd->bchdn", B_c.to(f32),
                     xdt_c.to(f32) * decay_to_end[..., None])

    # ---- inter-chunk recurrence (the only sequential op) ----------------
    chunk_decay = torch.exp(a_cum[:, :, -1, :])        # (B,nc,nh)
    h = (torch.zeros((B_, nh, hd, N), dtype=f32, device=xBC.device)
         if init_state is None else init_state.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prevs, dim=1)               # (B,nc,nh,hd,N)

    # ---- inter-chunk contribution ---------------------------------------
    in_decay = torch.exp(a_cum)                        # (B,nc,Q,nh)
    y_off = torch.einsum("bcqn,bchdn->bcqhd", C_c.to(f32),
                         h_prev) * in_decay[..., None]

    y = (y_diag.to(f32) + y_off).reshape(B_, Tp, nh, hd)[:, :T]
    y = y + xs[:, :T].to(f32) * D[None, None, :, None]
    return y.reshape(B_, T, nh * hd).to(dt_), h



def _scan_on_shards(p, xBC, dt_raw, cfg: ModelConfig, valid_len,
                    init_state):
    """``_scan`` of DTensors (the dry run's): the SSD is local to each
    batch and head shard, so xBC (channels whole) and dt_raw are laid out
    by batch over dp and by head over tp (where the heads divide it), and
    each rank scans its own heads, with no collective."""
    nh = cfg.ssm_heads
    heads = shd.heads_axis(nh)
    xBC = shd.constrain(xBC, "dp", None, None)
    dt_raw = shd.constrain(dt_raw, "dp", None, heads)
    mesh = dt_raw.device_mesh
    nh_l = dt_raw.to_local().shape[-1]
    first = 0
    if heads:
        first = mesh.get_local_rank(shd.active_axes()[1]) * nh_l
    params = [shd.constrain(t, heads).to_local()
              for t in (p.A_log, p.D, p.dt_bias)]
    if init_state is not None:
        init_state = shd.constrain(init_state, "dp", heads, None,
                                   None).to_local()
    y, h = _scan(xBC.to_local(), dt_raw.to_local(), *params, cfg, valid_len,
                 init_state, heads=slice(first, first + nh_l))
    B_, T, _ = xBC.shape
    y = DTensor.from_local(y, mesh, dt_raw.placements, run_check=False,
                           shape=(B_, T, cfg.d_inner),
                           stride=(T * cfg.d_inner, cfg.d_inner, 1))
    h_pl = shd.layout((B_, nh, cfg.ssm_head_dim, cfg.ssm_state), "dp",
                      heads, None, None)
    h_shape = (B_, nh, cfg.ssm_head_dim, cfg.ssm_state)
    h = DTensor.from_local(h, mesh, h_pl, run_check=False, shape=h_shape,
                           stride=torch.empty(h_shape,
                                              device="meta").stride())
    return y, h


def _ssd(p, x, cfg: ModelConfig, valid_len=None, init_state=None):
    """``ssd_apply`` -> (y, final state h, the pre-conv xBC projection)."""
    dt_ = x.dtype
    z, xBC_raw, dt_raw = _split_proj(p, x, cfg)
    xBC = _causal_conv(p, xBC_raw, cfg.conv_width)
    if isinstance(xBC, DTensor):
        y, h = _scan_on_shards(p, xBC, dt_raw, cfg, valid_len, init_state)
    else:
        y, h = _scan(xBC, dt_raw, p.A_log, p.D, p.dt_bias, cfg, valid_len,
                     init_state)
    y = _gate(p, y, z, cfg)
    out = torch.matmul(y, p.out_proj.to(dt_))
    return out, h, xBC_raw


def ssd_apply(p, x, *, cfg: ModelConfig, valid_len=None, init_state=None):
    """x (B, T, d) -> (y (B, T, d), final ssm state h (B, nh, hd, N) f32).

    `valid_len`: positions >= valid_len get dt = 0 (identity update), so
    the returned state reflects exactly the first valid_len tokens
    (prefill with padding).
    """
    out, h, _ = _ssd(p, x, cfg, valid_len, init_state)
    return out, h


def ssd_decode(p, x, cache, *, cfg: ModelConfig):
    """One-token recurrent step.  x (B,1,d); cache {conv (B,w-1,ch),
    h (B,nh,hd,N)} float32, written in place.  Returns (y (B,1,d),
    cache)."""
    B_ = x.shape[0]
    din, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    dt_ = x.dtype
    f32 = torch.float32

    z, xBC_new, dt_raw = _split_proj(p, x, cfg)
    window = torch.cat([cache["conv"], xBC_new.to(f32)], dim=1)  # (B,w,ch)
    conv_out = torch.einsum("bwc,wc->bc", window,
                            p.conv_w.to(f32)) + p.conv_b
    xBC = F.silu(conv_out)                                       # (B,ch)
    xs = xBC[:, :din].reshape(B_, nh, hd)
    Bm = xBC[:, din: din + N]
    Cm = xBC[:, din + N:]

    dt = F.softplus(dt_raw[:, 0].to(f32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt * A)                                        # (B,nh)

    h = cache["h"] * a[:, :, None, None] + torch.einsum(
        "bn,bhd->bhdn", Bm, xs * dt[..., None])                  # (B,nh,hd,N)
    # the dry run's layout of the heads (identities on plain tensors)
    heads = shd.heads_axis(nh)
    h = shd.constrain(h, "dp", heads, None, None)
    y = torch.einsum("bn,bhdn->bhd", Cm, h) + xs * p.D[None, :, None]
    y = shd.constrain(y, "dp", heads, None)
    y = y.reshape(B_, 1, din).to(dt_)
    y = _gate(p, y, z, cfg)
    out = torch.matmul(y, p.out_proj.to(dt_))
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache


def ssd_empty_cache(cfg: ModelConfig, batch, device=None):
    din, N = cfg.d_inner, cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, din + 2 * N),
                            dtype=f32, device=device),
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, N),
                         dtype=f32, device=device),
    }


def ssd_prefill_cache(p, x, *, cfg: ModelConfig, valid_len=None):
    """Run ssd_apply and also return the decode cache (state + the last
    w - 1 positions of the pre-conv projection, float32; a prompt shorter
    than w - 1 is led by the conv's zero padding, where the reference's
    tail would be short)."""
    out, h, xBC = _ssd(p, x, cfg, valid_len)
    w = cfg.conv_width
    if xBC.shape[1] < w - 1:
        xBC = F.pad(xBC, (0, 0, w - 1 - xBC.shape[1], 0))
    conv_tail = xBC[:, -(w - 1):, :].to(torch.float32)
    return out, {"conv": conv_tail, "h": h}


__all__ = ["SSD", "ssd_init", "ssd_apply", "ssd_decode", "ssd_empty_cache",
           "ssd_prefill_cache"]
