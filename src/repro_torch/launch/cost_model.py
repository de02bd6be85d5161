"""Analytical FLOPs / bytes / collective model, and an op counter over one
eager step (the port of the reference's ``launch/cost_model.py``).

The analytic formulas model the PORT's implementation, as the
reference's model its own: they start from the reference's arithmetic
and differ where the port does other work.

* **Per-layer windows.**  ``chunked_sdpa`` takes every layer's window as
  a Python int and skips the fully masked blocks of every layer
  (``models/layers.py``), hymba's window layers included; the reference
  traces hymba's mixed windows and visits every block in training.  The
  context below is therefore a function of each layer's window:
  hymba's global layers run the causal rule (and, at 32k, every block),
  its window layers the band, in every shape; its decode reads each
  global layer's whole cache.
* **Long prefill.**  The causal skip runs for at most 8 query blocks:
  ``chunked_sdpa`` keeps the reference's ``nqb <= 8`` condition, so a
  32k prefill visits every block in both implementations (the same
  work; kept).
* **K/V re-reads.**  The port's block loop reads each query block's K/V
  range once per query block, with no residency across blocks:
  ``reread`` is the number of query blocks, where the reference caps it
  at 8 ("XLA keeps blocks resident-ish").

The op counter is the counterpart of the reference's ``hlo_cost``
(XLA's cost analysis of a compiled step, which has no torch
counterpart): ``OpCounter`` is a ``TorchDispatchMode`` that sees every
aten op one step runs, on the local shards where the step runs on
DTensors, and sums

* FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention ops); elementwise ops, reductions,
  norms and the optimizer count 0 (the analytic model leaves them out
  too);
* bytes read and written: the ``nbytes`` of each op's tensor inputs and
  outputs, views and allocations excepted (they move nothing).  That is the traffic of
  eager, unfused execution, an upper bound on a fused step;
* collectives by kind and by result bytes (the reference's convention).

Conventions: dot(M,K)x(K,N) = 2MNK flops; backward = 2x forward;
block-remat adds one extra forward recompute.  Bytes are a traffic model
of this implementation (params + major activation tensors + cache
reads), documented per term; they are estimates, not a measurement.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.config import SHAPES, ModelConfig
from repro_torch.models.lm import layer_flags

BF16 = 2
F32 = 4
# chunked_sdpa's block sizes (models/layers.py)
QB, KB = 512.0, 1024.0


@dataclass
class CellCost:
    flops_total: float           # whole step, all chips
    bytes_total: float           # whole step, all chips (traffic model)
    collective_total: float      # per-device collective bytes

    def per_device(self, chips: int):
        return (self.flops_total / chips, self.bytes_total / chips)


def _attn_flops(cfg: ModelConfig, D: float, ctx: float) -> float:
    """One layer of attention for D query tokens against avg context ctx."""
    d = cfg.d_model
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        f = 2 * D * d * cfg.q_lora_rank
        f += 2 * D * cfg.q_lora_rank * cfg.n_heads * qk
        f += 2 * D * d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
        f += 2 * D * cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_dim
                                                       + cfg.v_head_dim)
        f += 2 * D * ctx * cfg.n_heads * (qk + cfg.v_head_dim)
        f += 2 * D * cfg.n_heads * cfg.v_head_dim * d
        return f
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f = 2 * D * d * (H + 2 * K) * hd            # qkv projections
    f += 2 * D * ctx * H * hd * 2               # scores + pv
    f += 2 * D * H * hd * d                     # output projection
    return f


def _mla_absorbed_decode_flops(cfg: ModelConfig, B: float, T: float):
    d = cfg.d_model
    r, rp = cfg.kv_lora_rank, cfg.qk_rope_dim
    f = 2 * B * d * cfg.q_lora_rank
    f += 2 * B * cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_dim + rp)
    f += 2 * B * d * (r + rp)
    f += 2 * B * cfg.n_heads * cfg.qk_nope_dim * r        # q absorb
    f += 2 * B * cfg.n_heads * T * (r + rp)               # scores
    f += 2 * B * cfg.n_heads * T * r                      # o_lat
    f += 2 * B * cfg.n_heads * r * cfg.v_head_dim         # expand out
    f += 2 * B * cfg.n_heads * cfg.v_head_dim * d
    return f


def _ffn_flops(cfg: ModelConfig, D: float) -> float:
    if not cfg.d_ff:
        return 0.0
    if cfg.n_experts:
        # capacity-padded grouped matmuls do top_k * capacity_factor worth
        # of work per token + the router
        eff = cfg.moe_top_k * cfg.capacity_factor
        return (6 * D * eff * cfg.d_model * cfg.d_ff
                + 2 * D * cfg.d_model * cfg.n_experts)
    return 6 * D * cfg.d_model * cfg.d_ff


def _ssd_flops(cfg: ModelConfig, D: float, decode: bool) -> float:
    if not cfg.ssm_state:
        return 0.0
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh, hd = cfg.ssm_heads, cfg.ssm_head_dim
    f = 2 * D * d * (2 * di + 2 * N + nh)       # in_proj
    f += 2 * D * cfg.conv_width * (di + 2 * N)  # conv
    f += 2 * D * di * d                          # out_proj
    if decode:
        f += 2 * D * nh * hd * N * 2             # h update + y readout
        return f
    Q = cfg.ssm_chunk
    # intra-chunk: CB^T (Q x Q x N, head-shared) + two (Q,Q)x(Q,hd)-ish
    # contractions per head; inter-chunk state ops are O(D*nh*hd*N)
    f += 2 * D * Q * N                           # scores (shared)
    f += 2 * D * Q * nh * hd                     # y_diag
    f += 2 * D * N * nh * hd * 2                 # states + y_off
    return f


def layer_windows(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """[(window, number of layers)] of the layers' attention windows (0 =
    global), in order of first appearance; one entry for a uniform
    stack."""
    counts: Dict[int, int] = {}
    for w in layer_flags(cfg):
        counts[int(w)] = counts.get(int(w), 0) + 1
    return list(counts.items())


def _ctx(cfg: ModelConfig, kind: str, S: int, window: int) -> float:
    """The kv positions one query visits on average in a layer of
    `window` (0 = global), as ``chunked_sdpa`` and the decode run it."""
    if kind == "decode":
        return float(min(S, window)) if window else float(S)
    if cfg.n_prefix:
        return float(S)         # prefix-LM keeps full tiles
    if window and window < S:
        # SWA band scan skips at any T
        return float(min(S, window + QB + KB))
    if S / QB <= 8:
        # causal skip (train_4k); clamp for S < QB
        return min((S + QB) / 2, float(S))
    # long prefill: chunked_sdpa skips for at most 8 query blocks
    return float(S)


def flops_cell(cfg: ModelConfig, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    if kind in ("train", "prefill"):
        D = B * S
        mult = (4.0 if cfg.remat == "block" else 3.0) \
            if kind == "train" else 1.0
    else:
        D, mult = B, 1.0

    layers = 0.0
    for window, count in layer_windows(cfg):
        ctx = _ctx(cfg, kind, S, window)
        per_layer = 0.0
        if cfg.family == "hybrid":
            per_layer += _attn_flops(cfg, D, ctx)
            per_layer += _ssd_flops(cfg, D, decode=(kind == "decode"))
        elif cfg.n_heads:
            if cfg.attn_kind == "mla" and kind == "decode":
                per_layer += _mla_absorbed_decode_flops(cfg, D, ctx)
            else:
                per_layer += _attn_flops(cfg, D, ctx)
        elif cfg.ssm_state:
            per_layer += _ssd_flops(cfg, D, decode=(kind == "decode"))
        per_layer += _ffn_flops(cfg, D)
        layers += count * per_layer

    logits = 2 * D * cfg.d_model * cfg.vocab_size
    return (layers + logits) * mult


def bytes_cell(cfg: ModelConfig, shape_name: str) -> float:
    """Traffic model: parameters + residual/attention/cache streams."""
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    D = B * S if kind != "decode" else B
    P = cfg.param_count()
    d = cfg.d_model

    if kind == "train":
        # params: fwd read + bwd read + grad write (bf16) + adam m/v r+w and
        # master read/write (f32)
        pbytes = P * (3 * BF16 + 6 * F32)
        act_mult = 3.0 if cfg.remat != "block" else 2.0
    else:
        pbytes = P * BF16
        act_mult = 1.0

    # residual stream + a handful of layer-internal tensors
    act = cfg.n_layers * D * d * BF16 * 8 * act_mult
    # attention K/V stream: decode reads each layer's whole cache;
    # prefill/train re-read K/V once per q-block (nqb ~ S/512), every
    # block loop of chunked_sdpa reading its kv range anew
    cache = 0.0
    if cfg.n_heads:
        K = (cfg.n_kv_heads * cfg.head_dim if cfg.attn_kind != "mla"
             else cfg.kv_lora_rank + cfg.qk_rope_dim)
        reread = 1 if kind == "decode" else max(1, S // 512)
        for window, count in layer_windows(cfg):
            ctx = min(S, window) if window else S
            cache += count * B * ctx * K * BF16 * 2 * reread
    if cfg.ssm_state and kind == "decode":
        cache += cfg.n_layers * B * cfg.ssm_heads * cfg.ssm_head_dim \
            * cfg.ssm_state * F32 * 2
    logits = D * cfg.vocab_size * F32 * (2 if kind == "train" else 1)
    return pbytes + act + cache + logits


def collective_cell(cfg: ModelConfig, shape_name: str, chips: int,
                    dp: int, tp: int) -> float:
    """Per-device collective bytes (FSDP gathers + grad reduce + TP)."""
    sh = SHAPES[shape_name]
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    D = B * S if kind != "decode" else B
    P = cfg.param_count()
    if kind == "train":
        # FSDP: all-gather params fwd + bwd (bf16), reduce-scatter grads
        fsdp = P * BF16 * 2 / tp + P * BF16 / tp
        # TP: activation all-reduces, ~2 per layer of the residual stream
        tpc = 2 * cfg.n_layers * (D / dp) * cfg.d_model * BF16
        return fsdp + tpc
    # inference: params stay resident; TP all-reduces only
    return 2 * cfg.n_layers * (max(D // dp, 1)) * cfg.d_model * BF16


def cell_cost(cfg: ModelConfig, shape_name: str, chips: int = 256,
              dp: int = 16, tp: int = 16) -> CellCost:
    return CellCost(
        flops_total=flops_cell(cfg, shape_name),
        bytes_total=bytes_cell(cfg, shape_name),
        collective_total=collective_cell(cfg, shape_name, chips, dp, tp))


# ---------------------------------------------------------------------------
# the op counter (the counterpart of hlo_cost)
# ---------------------------------------------------------------------------

# collective ops by the reference's HLO names; their result bytes count
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_PLAIN = (torch.Tensor, torch.nn.Parameter)
# ops that allocate and move no bytes
_ALLOCATIONS = frozenset(("empty", "empty_strided", "empty_like",
                          "new_empty", "new_empty_strided"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional",
                          "_dtensor")


def _tensors(x, out=None) -> List[torch.Tensor]:
    """The tensors in an op's arguments or outputs (nested lists, tuples
    and dicts)."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _key(x):
    """A hashable signature of one op argument (shapes, not values), or
    raise TypeError for what the memo cannot key."""
    if isinstance(x, torch.Tensor):
        # a fresh output's layout depends on its inputs' shapes and
        # strides, not on where they start in their storage
        return ("T", tuple(x.shape), tuple(x.stride()), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_key(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return x
    raise TypeError(type(x).__name__)


def _layout(t: torch.Tensor):
    return tuple(t.shape), t.stride(), t.dtype


def _functional(func) -> bool:
    """An op that writes no argument and returns fresh tensors."""
    schema = func._schema
    if any(a.alias_info is not None for a in schema.returns):
        return False
    return not any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments)


class OpCounter(TorchDispatchMode):
    """Counts the work of the aten ops run under it (see the module's
    docstring): ``flops``, ``bytes`` and ``collectives`` ({kind: result
    bytes}) summed on the local tensors, ``n_ops``.

    An op with DTensor arguments is handed back to DTensor
    (``NotImplemented``), which runs it as local ops and collectives that
    come back here.  On "meta" tensors a functional op's outputs are
    memoised by its arguments' shapes: a repeated op (the blocks of
    ``chunked_sdpa``) gets fresh meta outputs of the recorded shapes
    without running its meta kernel again, which changes nothing but the
    trace's time."""

    def __init__(self, memo=None):
        """`memo`: a dict shared between counters (meta outputs by
        argument shapes hold for every step of a process)."""
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.collective_counts: Dict[str, int] = defaultdict(int)
        self._memo: Dict = {} if memo is None else memo

    def _run(self, func, args, kwargs):
        ins = _tensors(args, _tensors(kwargs))
        if not ins or not _functional(func) or any(
                t.device.type != "meta" or type(t) not in _PLAIN
                for t in ins):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        spec = self._memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._memo[key] = (None, [_layout(out)])
            elif isinstance(out, (tuple, list)) and all(
                    isinstance(t, torch.Tensor) for t in out):
                self._memo[key] = (type(out), [_layout(t) for t in out])
            return out
        kind, layouts = spec
        outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
                for s, st, dt in layouts]
        return outs[0] if kind is None else kind(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives[kind] += sum(
                    t.nbytes for t in _tensors(out))
                self.collective_counts[kind] += 1
            return out
        self.n_ops += 1
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view and name not in _ALLOCATIONS:
            self.bytes += sum(t.nbytes for t in _tensors(args,
                                                         _tensors(kwargs)))
            self.bytes += sum(t.nbytes for t in _tensors(out))
        return out

    def snapshot(self) -> Dict:
        """The counts so far (``add`` takes differences of two)."""
        return dict(flops=self.flops, bytes=self.bytes, n_ops=self.n_ops,
                    collectives=dict(self.collectives),
                    collective_counts=dict(self.collective_counts))

    @staticmethod
    def difference(after: Dict, before: Dict) -> Dict:
        out = {k: after[k] - before[k] for k in ("flops", "bytes", "n_ops")}
        for f in ("collectives", "collective_counts"):
            out[f] = {k: v - before[f].get(k, 0)
                      for k, v in after[f].items()}
        return out

    def add(self, delta: Dict) -> None:
        """Count `delta` (a ``difference``) again: a replayed call."""
        self.flops += delta["flops"]
        self.bytes += delta["bytes"]
        self.n_ops += delta["n_ops"]
        for f in ("collectives", "collective_counts"):
            for k, v in delta[f].items():
                getattr(self, f)[k] += v

    def cost(self) -> Dict[str, float]:
        """The reference's ``hlo_cost`` keys, plus the collectives."""
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "collectives": dict(self.collectives),
                "collective_counts": dict(self.collective_counts),
                "ops": self.n_ops}


def step_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an ``OpCounter`` -> (its
    output, ``OpCounter.cost()``)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost()


__all__ = ["cell_cost", "flops_cell", "bytes_cell", "collective_cell",
           "CellCost", "OpCounter", "step_cost", "layer_windows"]
