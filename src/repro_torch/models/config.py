"""Architecture configuration schema covering all assigned families (a
copy of the reference's `models/config.py`; data only, no jax).

One frozen dataclass spans dense / MoE / SSM / hybrid / VLM / audio; unused
fields stay at their zero defaults.  Exact full-size configs live in
src/repro_torch/configs/<arch>.py; each also provides a reduced `smoke()`
for CPU tests.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                   # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0

    # attention
    attn_kind: str = "gqa"         # gqa | mla | none
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 => full causal
    global_attn_layers: Tuple[int, ...] = ()   # SWA exceptions (hymba)
    qkv_bias: bool = False         # qwen-style

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # SS Perf (EXPERIMENTS.md, mixtral): split each expert's FFN into
    # `moe_ep_split` independent column/row slices so n_experts*split
    # matches the model axis -> clean expert parallelism with no FSDP
    # weight gathers and no padding.  Mathematically exact for SwiGLU.
    moe_ep_split: int = 1

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # frontend stubs (assignment: modality frontend provides embeddings)
    frontend: str = ""             # "" | "patches" | "frames"
    n_prefix: int = 0              # e.g. 256 SigLIP patches

    # numerics / training
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: str = "none"            # none | block
    tie_embeddings: bool = False

    # which assigned input shapes are runnable (DESIGN.md Sec. 5)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.n_heads and not self.head_dim and self.attn_kind == "gqa":
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, L, ff, V = self.d_model, self.n_layers, self.d_ff, self.vocab_size
        total = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_kind == "gqa" and self.n_heads:
            hd = self.head_dim
            per_layer += d * self.n_heads * hd          # q
            per_layer += 2 * d * self.n_kv_heads * hd   # k, v
            per_layer += self.n_heads * hd * d          # o
        elif self.attn_kind == "mla":
            qk = self.qk_nope_dim + self.qk_rope_dim
            per_layer += d * self.q_lora_rank
            per_layer += self.q_lora_rank * self.n_heads * qk
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        if self.n_experts:
            per_layer += d * self.n_experts              # router
            per_layer += self.n_experts * 3 * d * ff     # swiglu experts
        elif ff:
            per_layer += 3 * d * ff
        if self.ssm_state:
            din, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * din + 2 * ns + nh)     # in_proj
            per_layer += din * d                          # out_proj
            per_layer += self.conv_width * (din + 2 * ns) + 3 * nh
        per_layer += 2 * d                                # norms
        return total + L * per_layer

    def active_param_count(self) -> int:
        """N_active for MoE rooflines (6 * N_active * D)."""
        if not self.n_experts:
            return self.param_count()
        d, L, ff = self.d_model, self.n_layers, self.d_ff
        dense_experts = self.n_experts - self.moe_top_k
        return self.param_count() - L * dense_experts * 3 * d * ff


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build the smoke-test config: same family/topology, tiny sizes."""
    base = dict(
        n_layers=2, d_model=64, d_ff=128,
        vocab_size=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window
        else 0,
        global_attn_layers=(0,) if cfg.global_attn_layers else (),
        q_lora_rank=32 if cfg.q_lora_rank else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.qk_nope_dim else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        n_prefix=8 if cfg.n_prefix else 0,
        dtype="float32", remat="none",
    )
    if base["n_experts"]:
        # Drop-free MoE capacity (cap == T exactly when cf = E/k): capacity
        # overflow assigns buffer slots through a cumsum over ALL tokens, so
        # a drop couples a token's output to arbitrarily distant tokens'
        # routing -- which breaks the locality properties the smoke tests
        # assert (e.g. SWA receptive-field isolation).  Production configs
        # keep their trained capacity_factor; drop behavior itself is
        # covered by test_moe.py with an explicit tiny factor.
        base["capacity_factor"] = max(
            cfg.capacity_factor, base["n_experts"] / base["moe_top_k"])
    base.update(overrides)
    return replace(cfg, **base)


# Assigned input shapes (seq_len, global_batch); decode_*/long_* lower
# serve_step with a KV cache of seq_len (one new token).
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def runnable_shapes(cfg: ModelConfig):
    """long_500k only for sub-quadratic archs (DESIGN.md Sec. 5)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return names


__all__ = ["ModelConfig", "reduced", "SHAPES", "runnable_shapes"]
