"""mixtral-8x7b [moe] -- arXiv:2401.04088.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, 8 experts top-2,
sliding-window attention (4096).  SWA bounds the KV cache -> long_500k RUNS
for this arch (window 4096 cache regardless of context length).
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    attn_kind="gqa", rope_theta=1000000.0,
    sliding_window=4096,
    n_experts=8, moe_top_k=2,
    # SS Perf iteration (EXPERIMENTS.md): 8x2 = 16 expert slots -> clean
    # expert parallelism on the 16-way model axis (kills the ~90 GB/dev
    # per-step FSDP weight gathers)
    moe_ep_split=2,
    remat="block",
    supports_long_context=True,
)


def smoke():
    return reduced(CONFIG)
