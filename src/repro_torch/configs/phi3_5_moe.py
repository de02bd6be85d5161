"""phi3.5-moe-42b-a6.6b [moe] -- hf:microsoft/Phi-3.5-MoE-instruct.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, 16 experts top-2.
16 experts == the 16-way model axis -> pure expert parallelism.
Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=6400, vocab_size=32064,
    attn_kind="gqa", rope_theta=10000.0,
    n_experts=16, moe_top_k=2,
    remat="block",
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG)
