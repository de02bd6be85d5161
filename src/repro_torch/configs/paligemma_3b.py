"""paligemma-3b [vlm] -- arXiv:2407.07726 (SigLIP + gemma backbone).

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.  head_dim=256.
The SigLIP vision tower is a STUB per the assignment: input_specs()
provides 256 precomputed patch embeddings (B, 256, d_model); text tokens
attend with a prefix-LM mask (full over patches, causal over text).
Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    attn_kind="gqa", rope_theta=10000.0,
    frontend="patches", n_prefix=256,
    tie_embeddings=True,
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG, frontend="patches", n_prefix=8)
