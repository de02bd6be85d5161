"""llama3.2-1b [dense] -- hf:meta-llama/Llama-3.2-1B.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  head_dim=64,
rope theta 500000 (llama3 family).  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    head_dim=64, d_ff=8192, vocab_size=128256,
    attn_kind="gqa", rope_theta=500000.0,
    tie_embeddings=True,
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG)
