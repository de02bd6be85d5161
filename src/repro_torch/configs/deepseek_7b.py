"""deepseek-7b [dense] -- arXiv:2401.02954 (llama-arch, MHA).

30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.
head_dim=128.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    head_dim=128, d_ff=11008, vocab_size=102400,
    attn_kind="gqa", rope_theta=10000.0,
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG, n_kv_heads=4)
