"""qwen1.5-110b [dense] -- Qwen1.5 family (QKV bias).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.  head_dim=128.
The largest assigned arch: needs FSDP+TP 2-D weight sharding and block
remat to fit 16 GB/chip on the (16,16) mesh.  Full attention -> long_500k
skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=49152, vocab_size=152064,
    attn_kind="gqa", qkv_bias=True, rope_theta=1000000.0,
    remat="block",
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG, qkv_bias=True)
