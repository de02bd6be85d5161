"""hymba-1.5b [hybrid] -- arXiv:2411.13676 (parallel attn + mamba heads).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs attention heads and SSD heads in PARALLEL on the same
input; the normalized branch outputs are averaged (paper Sec. 2.1; meta
tokens omitted, noted in DESIGN.md).  SWA(1024) everywhere except 3 global
layers {0, 15, 31} -> long_500k RUNS (bounded cache + SSM state).
ssm_expand=1 so the mamba branch also has 25 heads of dim 64.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    attn_kind="gqa", rope_theta=10000.0,
    sliding_window=1024, global_attn_layers=(0, 15, 31),
    ssm_state=16, ssm_expand=1, ssm_head_dim=64, ssm_chunk=256,
    conv_width=4,
    supports_long_context=True,
)


def smoke():
    return reduced(CONFIG, n_heads=4, n_kv_heads=2, head_dim=16,
                   ssm_head_dim=16, ssm_expand=1, d_model=64)
