"""mamba2-780m [ssm] -- arXiv:2405.21060 (SSD, state-space duality).

48L d_model=1536 attention-free, vocab=50280, ssm_state=128, expand=2
(d_inner=3072, 48 heads of head_dim 64), conv width 4, SSD chunk 256.
O(1)-state decode -> long_500k RUNS.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    attn_kind="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    supports_long_context=True,
)


def smoke():
    return reduced(CONFIG, ssm_state=16, d_ff=0)
