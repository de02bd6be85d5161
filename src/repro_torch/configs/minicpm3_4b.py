"""minicpm3-4b [dense, MLA] -- hf:openbmb/MiniCPM3-4B.

62L d_model=2560 40H (kv=40 via MLA latent) d_ff=6400 vocab=73448.
MLA dims follow the HF config: q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v_head=64.  Pure full attention -> long_500k skipped
(DESIGN.md Sec. 5; the MLA latent cache is small but attention is full).
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    rope_theta=10000.0,
    remat="block",
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG)
