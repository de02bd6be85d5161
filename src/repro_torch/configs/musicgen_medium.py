"""musicgen-medium [audio] -- arXiv:2306.05284.

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings (B, S, d_model); the backbone is the
decoder-only transformer.  Full attention -> long_500k skipped.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    attn_kind="gqa", rope_theta=10000.0,
    frontend="frames",
    # SS Perf iteration (EXPERIMENTS.md): 48 MHA layers with no remat save
    # every intermediate for backward -> train_4k memory term 10.7 s;
    # block remat trades ~1.3x FLOPs for a ~4x bytes reduction.
    remat="block",
    supports_long_context=False,
)


def smoke():
    return reduced(CONFIG, frontend="frames")
