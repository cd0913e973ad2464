"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

28L, d_model=1536, 12H (kv=2), d_ff=8960, vocab=151936, head_dim=128,
M-RoPE sections (16, 24, 24).  The vision frontend is a stub: precomputed
patch embeddings + 3-D position ids come in through the batch.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, head_dim=32, mrope_sections=(4, 6, 6),
        param_dtype="float32", compute_dtype="float32", remat="none")
