"""stablelm-3b — [hf:stabilityai/stablelm-2 family].

32L, d_model=2560, 32H (kv=32 = MHA), d_ff=6912, vocab=50304, LayerNorm,
partial rotary (25% of head_dim).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304,
    norm="ln",
    rope_theta=10000.0, rope_fraction=0.25,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none")
