"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385].

22L, d_model=2048, 32H (kv=4), d_ff=5632, vocab=32000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none")
