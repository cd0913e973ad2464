"""nemotron-4-15b — dense GQA, squared-ReLU FFN, LayerNorm [arXiv:2402.16819].

32L, d_model=6144, 48H (kv=8), d_ff=24576, vocab=256000.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab_size=256000,
    act="relu2", norm="ln",
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none")
