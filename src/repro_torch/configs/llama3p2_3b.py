"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-3B].

28L, d_model=3072, 24H (kv=8), d_ff=8192, vocab=128256, rope theta 500k,
tied embeddings.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
    attn_row_parallel=True,
    remat="comm",   # training-path policy: save collective outputs
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        param_dtype="float32", compute_dtype="float32", remat="none")
