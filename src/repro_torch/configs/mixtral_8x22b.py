"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

56L, d_model=6144, 48H (kv=8), expert d_ff=16384, vocab=32768, SWA window
4096.  ~141B total / ~39B active parameters.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768,
    rope_theta=1000000.0,
    window=4096,
    n_experts=8, top_k=2, d_ff_expert=16384,
    capacity_factor=1.25,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, window=64,
        n_experts=4, top_k=2, d_ff_expert=128, moe_dispatch_groups=2,
        param_dtype="float32", compute_dtype="float32", remat="none")
