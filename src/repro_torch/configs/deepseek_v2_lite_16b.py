"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

27L, d_model=2048, 16H MLA (kv_lora=512, rope 64, nope 128, v 128),
64 routed experts top-6 + 2 shared (d_ff_expert=1408), first layer dense
(d_ff=10944), vocab=102400.  (DeepSeek-V2 itself has 160 routed experts;
Lite has 64.)
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400,
    rope_theta=10000.0,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    n_dense_layers=1, d_ff_dense=10944,
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    capacity_factor=1.25,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512,
        n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=64,
        n_dense_layers=1, d_ff_dense=256, moe_dispatch_groups=8,
        kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
