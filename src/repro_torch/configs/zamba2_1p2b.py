"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

38 mamba2 layers, d_model=2048; one SHARED attn(32H, kv=32)+MLP(d_ff=8192)
block applied every 6 layers (7 applications) with per-application LoRA;
vocab=32000, ssm_state=64.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    ssm_conv_width=4, ssm_chunk=256,
    shared_attn_period=6,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, ssm_state=16, ssm_headdim=16, ssm_chunk=32,
        shared_attn_period=2,
        param_dtype="float32", compute_dtype="float32", remat="none")
