"""mamba2-1.3b — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L, d_model=2048, d_ff=0 (no MLP — mamba2 blocks only), vocab=50280,
ssm_state=128; expand=2 -> d_inner=4096, headdim=64 -> 64 SSM heads.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    n_heads=1, n_kv_heads=1, d_ff=0,          # attention-free
    vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    ssm_conv_width=4, ssm_chunk=256,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_chunk=32,
        param_dtype="float32", compute_dtype="float32", remat="none")
