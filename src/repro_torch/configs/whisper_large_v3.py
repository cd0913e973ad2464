"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280, 20H (MHA), d_ff=5120,
vocab=51866, GELU, LayerNorm, absolute positions (no rope).  The conv/mel
frontend is a stub: inputs are precomputed frame embeddings.  Assigned
``seq_len`` = encoder frames; decoder length = seq_len // 4.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-large-v3",
    family="encdec",
    num_layers=32,
    enc_layers=32, dec_layers=32,
    d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866,
    act="gelu", norm="ln",
    rope_fraction=0.0,            # absolute positions
    max_target_positions=16384,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, enc_layers=2, dec_layers=2,
        d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, max_target_positions=256,
        param_dtype="float32", compute_dtype="float32", remat="none")
