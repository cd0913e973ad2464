"""Parameter counting (total and active) per architecture config, the JAX
package's ``analysis/params.py`` on the port's ``ModelConfig``.

Analytic — no tensor allocation; held within 5 % of the meta parameter
trees of ``launch.specs.params_shapes`` and equal to the JAX package's counts
in tests/test_torch_analysis.py.
"""
from __future__ import annotations

from repro_torch.models.common import ModelConfig


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    if cfg.kv_lora_rank:    # MLA
        nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank)
        return (d * cfg.n_heads * (nope + rope) + d * (lora + rope)
                + lora * cfg.n_heads * (nope + vd) + cfg.n_heads * vd * d)
    return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _mamba_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    return (2 * d * di              # w_z, w_x
            + 2 * d * gn            # w_B, w_C
            + d * cfg.ssm_heads     # w_dt
            + di * d)               # w_out


def _moe_ffn_params(cfg: ModelConfig, active: bool) -> int:
    d, f, E, k = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.top_k
    routed = 3 * d * f * (k if active else E)
    shared = 3 * d * (cfg.n_shared_experts * f) if cfg.n_shared_experts else 0
    router = d * E
    return routed + shared + router


def param_count(cfg: ModelConfig, active: bool = False) -> int:
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    embed = V * d
    head = 0 if cfg.tie_embeddings else d * V
    if cfg.family in ("dense", "vlm"):
        per_layer = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        return embed + head + L * per_layer
    if cfg.family == "moe":
        moe_layers = L - cfg.n_dense_layers
        per_moe = _attn_params(cfg) + _moe_ffn_params(cfg, active)
        per_dense = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff_dense or cfg.d_ff)
        return embed + head + moe_layers * per_moe + cfg.n_dense_layers * per_dense
    if cfg.family == "ssm":
        return embed + d * V + L * _mamba_params(cfg)
    if cfg.family == "hybrid":
        shared = (2 * d * d + _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        return embed + d * V + L * _mamba_params(cfg) + shared
    if cfg.family == "encdec":
        enc = cfg.enc_layers * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        dec = cfg.dec_layers * (2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff))
        return embed + enc + dec
    raise ValueError(cfg.family)


def active_param_count(cfg: ModelConfig) -> int:
    return param_count(cfg, active=True)
