"""The port's ``moe`` family run as DeepSeek-V2: its ``ModelConfig`` from a
configuration file of ``bench/configs``."""
from __future__ import annotations


def port_config(conf: dict):
    from repro_torch.configs import get_config
    return get_config(conf["port_arch"]).replace(
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"], n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["moe_intermediate_size"], vocab_size=conf["vocab_size"],
        rope_theta=float(conf["rope_theta"]),
        n_experts=conf["n_routed_experts"], top_k=conf["num_experts_per_tok"],
        n_shared_experts=conf["n_shared_experts"],
        d_ff_expert=conf["moe_intermediate_size"],
        n_dense_layers=conf["first_k_dense_replace"],
        d_ff_dense=conf["intermediate_size"], kv_lora_rank=conf["kv_lora_rank"],
        qk_nope_dim=conf["qk_nope_head_dim"], qk_rope_dim=conf["qk_rope_head_dim"],
        v_head_dim=conf["v_head_dim"], capacity_factor=conf["capacity_factor"],
        moe_dispatch_groups=conf["moe_dispatch_groups"],
        router_aux_weight=conf["router_aux_weight"],
        param_dtype=conf["param_dtype"], compute_dtype=conf["param_dtype"],
        remat=conf["remat"])


def cache_of(cache: dict):
    """The port's prefill cache as [(c_kv [B, S, lora], k_rope [B, S, rope])]
    for each layer, dense layers first."""
    out = []
    for part in ("dense", "scan"):
        if part in cache:
            out += list(zip(cache[part]["c_kv"].unbind(0), cache[part]["k_rope"].unbind(0)))
    return out
