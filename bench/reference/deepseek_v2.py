"""DeepSeek-V2 (arXiv:2405.04434) in plain PyTorch, float32, as the
configuration file states it: multi-head latent attention with a compressed
cache (no query compression), SwiGLU experts routed by softmax and top-k with
shared experts beside them, the first ``first_k_dense_replace`` layers dense.

Where the program departs from the published model the reference follows
the program, as the file lists each departure (``port_departures``, which
``cells.as_run`` puts in, and ``departures``): plain RoPE (``rope_scaling``
null), no norm on the compressed KV, gates renormalised over the chosen
experts, and the capacity of each expert in each of ``moe_dispatch_groups`` groups of
consecutive tokens, ``ceil(tokens * k / experts * capacity_factor)``, a
choice past it dropped in token order.  The choice of experts ranks the
probabilities rounded to bfloat16, ties to the lower index, as the file
states (``router_rank_dtype``).

Weights are the tree the benchmark hands over: ``embed/tok`` [V, d],
``dense_layers`` and ``layers`` (lists of {ln1, attn, ln2, ffn}),
``final_norm``, ``lm_head`` [d, V]; linear weights are [d_in, d_out].
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.reference.common import (causal_attention, layer, mm, rms_norm,
                                    rope, swiglu, train, xent)


def _f(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def mla(conf: dict, p: dict, x: torch.Tensor):
    """-> (out [B, S, d], c_kv [B, S, lora], k_rope [B, S, rope])."""
    if conf["rope_scaling"] is not None:
        raise NotImplementedError("the reference runs plain RoPE, as the program does")
    B, S, _ = x.shape
    H, nope, rdim = conf["num_attention_heads"], conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    vdim, lora = conf["v_head_dim"], conf["kv_lora_rank"]
    pos = torch.arange(S, device=x.device)
    q = mm(x, _f(p["wq"])).view(B, S, H, nope + rdim).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, conf["rope_theta"])], dim=-1)
    dkv = mm(x, _f(p["w_dkv"]))
    c_kv = dkv[..., :lora]
    k_rope = rope(dkv[..., lora:][:, None], pos, conf["rope_theta"])      # [B,1,S,r]
    k_nope = mm(c_kv, _f(p["w_uk"])).view(B, S, H, nope).transpose(1, 2)
    v = mm(c_kv, _f(p["w_uv"])).view(B, S, H, vdim).transpose(1, 2)
    k = torch.cat([k_nope, k_rope.expand(B, H, S, rdim)], dim=-1)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(nope + rdim))
    out = mm(o.transpose(1, 2).reshape(B, S, H * vdim), _f(p["wo"]))
    return out, c_kv, k_rope[:, 0]


def groups(conf: dict, n_tokens: int) -> int:
    g = max(1, min(conf["moe_dispatch_groups"], n_tokens))
    while n_tokens % g:
        g -= 1
    return g


def moe(conf: dict, p: dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed and shared experts of x [B, S, d] -> (out, the load-balancing
    term averaged over the groups)."""
    B, S, d = x.shape
    E, k = conf["n_routed_experts"], conf["num_experts_per_tok"]
    N = B * S
    G = groups(conf, N)
    T = N // G
    cap = math.ceil(T * k / E * conf["capacity_factor"])
    xf = x.reshape(N, d)
    probs = torch.softmax(mm(xf, _f(p["router"])), dim=-1)             # [N, E]
    ranked = probs.detach().to(getattr(torch, conf["router_rank_dtype"])).float()
    choice = torch.sort(ranked, dim=-1, descending=True, stable=True).indices[:, :k].contiguous()
    gate = torch.gather(probs, 1, choice)
    if conf["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    # slots: within each group, an expert's choices in token order
    onehot = F.one_hot(choice.view(G, T * k), E)                          # [G, T*k, E]
    slot = (onehot.cumsum(1) * onehot).sum(-1) - 1                        # [G, T*k]
    kept = (slot < cap).view(N, k)
    out = torch.zeros_like(xf)
    for e in range(E):
        tok, j = torch.nonzero((choice == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = xf[tok]
        y = mm(F.silu(mm(h, _f(p["w_gate"][e]))) * mm(h, _f(p["w_up"][e])),
               _f(p["w_down"][e]))
        out = out.index_add(0, tok, y * gate[tok, j][:, None])
    frac_tokens = F.one_hot(choice.view(G, T, k), E).float().mean(dim=(1, 2))   # [G, E]
    frac_probs = probs.view(G, T, E).mean(1)
    aux = (E * (frac_tokens * frac_probs).sum(-1)).mean()
    out = out.view(B, S, d)
    if conf["n_shared_experts"]:
        out = out + swiglu(x, {k_: _f(w) for k_, w in p["shared"].items()})
    return out, aux


def block(conf: dict, lp: dict, x: torch.Tensor, dense: bool):
    """One layer -> (x, c_kv, k_rope, aux)."""
    eps = conf["rms_norm_eps"]
    a, c_kv, k_rope = mla(conf, lp["attn"], rms_norm(x, _f(lp["ln1"]["scale"]), eps))
    x = x + a
    h = rms_norm(x, _f(lp["ln2"]["scale"]), eps)
    if dense:
        f, aux = swiglu(h, {k: _f(w) for k, w in lp["ffn"].items()}), x.new_zeros(())
    else:
        f, aux = moe(conf, lp["ffn"], h)
    return x + f, c_kv, k_rope, aux


def _layers(W: dict):
    return ([(lp, True) for lp in W.get("dense_layers", [])]
            + [(lp, False) for lp in W["layers"]])


def hidden_states(conf: dict, W: dict, tokens: torch.Tensor, keep_cache: bool = False):
    """tokens [B, S] -> (final hidden [B, S, d] after the norm, aux summed over
    the MoE layers, the cache {"c_kv", "k_rope"} of every layer or None)."""
    x = F.embedding(tokens, _f(W["embed"]["tok"]))
    aux_total = x.new_zeros(())
    cache: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for lp, dense in _layers(W):
        def body(x, lp=lp, dense=dense):
            return block(conf, lp, x, dense)
        x, c_kv, k_rope, aux = layer(body, x)
        aux_total = aux_total + aux
        if keep_cache:
            cache.append((c_kv.detach(), k_rope.detach()))
    h = rms_norm(x, _f(W["final_norm"]["scale"]), conf["rms_norm_eps"])
    return h, aux_total, (cache if keep_cache else None)


def loss(conf: dict, W: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross-entropy with the z-loss, plus ``router_aux_weight``
    times the MoE layers' mean load-balancing term."""
    h, aux, _ = hidden_states(conf, W, batch["tokens"])
    n_moe = conf["num_hidden_layers"] - conf["first_k_dense_replace"]
    return (xent(h, _f(W["lm_head"]), batch["labels"], conf["z_loss_weight"])
            + conf["router_aux_weight"] * aux / max(n_moe, 1))


@torch.no_grad()
def prefill(conf: dict, W: dict, tokens: torch.Tensor):
    """tokens [B, S] -> (last position's logits [B, V], [(c_kv [B, S, lora],
    k_rope [B, S, rope]) for each layer, dense layers first])."""
    h, _, cache = hidden_states(conf, W, tokens, keep_cache=True)
    logits = mm(h[:, -1], _f(W["lm_head"]))
    return logits, cache


def train_steps(conf: dict, weights, batches, device, sample) -> dict:
    return train(lambda W, b: loss(conf, W, b), weights, batches, conf["optimizer"], device,
                 sample)


def forward_flops(conf: dict, batch: int, seq: int, head_positions: int) -> float:
    """The model's operations for ``batch`` sequences of ``seq`` tokens, the
    output head at ``head_positions`` of each: every product of the active
    parameters (the chosen experts and the shared ones; no capacity drop
    counted) and causal attention over the pairs i >= j."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    nope, rdim, vdim = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"], conf["v_head_dim"]
    lora, E, k = conf["kv_lora_rank"], conf["n_routed_experts"], conf["num_experts_per_tok"]
    f, n_sh = conf["moe_intermediate_size"], conf["n_shared_experts"]
    tokens = batch * seq
    attn_proj = 2 * (d * H * (nope + rdim) + d * (lora + rdim) + lora * H * nope
                     + lora * H * vdim + H * vdim * d)
    attn_core = 2 * H * (nope + rdim + vdim) * batch * seq * (seq + 1) / 2
    dense_ffn = 2 * 3 * d * conf["intermediate_size"]
    moe_ffn = 2 * (d * E + 3 * d * f * (k + n_sh))
    n_dense = conf["first_k_dense_replace"]
    n_moe = conf["num_hidden_layers"] - n_dense
    per_token = (conf["num_hidden_layers"] * attn_proj + n_dense * dense_ffn
                 + n_moe * moe_ffn)
    head = 2 * d * conf["vocab_size"] * batch * head_positions
    return tokens * per_token + conf["num_hidden_layers"] * attn_core + head
