"""Mixture-of-Experts transformers: Mixtral (GQA + sliding window) and
DeepSeek-V2-Lite (MLA), on one device.

* **Grouped dispatch**: the token stream is cut into ``G`` contiguous
  dispatch groups (``cfg.moe_dispatch_groups``, lowered until it divides the
  token count), each with its own expert capacity, so the tokens that
  capacity drops are the reference's.  The groups are a leading axis of one
  batched computation where the reference ``vmap``s.
* **Routing** is the reference's: fp32 router logits and softmax, top-k on
  the bf16-rounded probabilities, ties to the lowest expert index (a stable
  descending sort; ``torch.topk`` orders ties otherwise), gates from the fp32
  probabilities renormalised over the k chosen, a stable argsort of the
  chosen experts and per-expert slots from ``searchsorted``.
* **Deterministic**: every scatter writes distinct rows (dropped slots go to
  one discarded row) and each token's k expert outputs are gathered and
  summed over k, so two runs give the same bits, forward and backward.
* **MLA** (DeepSeek): the compressed cache ``{"c_kv", "k_rope"}`` and the
  reference's naive decode, which expands the whole cache every step.  Its
  prefill and training pass ``None`` positions where the reference passes
  ``arange``, so their attention takes the flash-attention kernel at MLA's
  head dims (q·k nope + rope, 192 at full width; v 128); its decode takes
  ``attention_dense``, as every family's does.  Mixtral's attention passes
  ``None`` positions too, so its prefill and training take the kernel.

On a device mesh the routed experts run ``_moe_ffn_shard_map``, the
reference's ``shard_map`` layer as an explicit local region.  Params are
plain dictionaries; ``params["layers"]`` is a list with one MoE layer each,
``params["dense_layers"]`` (DeepSeek's first layers, with a plain FFN) a list
too, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, register, resolve_device
from repro_torch.parallel.activations import shard_acts

# ---------------------------------------------------------------------------
# Routed expert FFN
# ---------------------------------------------------------------------------


def init_moe_ffn(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)

    def randn(*shape, scale, dtype):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)

    p = {
        "router": randn(d, E, scale=scale_in, dtype=torch.float32),
        "w_gate": randn(E, d, f, scale=scale_in, dtype=cfg.param_dtype),
        "w_up": randn(E, d, f, scale=scale_in, dtype=cfg.param_dtype),
        "w_down": randn(E, f, d, scale=scale_out, dtype=cfg.param_dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_ffn(cfg, generator, d_ff=cfg.n_shared_experts * f,
                                 device=device)
    return p


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert in a dispatch group of ``tokens_per_group`` tokens."""
    return int(math.ceil(tokens_per_group * cfg.top_k / cfg.n_experts
                         * cfg.capacity_factor))


def dispatch_groups(cfg: ModelConfig, n_tokens: int) -> int:
    """The number of dispatch groups for ``n_tokens`` tokens: the config's,
    at most one a token, lowered until it divides ``n_tokens``."""
    G = max(1, min(cfg.moe_dispatch_groups, n_tokens))
    while n_tokens % G:
        G -= 1
    return G


def route(cfg: ModelConfig, p: Dict, xg: torch.Tensor):
    """Router of groups ``xg`` [G, T, d] -> (probs [G, T, E] fp32, chosen
    experts [G, T, k], their gates [G, T, k] fp32).  The choice is made on
    the probabilities rounded to bf16, best first and ties to the lowest
    index (``jax.lax.top_k``'s order); the gates come from the fp32
    probabilities, renormalised over the k chosen."""
    with spans.span("moe.route"):
        logits = xg.float() @ p["router"].float()
        probs = torch.softmax(logits, dim=-1)
        order = torch.sort(probs.to(torch.bfloat16), dim=-1, descending=True,
                           stable=True).indices
        idx = order[..., :cfg.top_k]
        return probs, idx, gates(probs, idx)


def gates(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gates of the chosen experts ``idx`` [..., k]: their fp32
    probabilities, renormalised over the k chosen (the sum floored at
    1e-9)."""
    gate = torch.gather(probs, -1, idx)
    return gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)


def dispatch(cfg: ModelConfig, xg: torch.Tensor, idx: torch.Tensor, cap: int):
    """Tokens ``xg`` [G, T, d] to their experts' slots -> (buf [E, G*cap, d],
    each choice's row of buf [G, T*k]).

    The reference's sort-based dispatch, each group on its own: entry j of a
    group's T*k choices, in a stable sort by expert, takes slot
    ``j - start(expert)`` of its expert's ``cap`` when that is below ``cap``,
    and is dropped otherwise.  A dropped choice's row is the extra row
    ``E*G*cap``, which is discarded (its output is zero)."""
    with spans.span("moe.dispatch"):
        G, T, d = xg.shape
        E, k = cfg.n_experts, cfg.top_k
        flat_e = idx.reshape(G, T * k)
        order = torch.sort(flat_e, dim=-1, stable=True).indices            # [G, T*k]
        sorted_e = torch.gather(flat_e, 1, order)
        experts = torch.arange(E, device=xg.device).expand(G, E).contiguous()
        seg_start = torch.searchsorted(sorted_e, experts)                  # [G, E]
        pos = torch.arange(T * k, device=xg.device) - torch.gather(seg_start, 1, sorted_e)
        # one row per (expert, group, slot), experts outermost so that each
        # expert's rows are contiguous for its products
        groups = torch.arange(G, device=xg.device)[:, None]
        slot = torch.where(pos < cap, (sorted_e * G + groups) * cap + pos, E * G * cap)
        # entry j carries token order[j] // k: x repeated k times, permuted
        xk = xg[:, :, None, :].expand(G, T, k, d).reshape(G, T * k, d)
        xs = torch.gather(xk, 1, order[..., None].expand(G, T * k, d))
        buf = xg.new_zeros((E * G * cap + 1, d)).index_copy(
            0, slot.reshape(-1), xs.reshape(-1, d))
        # each token's k choices back in token order
        inv = torch.empty_like(order).scatter_(
            1, order, torch.arange(T * k, device=xg.device).expand(G, T * k))
        return buf[:-1].view(E, G * cap, d), torch.gather(slot, 1, inv)


def expert_products(p: Dict, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: buf [E, R, d] -> [E, R, d], in
    buf's type, SiLU in fp32."""
    with spans.span("moe.experts"):
        dt = buf.dtype
        g = torch.matmul(buf, p["w_gate"].to(dt))
        u = torch.matmul(buf, p["w_up"].to(dt))
        h = F.silu(g.float()).to(dt) * u
        return torch.matmul(h, p["w_down"].to(dt))


def combine(y: torch.Tensor, rows: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Un-dispatch: each token gathers the outputs of its k choices (``rows``
    of ``y`` [E, R, d]; a dropped choice gives zero), weighs them by its
    gates and sums them -> [G, T, d].  A gather and a sum over k, so the
    result has the same bits run to run; so has its gradient, whose
    ``index_add`` adds to each kept row once (only the discarded row, which
    every dropped choice reads, takes several)."""
    with spans.span("moe.combine"):
        G, T, k = gate.shape
        d = y.shape[-1]
        y = torch.cat([y.reshape(-1, d), y.new_zeros((1, d))])
        picked = torch.index_select(y, 0, rows.reshape(-1)).view(G, T, k, d)
        return (picked * gate.to(y.dtype)[..., None]).sum(dim=2)


def _dispatch(cfg: ModelConfig, p: Dict, xg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route every dispatch group.  xg: [G, T, d] -> (out [G, T, d], aux [G]):
    the reference's ``_dispatch_group`` over a leading group axis."""
    E = cfg.n_experts
    probs, idx, gate = route(cfg, p, xg)
    buf, rows = dispatch(cfg, xg, idx, capacity(cfg, xg.shape[1]))
    out = combine(expert_products(p, buf), rows, gate)
    # load-balancing aux (Switch-style), a group each
    frac_tokens = F.one_hot(idx, E).float().mean(dim=(1, 2))           # [G, E]
    frac_probs = probs.mean(dim=1)
    return out, E * torch.sum(frac_tokens * frac_probs, dim=-1)


def _moe_ffn_shard_map(cfg: ModelConfig, p: Dict, x, return_kept: bool = False):
    """The MoE layer on a mesh, every step explicit and local (the JAX
    package's ``shard_map`` layer), in ``activations.local_region``:

      * tokens stay on their data shard (the paper's locality principle);
      * expert weights: FSDP-sharded over data -> one all-gather a layer
        (backward: a reduce-scatter of the weight grads), tp-sharded on
        d_ff so the expert products are column-parallel;
      * one sum over ``model`` after the down-projection, whose backward is
        the identity (``collectives.psum_id_bwd``);
      * dispatch (sort/scatter) runs on local tokens only.

    Capacity pooling must not depend on the layout: the one-device path cuts
    the token stream into ``cfg.moe_dispatch_groups`` contiguous capacity
    groups, and each data shard holds a contiguous slice of that stream, so
    its slice is cut into ``moe_dispatch_groups / dp`` groups: the same
    boundaries, the same drops.

    Gradients: the dispatch path uses a tp rank's part of d_ff, so x's
    gradient through it is a partial sum over tp; the router path is the
    same on every tp rank, so x's gradient through it is whole there.  x
    enters the region twice, once with each.  With ``return_kept`` a third
    output, [B, S, k] bool, marks the choices that capacity kept."""
    from repro_torch.parallel import activations as A
    from repro_torch.parallel.collectives import fsdp_gather, psum_id_bwd
    from repro_torch.parallel.sharding import PartitionSpec as P
    st = A._STATE
    mesh, dp, tp, fsdp = st["mesh"], st["dp"], st["tp"], st["fsdp"]
    B, S, d = x.shape
    G_l = 1
    if cfg.moe_dispatch_groups % st["dp_size"] == 0:
        G_l = cfg.moe_dispatch_groups // st["dp_size"]
    tp_on = st["tp_size"] > 1
    dp_axes = dp if isinstance(dp, tuple) else (dp,)

    def body(xe, xr, router, wg, wu, wd):
        # xe, xr: [B_l, S, d]; wg/wu: [E, d(/fsdp), f_l]; wd: [E, f_l, d(/fsdp)]
        if fsdp is not None:
            wg = fsdp_gather(wg, 1, mesh, fsdp)
            wu = fsdp_gather(wu, 1, mesh, fsdp)
            wd = fsdp_gather(wd, 2, mesh, fsdp)
        T_l = xe.shape[0] * xe.shape[1]
        g = G_l
        while T_l % g:
            g -= 1
        xg_e = xe.reshape(g, T_l // g, d)
        xg_r = xr.reshape(g, T_l // g, d)
        probs, idx, gate = route(cfg, {"router": router}, xg_r)
        buf, rows = dispatch(cfg, xg_e, idx, capacity(cfg, T_l // g))
        y = expert_products({"w_gate": wg, "w_up": wu, "w_down": wd}, buf)
        if tp_on:
            y = psum_id_bwd(y, mesh, tp)
        out = combine(y, rows, gate)
        E = cfg.n_experts
        frac_tokens = F.one_hot(idx, E).float().mean(dim=(1, 2))
        aux = (E * torch.sum(frac_tokens * probs.mean(dim=1), dim=-1)).mean()
        aux = psum_id_bwd(aux, mesh, dp) / st["dp_size"]
        outs = (out.reshape(xe.shape), aux)
        if return_kept:
            dropped = E * g * capacity(cfg, T_l // g)
            outs += ((rows != dropped).reshape(xe.shape[0], S, cfg.top_k),)
        return outs

    x_s = P(dp)
    wgu_s, wd_s = P(None, fsdp, tp), P(None, tp, fsdp)

    def grad_of(spec):
        # a weight replicated over data is used by each data shard's tokens
        return spec if fsdp is not None else A.with_partial(spec, dp_axes[0])

    in_specs = (x_s, x_s, P(), wgu_s, wgu_s, wd_s)
    grad_specs = (A.with_partial(x_s, tp) if tp_on else x_s, x_s,
                  A.with_partial(P(), dp_axes[0]),
                  grad_of(wgu_s), grad_of(wgu_s), grad_of(wd_s))
    out_specs = (x_s, P()) + ((x_s,) if return_kept else ())
    return A.local_region(body, (x, x, p["router"], p["w_gate"], p["w_up"],
                                 p["w_down"]), in_specs, out_specs, grad_specs)


def moe_ffn(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out, aux): the routed experts over ``dispatch_groups``
    groups (aux averaged over them), plus the shared experts, if any.

    On a mesh (a DTensor x; ``B`` divisible by dp, ``S > 1``, ``d_ff_expert``
    divisible by tp) the routed experts run ``_moe_ffn_shard_map``, as the
    JAX package's ``moe_ffn`` decides.  The layer runs in the span ``moe``
    (``repro_torch.spans``), and ``route``, ``dispatch``, ``expert_products``
    and ``combine`` each in its own inside it: ``moe.route``, ``moe.dispatch``,
    ``moe.experts``, ``moe.combine``."""
    from repro_torch.parallel.activations import _STATE as _ACT, is_dtensor
    with spans.span("moe"):
        B, S, d = x.shape
        use_sm = (_ACT["mesh"] is not None and _ACT["dp"] is not None
                  and is_dtensor(x) and B % _ACT["dp_size"] == 0 and S > 1
                  and cfg.d_ff_expert % max(_ACT["tp_size"], 1) == 0)
        if use_sm:
            out, aux = _moe_ffn_shard_map(cfg, p, x)
        else:
            G = dispatch_groups(cfg, B * S)
            out, aux = _dispatch(cfg, p, x.reshape(G, (B * S) // G, d))
            out = out.reshape(B, S, d)
            aux = aux.mean()
        if cfg.n_shared_experts:
            out = out + L.ffn(cfg, p["shared"], x)
        return out, aux


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vdim, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    dt = cfg.param_dtype
    return {
        "wq": L.init_linear(generator, d, H * (nope + rope), dt, device=device),
        "w_dkv": L.init_linear(generator, d, lora + rope, dt, device=device),
        "w_uk": L.init_linear(generator, lora, H * nope, dt, device=device),
        "w_uv": L.init_linear(generator, lora, H * vdim, dt, device=device),
        "wo": L.init_linear(generator, H * vdim, d, dt,
                            scale=1.0 / math.sqrt(H * vdim * 2 * cfg.num_layers),
                            device=device),
    }


def _mla_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor, positions: torch.Tensor):
    """Project x to (q [B,H,S,nope+rope], c_kv [B,S,lora], k_rope
    [B,1,S,rope]).  positions: [S] absolute."""
    B, S, _ = x.shape
    H, nope = cfg.n_heads, cfg.qk_nope_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, -1).transpose(1, 2)
    posb = positions[None].expand(B, S)
    q = torch.cat([q[..., :nope], L.apply_rope(q[..., nope:], posb, cfg.rope_theta)],
                  dim=-1)
    dkv = x @ p["w_dkv"].to(dt)
    c_kv, k_rope = dkv[..., :cfg.kv_lora_rank], dkv[..., cfg.kv_lora_rank:]
    k_rope = L.apply_rope(k_rope[:, None], posb, cfg.rope_theta)
    return q, c_kv, k_rope


def _mla_expand(cfg: ModelConfig, p: Dict, c_kv: torch.Tensor, k_rope: torch.Tensor):
    """Expand the compressed cache to per-head K [B,H,S,nope+rope] and V
    [B,H,S,vdim].  c_kv [B,S,lora], k_rope [B,1,S,rope]."""
    with spans.span("mla.expand"):
        B, S, _ = c_kv.shape
        H = cfg.n_heads
        dt = c_kv.dtype
        k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(B, S, H, -1).transpose(1, 2)
        v = (c_kv @ p["w_uv"].to(dt)).reshape(B, S, H, -1).transpose(1, 2)
        k = torch.cat([k_nope, k_rope.expand(B, H, S, cfg.qk_rope_dim)], dim=-1)
        return k, v


def mla_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
              kv_state: Optional[Dict] = None):
    """Multi-head latent attention -> (out, new state).

    Positions are consecutive from 0, or from the cache's ``len`` when
    decoding.  Without a cache they are ``arange``, which the attention core
    gets as ``None`` (its default), so that it takes the flash-attention
    kernel; decoding passes them explicitly, as the reference does, and
    takes the dense path.  Decoding writes the new ``c_kv`` and ``k_rope``
    into the cache IN PLACE."""
    B, S, _ = x.shape
    start = 0 if kv_state is None else kv_state["len"]
    positions = torch.arange(start, start + S, device=x.device)
    q, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    if kv_state is None:
        k, v = _mla_expand(cfg, p, c_kv, k_rope)
        out = L.attention(cfg, q, k, v, causal=True)
        new_state = {"c_kv": c_kv, "k_rope": k_rope[:, 0], "len": None}
    else:
        cc, cr, cur = kv_state["c_kv"], kv_state["k_rope"], kv_state["len"]
        Smax = cc.shape[1]
        if cur + S > Smax:
            raise ValueError(
                f"decode writes positions {cur}..{cur + S - 1} past the end of "
                f"a cache of {Smax}: pad it first (launch.serve.pad_cache_to)")
        cc[:, cur:cur + S] = c_kv.to(cc.dtype)
        cr[:, cur:cur + S] = k_rope[:, 0].to(cr.dtype)
        k, v = _mla_expand(cfg, p, cc.to(x.dtype), cr.to(x.dtype)[:, None])
        out = L.attention(cfg, q, k, v, causal=True, q_positions=positions,
                          kv_positions=torch.arange(Smax, device=x.device),
                          kv_len=cur + S)
        new_state = {"c_kv": cc, "k_rope": cr, "len": cur + S}
    y = L._merge_heads(out) @ p["wo"].to(x.dtype)
    return y, new_state


# ---------------------------------------------------------------------------
# MoE transformer
# ---------------------------------------------------------------------------


def init_moe_layer(cfg: ModelConfig, generator: torch.Generator, device,
                   dense_ffn: bool = False) -> Dict:
    attn = (init_mla(cfg, generator, device) if cfg.kv_lora_rank
            else L.init_attn(cfg, generator, device))
    ff = (L.init_ffn(cfg, generator, d_ff=cfg.d_ff_dense or cfg.d_ff, device=device)
          if dense_ffn else init_moe_ffn(cfg, generator, device))
    return {"ln1": L.init_norm(cfg, cfg.d_model, device), "attn": attn,
            "ln2": L.init_norm(cfg, cfg.d_model, device), "ffn": ff}


def moe_layer_fwd(cfg: ModelConfig, lp: Dict, x: torch.Tensor, kv_state=None,
                  dense_ffn: bool = False):
    """One block -> (x, new kv state, aux).  Positions are consecutive from 0
    (from the cache's ``len`` when decoding).  Under autograd the attention
    half and the FFN half each run under ``remat_wrap``'s sublayer
    checkpoint (the ``comm`` policies; a no-op under the others)."""
    def attn_half(x):
        h = L.apply_norm(cfg, lp["ln1"], x)
        if cfg.kv_lora_rank:
            return mla_block(cfg, lp["attn"], h, kv_state=kv_state)
        return L.attn_block(cfg, lp["attn"], h, None, causal=True,
                            window=cfg.window, kv_state=kv_state)

    def ffn_half(x):
        h = L.apply_norm(cfg, lp["ln2"], x)
        if dense_ffn:
            return L.ffn(cfg, lp["ffn"], h), torch.zeros((), device=x.device)
        return moe_ffn(cfg, lp["ffn"], h)

    a, new_state = L.remat_wrap(cfg, attn_half, sublayer=True)(x)
    x = x + a
    f, aux = L.remat_wrap(cfg, ffn_half, sublayer=True)(x)
    return shard_acts(x + f), new_state, aux


def _cache_keys(cfg: ModelConfig) -> Tuple[str, str]:
    return ("c_kv", "k_rope") if cfg.kv_lora_rank else ("k", "v")


@register("moe")
class MoETransformer:
    """Public API: init / forward / logits / loss / prefill / decode_step /
    init_cache.

    The inference methods (``forward``, ``logits``, ``prefill``,
    ``decode_step``) run under ``torch.no_grad()``; ``loss`` runs the
    grad-enabled ``_forward``.  Under autograd each MoE layer runs under
    ``cfg.remat``; the dense layers do not, as in the reference, whose
    checkpoint covers the scan over the MoE layers only."""

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
        """Random parameters from ``generator``, which lives on ``device``.

        With no card, ``device`` left at its default raises: the CPU is taken
        only when the caller asks for it."""
        device = resolve_device(device)
        n_moe = cfg.num_layers - cfg.n_dense_layers
        params = {
            "embed": L.init_embed(cfg, generator, device),
            "layers": [init_moe_layer(cfg, generator, device) for _ in range(n_moe)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device),
        }
        if cfg.n_dense_layers:
            params["dense_layers"] = [
                init_moe_layer(cfg, generator, device, dense_ffn=True)
                for _ in range(cfg.n_dense_layers)]
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_linear(generator, cfg.d_model, cfg.vocab_size,
                                              cfg.param_dtype, device=device)
        return params

    @staticmethod
    def _forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor):
        """tokens [B,S] -> (final hidden [B,S,D], the MoE layers' aux summed),
        differentiable."""
        x = L.embed(cfg, params["embed"], tokens)
        for lp in params.get("dense_layers", []):
            x, _, _ = moe_layer_fwd(cfg, lp, x, dense_ffn=True)
        aux_total = torch.zeros((), device=x.device)
        for lp in params["layers"]:
            def body(x, lp=lp):
                y, _, aux = moe_layer_fwd(cfg, lp, x)
                return y, aux
            x, aux = L.remat_wrap(cfg, body)(x)
            aux_total = aux_total + aux
        return L.apply_norm(cfg, params["final_norm"], x), aux_total

    @staticmethod
    def _logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return L.unembed(cfg, params["embed"], params.get("lm_head"), hidden)

    @staticmethod
    @torch.no_grad()
    def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor):
        """tokens [B,S] -> (final hidden [B,S,D], aux)."""
        return MoETransformer._forward(cfg, params, tokens)

    @staticmethod
    @torch.no_grad()
    def logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return MoETransformer._logits(cfg, params, hidden)

    @staticmethod
    def loss(cfg: ModelConfig, params: Dict, batch: Dict):
        """Cross-entropy with z-loss plus ``router_aux_weight`` times the mean
        aux of the MoE layers -> (loss, {"loss", "xent", "aux"})."""
        hidden, aux = MoETransformer._forward(cfg, params, batch["tokens"])
        xent = L.softmax_xent(MoETransformer._logits(cfg, params, hidden),
                              batch["labels"])
        n_moe = cfg.num_layers - cfg.n_dense_layers
        loss = xent + cfg.router_aux_weight * aux / max(n_moe, 1)
        return loss, {"loss": loss, "xent": xent, "aux": aux}

    # -- inference ------------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> Dict:
        """``{"scan": {...}, "len": 0}`` and, with dense layers, ``"dense"``:
        MLA's ``c_kv`` [n, B, S, lora] and ``k_rope`` [n, B, S, rope], or
        ``k`` and ``v`` [n, B, Hkv, S, hd], S at most the window."""
        device = resolve_device(device)
        dt = cfg.compute_dtype
        if cfg.kv_lora_rank:
            def make(n):
                return {"c_kv": torch.zeros((n, batch, max_len, cfg.kv_lora_rank),
                                            dtype=dt, device=device),
                        "k_rope": torch.zeros((n, batch, max_len, cfg.qk_rope_dim),
                                              dtype=dt, device=device)}
        else:
            S = min(max_len, cfg.window) if cfg.window else max_len
            shape = (batch, cfg.n_kv_heads, S, cfg.resolved_head_dim)

            def make(n):
                return {"k": torch.zeros((n, *shape), dtype=dt, device=device),
                        "v": torch.zeros((n, *shape), dtype=dt, device=device)}
        cache = {"scan": make(cfg.num_layers - cfg.n_dense_layers), "len": 0}
        if cfg.n_dense_layers:
            cache["dense"] = make(cfg.n_dense_layers)
        return cache

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ModelConfig, params: Dict, batch: Dict):
        """Full forward returning (last-position logits, populated cache);
        the cache's ``len`` is a Python int.  Under a sliding window shorter
        than the prompt each layer keeps the window's last positions as a
        ring (slot = position % window)."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        key1, key2 = _cache_keys(cfg)
        x = L.embed(cfg, params["embed"], tokens)
        cache = {"len": S}
        for name, dense_ffn in (("dense", True), ("scan", False)):
            layers = params.get("dense_layers" if dense_ffn else "layers", [])
            c1, c2 = [], []
            for lp in layers:
                x, st, _ = moe_layer_fwd(cfg, lp, x, dense_ffn=dense_ffn)
                a, b = st[key1], st[key2]
                if not cfg.kv_lora_rank and cfg.window and S > cfg.window:
                    a = torch.roll(a[:, :, -cfg.window:], shifts=S % cfg.window, dims=2)
                    b = torch.roll(b[:, :, -cfg.window:], shifts=S % cfg.window, dims=2)
                c1.append(a)
                c2.append(b)
            if layers:
                cache[name] = {key1: torch.stack(c1), key2: torch.stack(c2)}
        hidden = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        return MoETransformer._logits(cfg, params, hidden), cache

    @staticmethod
    @torch.no_grad()
    def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
        """tokens [B,1] + cache -> (logits [B,1,V], cache).  The cache's
        tensors are written IN PLACE; the returned dictionary holds the same
        tensors and the new ``len``."""
        tokens = batch["tokens"]
        cur = cache["len"]
        key1, key2 = _cache_keys(cfg)
        x = L.embed(cfg, params["embed"], tokens)
        for name, dense_ffn in (("dense", True), ("scan", False)):
            layers = params.get("dense_layers" if dense_ffn else "layers", [])
            for i, lp in enumerate(layers):
                st = {key1: cache[name][key1][i], key2: cache[name][key2][i], "len": cur}
                x, _, _ = moe_layer_fwd(cfg, lp, x, kv_state=st, dense_ffn=dense_ffn)
        hidden = L.apply_norm(cfg, params["final_norm"], x)
        return (MoETransformer._logits(cfg, params, hidden),
                {**cache, "len": cur + tokens.shape[1]})
