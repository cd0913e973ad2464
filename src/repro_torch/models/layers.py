"""Shared neural-net layers (plain functions on tensors and dicts of tensors).

Conventions
-----------
* Activations ``[batch, seq, d_model]`` (attention internally ``[B, H, S, D]``).
* Linear weights are ``[d_in, d_out]`` and applied as ``x @ W``.
* All matmuls run in ``cfg.compute_dtype`` (bf16); softmax and norms
  accumulate in fp32.
* Attention has two implementations:
    - ``kernel`` : the hand-written CUDA flash-attention kernels (their plain
      versions on a CPU tensor), taken for prefill and for training, whose
      backward is the backward kernel;
    - ``dense``  : full [Sq, Skv] logits in torch ops, taken for the decode
      step and for whatever the kernel does not cover (explicit positions,
      softcap, a dynamic cache length).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF as _NEG_INF
from repro_torch.models.common import ModelConfig

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=device)}
    if cfg.norm != "rms":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE, partial RoPE)
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, rot_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...]: angles for rot_dim//2 frequencies -> cos/sin [..., rot_dim//2]."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=positions.device) / rot_dim
    inv_freq = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv_freq  # [..., rot_dim//2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [B, H, S, D]; positions: [B, S].  Rotates the first ``fraction`` of D.

    Uses the half-split convention (rotate_half), matching llama."""
    D = x.shape[-1]
    rot = int(D * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    cos, sin = _rope_angles(positions, rot, theta)          # [B, S, rot//2]
    cos = cos[:, None, :, :]                                 # [B, 1, S, rot//2]
    sin = sin[:, None, :, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < D else out


def rope_for(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None and positions.ndim == 3:
        raise NotImplementedError(
            "M-RoPE is not ported yet: it comes with the Qwen2-VL slice")
    if positions.ndim == 3:  # text-only batch through an mrope model
        positions = positions[:, 0]
    return apply_rope(x, positions, cfg.rope_theta, cfg.rope_fraction)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

_INT32_MAX = int(torch.iinfo(torch.int32).max)


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def attention_dense(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, Dv]
    *,
    causal: bool,
    q_positions: torch.Tensor,  # [Sq] absolute positions of queries
    kv_positions: torch.Tensor, # [Skv]
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    kv_len: Optional[int] = None,   # valid cache length
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    logits = logits * (1.0 / math.sqrt(D))
    logits = _softcap(logits, softcap)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_positions[:, None] >= kv_positions[None, :]
    if window is not None:
        mask &= q_positions[:, None] - kv_positions[None, :] < window
    if kv_len is not None:
        mask &= (torch.arange(Skv, device=q.device) < kv_len)[None, :]
    logits = torch.where(mask[None, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def attention(
    cfg: ModelConfig,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Dispatching attention core.  ``None`` positions mean ``arange``.

    The flash-attention kernel takes every call with more than one query,
    default positions, no softcap and no ``kv_len``; the decode step and the
    rest go through the dense path."""
    if cfg.attn_impl not in ("kernel", "dense"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    Sq, Skv = q.shape[2], k.shape[2]
    if (cfg.attn_impl == "kernel" and Sq > 1 and q_positions is None
            and kv_positions is None and cfg.attn_logit_softcap is None
            and kv_len is None):
        return flash_attention(q, k, v, causal=causal, window=window)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)
    return attention_dense(
        q, k, v, causal=causal, q_positions=q_positions,
        kv_positions=kv_positions, window=window,
        softcap=cfg.attn_logit_softcap, kv_len=kv_len)


# ---------------------------------------------------------------------------
# GQA attention block (projections + rope + core + out proj)
# ---------------------------------------------------------------------------


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                scale: Optional[float] = None, *, device) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * s).to(dtype)


def init_attn(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    hd = cfg.resolved_head_dim
    dt = cfg.param_dtype
    return {
        "wq": init_linear(generator, cfg.d_model, cfg.n_heads * hd, dt, device=device),
        "wk": init_linear(generator, cfg.d_model, cfg.n_kv_heads * hd, dt, device=device),
        "wv": init_linear(generator, cfg.d_model, cfg.n_kv_heads * hd, dt, device=device),
        "wo": init_linear(generator, cfg.n_heads * hd, cfg.d_model, dt,
                          scale=1.0 / math.sqrt(cfg.n_heads * hd * 2 * cfg.num_layers),
                          device=device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:    # [B,S,n*hd] -> [B,n,S,hd]
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:             # [B,n,S,hd] -> [B,S,n*hd]
    B, n, S, hd = x.shape
    return x.transpose(1, 2).reshape(B, S, n * hd)


def attn_block(
    cfg: ModelConfig, p: dict, x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_state: Optional[dict] = None,    # decode: {"k","v","len"} cache for this layer; len is an int
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Standard multi-head GQA attention.  Returns (out, new_kv_state).

    * prefill: kv_state None -> self-attention over x.
    * decode: kv_state holds the cache; x is the new token(s).  The cache
      tensors are updated IN PLACE and returned.
    * cross attention (whisper): cross_kv = (k, v) precomputed from encoder.

    ``positions``: ``None`` (consecutive from 0, or from the cache length when
    decoding; only this form lets prefill take the kernel), ``[S]``, ``[B, S]``
    or ``[B, 3, S]``.
    """
    dt = x.dtype
    B, S = x.shape[0], x.shape[1]
    q = _split_heads(x @ p["wq"].to(dt), cfg.n_heads)
    if cross_kv is not None:
        k, v = cross_kv
        out = attention(cfg, q, k, v, causal=False)
        new_state = None
    else:
        k = _split_heads(x @ p["wk"].to(dt), cfg.n_kv_heads)
        v = _split_heads(x @ p["wv"].to(dt), cfg.n_kv_heads)
        # Broadcast positions to the batched form for rope; masking uses the
        # 1-D positions of batch row 0 (temporal stream for mrope).
        if positions is None:
            start = 0 if kv_state is None else kv_state["len"]
            pos1 = torch.arange(start, start + S, device=x.device)
            posb = pos1[None].expand(B, S)
            qpos1 = None if kv_state is None else pos1
        else:
            posb = positions[None].expand(B, -1) if positions.ndim == 1 else positions
            qpos1 = posb[0] if posb.ndim == 2 else posb[0, 0]
        q = rope_for(cfg, q, posb)
        k = rope_for(cfg, k, posb)
        if kv_state is None:
            out = attention(cfg, q, k, v, causal=causal, window=window,
                            q_positions=qpos1, kv_positions=qpos1)
            new_state = {"k": k, "v": v}
        else:
            # append new kv at position ``len`` (ring for SWA windows)
            cache_k, cache_v, cur_len = kv_state["k"], kv_state["v"], kv_state["len"]
            S_cache = cache_k.shape[2]
            ring = window is not None and S_cache == window
            slot = cur_len % window if ring else cur_len
            cache_k[:, :, slot:slot + S] = k.to(cache_k.dtype)
            cache_v[:, :, slot:slot + S] = v.to(cache_v.dtype)
            # absolute positions of cache entries
            if ring:
                ring_idx = torch.arange(S_cache, device=x.device)
                abs_pos = cur_len - ((slot - ring_idx) % window)
                kvpos = torch.where(abs_pos >= 0, abs_pos, _INT32_MAX)
                kv_valid = None
            else:
                kvpos = torch.arange(S_cache, device=x.device)
                kv_valid = cur_len + S
            out = attention(cfg, q, cache_k.to(dt), cache_v.to(dt),
                            causal=True, window=window,
                            q_positions=qpos1, kv_positions=kvpos, kv_len=kv_valid)
            new_state = {"k": cache_k, "v": cache_v, "len": cur_len + S}
    y = _merge_heads(out) @ p["wo"].to(dt)
    return y, new_state


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------


def init_ffn(cfg: ModelConfig, generator: torch.Generator,
             d_ff: Optional[int] = None, *, device) -> dict:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    out_scale = 1.0 / math.sqrt(d_ff * 2 * cfg.num_layers)
    p = {}
    if cfg.act == "swiglu":
        p["w_gate"] = init_linear(generator, cfg.d_model, d_ff, dt, device=device)
    p["w_up"] = init_linear(generator, cfg.d_model, d_ff, dt, device=device)
    p["w_down"] = init_linear(generator, d_ff, cfg.d_model, dt, scale=out_scale,
                              device=device)
    return p


def ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    if cfg.act == "swiglu":
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
    else:
        u = x @ p["w_up"].to(dt)
        if cfg.act == "relu2":
            h = torch.square(F.relu(u.float())).to(dt)
        else:
            # the tanh form, which is what the JAX package's gelu computes
            h = F.gelu(u.float(), approximate="tanh").to(dt)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    tok = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                      dtype=torch.float32, device=device) * 0.02
    return {"tok": tok.to(cfg.param_dtype)}


def embed(cfg: ModelConfig, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens].to(cfg.compute_dtype)


def unembed(cfg: ModelConfig, p_embed: dict, p_head, x: torch.Tensor) -> torch.Tensor:
    w = p_embed["tok"].T if (cfg.tie_embeddings or p_head is None) else p_head
    logits = x @ w.to(x.dtype)
    return logits.float() if cfg.logits_fp32 else logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_weight: float = 1e-4) -> torch.Tensor:
    """Cross-entropy with z-loss; labels == -100 are masked.  fp32 accumulation."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    zl = torch.square(lse)
    mask = (labels >= 0).float()
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return torch.sum(nll * mask) / denom + z_weight * torch.sum(zl * mask) / denom


# ---------------------------------------------------------------------------
# Activation checkpointing (the JAX package's remat policies)
# ---------------------------------------------------------------------------

# "dots": products without batch dimensions are kept (x @ W folds to a 2-D
# mm); everything else, attention's batched products included, is recomputed
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(cfg: ModelConfig, fn: Callable, sublayer: bool = False) -> Callable:
    """Wrap ``fn`` in ``torch.utils.checkpoint`` per ``cfg.remat``; values
    are unchanged, only what the backward recomputes.

    ``fn`` is a layer body (``sublayer=False``) or the attention or FFN half
    of one (``sublayer=True``).  ``none``: no checkpoint.  ``full``: the whole
    layer is recomputed.  ``dots``: the layer is recomputed except the
    products without batch dimensions (``checkpoint_dots_with_no_batch_dims``).
    ``comm`` / ``comm_lite`` save the outputs of attention and FFN
    (``attn_out``, ``ffn_out``) and recompute the rest: on one device, each
    half checkpointed on its own.  (On a mesh the two also differ in keeping
    the gathered FSDP weights, which one device does not have.)"""
    if cfg.remat not in ("none", "full", "dots", "comm", "comm_lite"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if sublayer != (cfg.remat in ("comm", "comm_lite")) or cfg.remat == "none":
        return fn
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_products)
                  if cfg.remat == "dots" else None)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped
