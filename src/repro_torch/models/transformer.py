"""Dense decoder-only GQA transformer (llama3.2 / tinyllama / stablelm / nemotron).

Params are plain dictionaries; ``params["layers"]`` is a list with one
dictionary per layer, consumed by a Python loop.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, register, resolve_device


def init_layer(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": L.init_attn(cfg, generator, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "ffn": L.init_ffn(cfg, generator, device=device),
    }


def layer_fwd(cfg: ModelConfig, lp: Dict, x: torch.Tensor, positions,
              kv_state=None, window=None):
    h = L.apply_norm(cfg, lp["ln1"], x)
    a, new_state = L.attn_block(cfg, lp["attn"], h, positions,
                                causal=True, window=window, kv_state=kv_state)
    if cfg.parallel_residual:
        f = L.ffn(cfg, lp["ffn"], h)
        x = x + a + f
    else:
        x = x + a
        x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, lp["ln2"], x))
    return x, new_state


@register("dense")
class DenseTransformer:
    """Public API: init / forward / logits / prefill / decode_step / init_cache.

    The inference methods run under ``torch.no_grad()``."""

    # -- params -----------------------------------------------------------
    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
        """Random parameters from ``generator``, which lives on ``device``.

        With no card, ``device`` left at its default raises: the CPU is taken
        only when the caller asks for it."""
        device = resolve_device(device)
        params = {
            "embed": L.init_embed(cfg, generator, device),
            "layers": [init_layer(cfg, generator, device)
                       for _ in range(cfg.num_layers)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_linear(
                generator, cfg.d_model, cfg.vocab_size, cfg.param_dtype,
                device=device)
        return params

    # -- forward ------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D]."""
        x = L.embed(cfg, params["embed"], tokens)
        for lp in params["layers"]:
            x, _ = layer_fwd(cfg, lp, x, positions, window=cfg.window)
        return L.apply_norm(cfg, params["final_norm"], x)

    @staticmethod
    @torch.no_grad()
    def logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return L.unembed(cfg, params["embed"], params.get("lm_head"), hidden)

    # -- inference ------------------------------------------------------------
    @staticmethod
    def cache_len(cfg: ModelConfig, max_len: int) -> int:
        return min(max_len, cfg.window) if cfg.window else max_len

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda") -> Dict:
        device = resolve_device(device)
        hd = cfg.resolved_head_dim
        S = DenseTransformer.cache_len(cfg, max_len)
        shape = (cfg.num_layers, batch, cfg.n_kv_heads, S, hd)
        return {
            "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "len": 0,
        }

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ModelConfig, params: Dict, batch: Dict):
        """Full forward returning (last-position logits, populated cache).

        The cache is ``{"k", "v": [L, B, Hkv, S, hd], "len": S}``; ``len`` is
        a Python int, so the decode loop never reads the device back."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        positions = batch.get("positions")
        x = L.embed(cfg, params["embed"], tokens)
        ks, vs = [], []
        for lp in params["layers"]:
            x, st = layer_fwd(cfg, lp, x, positions, window=cfg.window)
            k, v = st["k"], st["v"]
            if cfg.window and S > cfg.window:
                # keep last `window` positions, ring-indexed (slot = pos % window)
                k = torch.roll(k[:, :, -cfg.window:], shifts=S % cfg.window, dims=2)
                v = torch.roll(v[:, :, -cfg.window:], shifts=S % cfg.window, dims=2)
            ks.append(k)
            vs.append(v)
        hidden = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        logits = DenseTransformer.logits(cfg, params, hidden)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs), "len": S}
        return logits, cache

    @staticmethod
    @torch.no_grad()
    def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
        """tokens [B,1] + cache -> (logits [B,1,V], cache).

        The cache's ``k`` and ``v`` are written IN PLACE (the JAX package
        returns new arrays); the returned dictionary holds the same tensors
        and the new ``len``."""
        tokens = batch["tokens"]
        S1 = tokens.shape[1]
        cur = cache["len"]
        x = L.embed(cfg, params["embed"], tokens)
        for i, lp in enumerate(params["layers"]):
            st = {"k": cache["k"][i], "v": cache["v"][i], "len": cur}
            x, _ = layer_fwd(cfg, lp, x, None, kv_state=st, window=cfg.window)
        hidden = L.apply_norm(cfg, params["final_norm"], x)
        logits = DenseTransformer.logits(cfg, params, hidden)
        return logits, {"k": cache["k"], "v": cache["v"], "len": cur + S1}
