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
    """One block -> (x, new kv state).  Under autograd the attention half and
    the FFN half each run under ``remat_wrap``'s sublayer checkpoint (the
    ``comm`` policies; a no-op under the others and without grad)."""
    def attn_half(x):
        h = L.apply_norm(cfg, lp["ln1"], x)
        return L.attn_block(cfg, lp["attn"], h, positions, causal=True,
                            window=window, kv_state=kv_state)

    def ffn_half(x):
        # a parallel-residual block feeds the FFN the attention's norm of x
        norm = lp["ln1"] if cfg.parallel_residual else lp["ln2"]
        return L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, norm, x))

    attn_half = L.remat_wrap(cfg, attn_half, sublayer=True)
    ffn_half = L.remat_wrap(cfg, ffn_half, sublayer=True)
    a, new_state = attn_half(x)
    if cfg.parallel_residual:
        return x + a + ffn_half(x), new_state
    x = x + a
    return x + ffn_half(x), new_state


@register("dense")
class DenseTransformer:
    """Public API: init / forward / logits / loss / prefill / decode_step /
    init_cache.

    The inference methods (``forward``, ``logits``, ``prefill``,
    ``decode_step``) run under ``torch.no_grad()``; ``loss`` runs the
    grad-enabled ``_forward`` and ``_logits``."""

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
    def _forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D], differentiable; each layer
        under ``cfg.remat`` when grad mode is on."""
        x = L.embed(cfg, params["embed"], tokens)
        for lp in params["layers"]:
            def body(x, lp=lp):
                return layer_fwd(cfg, lp, x, positions, window=cfg.window)[0]
            x = L.remat_wrap(cfg, body)(x)
        return L.apply_norm(cfg, params["final_norm"], x)

    @staticmethod
    def _logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return L.unembed(cfg, params["embed"], params.get("lm_head"), hidden)

    @staticmethod
    @torch.no_grad()
    def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D]."""
        return DenseTransformer._forward(cfg, params, tokens, positions)

    @staticmethod
    @torch.no_grad()
    def logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return DenseTransformer._logits(cfg, params, hidden)

    @staticmethod
    def loss(cfg: ModelConfig, params: Dict, batch: Dict):
        """Next-token cross-entropy with z-loss of ``batch`` ({"tokens",
        "labels"[, "positions"]}) -> (loss, {"loss": loss})."""
        hidden = DenseTransformer._forward(cfg, params, batch["tokens"],
                                           batch.get("positions"))
        logits = DenseTransformer._logits(cfg, params, hidden)
        loss = L.softmax_xent(logits, batch["labels"])
        return loss, {"loss": loss}

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
