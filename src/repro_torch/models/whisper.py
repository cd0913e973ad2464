"""Whisper-large-v3 style encoder-decoder backbone (arXiv:2212.04356).

The conv/mel frontend is a stub, as in the reference: ``batch["enc_embeds"]``
carries precomputed frame embeddings [B, S_enc, d] (what the two conv layers
would produce).  The decoder length of the assigned shapes is the encoder
frame count // 4.

Encoder: bidirectional self-attention + GELU FFN, sinusoidal positions.
Decoder: causal self-attention + cross-attention + GELU FFN, learned
positions.  No attention rotates (``rope_fraction`` 0), and every position is
consecutive from 0, so all three attentions pass ``None`` positions: the
encoder's, the decoder's and the cross-attention of prefill and training
take the flash-attention kernel, the decode step the dense path.  Params are
plain dictionaries; ``params["enc_layers"]`` and ``params["dec_layers"]`` are
lists with one dictionary per layer.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, register, resolve_device
from repro_torch.parallel.activations import shard_acts


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position embedding [length, channels] fp32."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def init_enc_layer(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {"ln1": L.init_norm(cfg, cfg.d_model, device),
            "attn": L.init_attn(cfg, generator, device),
            "ln2": L.init_norm(cfg, cfg.d_model, device),
            "ffn": L.init_ffn(cfg, generator, device=device)}


def init_dec_layer(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "self_attn": L.init_attn(cfg, generator, device),
        "ln_x": L.init_norm(cfg, cfg.d_model, device),
        "cross_attn": L.init_attn(cfg, generator, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "ffn": L.init_ffn(cfg, generator, device=device),
    }


def _no_rope(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(rope_fraction=0.0)     # whisper uses absolute positions


def _remat(cfg: ModelConfig, body):
    """A layer body under ``cfg.remat``; under the ``comm`` policies the
    whole layer, as ``Mamba2LM``'s (the reference checkpoints the layer and
    saves only attention and FFN outputs)."""
    return L.remat_wrap(cfg, body, sublayer=cfg.remat in ("comm", "comm_lite"))


def encode(cfg: ModelConfig, params: Dict, enc_embeds: torch.Tensor) -> torch.Tensor:
    """Frame embeddings [B, S_enc, d] -> encoder output [B, S_enc, d]."""
    S = enc_embeds.shape[1]
    cfg_nr = _no_rope(cfg)
    x = enc_embeds.to(cfg.compute_dtype)
    x = x + sinusoids(S, cfg.d_model, x.device).to(x.dtype)[None]
    for lp in params["enc_layers"]:
        def body(x, lp=lp):
            h = L.apply_norm(cfg, lp["ln1"], x)
            a, _ = L.attn_block(cfg_nr, lp["attn"], h, None, causal=False)
            x = x + a
            return shard_acts(
                x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, lp["ln2"], x)))
        x = _remat(cfg, body)(x)
    return L.apply_norm(cfg, params["enc_norm"], x)


def _cross_kv(cfg: ModelConfig, params: Dict,
              memory: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each decoder layer's cross K and V [B, Hkv, S_enc, hd] from the
    encoder output."""
    dt = memory.dtype
    ks, vs = [], []
    for lp in params["dec_layers"]:
        ks.append(L._split_heads(memory @ lp["cross_attn"]["wk"].to(dt), cfg.n_kv_heads))
        vs.append(L._split_heads(memory @ lp["cross_attn"]["wv"].to(dt), cfg.n_kv_heads))
    return ks, vs


def dec_layer_fwd(cfg: ModelConfig, lp: Dict, x: torch.Tensor, cross_k, cross_v,
                  kv_state=None):
    """One decoder layer -> (x, new self-attention kv state)."""
    cfg_nr = _no_rope(cfg)
    h = L.apply_norm(cfg, lp["ln1"], x)
    a, new_state = L.attn_block(cfg_nr, lp["self_attn"], h, None, causal=True,
                                kv_state=kv_state)
    x = x + a
    h = L.apply_norm(cfg, lp["ln_x"], x)
    c, _ = L.attn_block(cfg_nr, lp["cross_attn"], h, cross_kv=(cross_k, cross_v))
    x = x + c
    x = x + L.ffn(cfg, lp["ffn"], L.apply_norm(cfg, lp["ln2"], x))
    return shard_acts(x), new_state


def _unembed(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
    # whisper ties the decoder's embeddings
    return L.unembed(cfg.replace(tie_embeddings=True), params["embed"], None, hidden)


@register("encdec")
class WhisperModel:
    """Public API: init / decode_fwd / loss / prefill / decode_step /
    init_cache (and the module's ``encode``).

    ``prefill`` and ``decode_step`` run under ``torch.no_grad()``; ``loss``
    runs with grad, each encoder and decoder layer under ``cfg.remat``."""

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
        """Random parameters from ``generator``, which lives on ``device``.

        With no card, ``device`` left at its default raises: the CPU is taken
        only when the caller asks for it."""
        device = resolve_device(device)
        pos = torch.randn((cfg.max_target_positions, cfg.d_model), generator=generator,
                          dtype=torch.float32, device=device) * 0.01
        return {
            "embed": L.init_embed(cfg, generator, device),   # decoder tokens
            "pos_embed": pos.to(cfg.param_dtype),
            "enc_layers": [init_enc_layer(cfg, generator, device)
                           for _ in range(cfg.enc_layers)],
            "enc_norm": L.init_norm(cfg, cfg.d_model, device),
            "dec_layers": [init_dec_layer(cfg, generator, device)
                           for _ in range(cfg.dec_layers)],
            "final_norm": L.init_norm(cfg, cfg.d_model, device),
        }

    @staticmethod
    def decode_fwd(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                   memory: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] attending to ``memory`` -> final hidden [B,S,D]."""
        S = tokens.shape[1]
        x = L.embed(cfg, params["embed"], tokens)
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
        ck, cv = _cross_kv(cfg, params, memory)
        for lp, k, v in zip(params["dec_layers"], ck, cv):
            def body(x, lp=lp, k=k, v=v):
                return dec_layer_fwd(cfg, lp, x, k, v)[0]
            x = _remat(cfg, body)(x)
        return L.apply_norm(cfg, params["final_norm"], x)

    @staticmethod
    def loss(cfg: ModelConfig, params: Dict, batch: Dict):
        """Cross-entropy with z-loss of ``batch`` ({"enc_embeds", "tokens",
        "labels"}) -> (loss, {"loss": loss})."""
        memory = encode(cfg, params, batch["enc_embeds"])
        hidden = WhisperModel.decode_fwd(cfg, params, batch["tokens"], memory)
        loss = L.softmax_xent(_unembed(cfg, params, hidden), batch["labels"])
        return loss, {"loss": loss}

    # -- inference ----------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   enc_len: int = 1500, device="cuda") -> Dict:
        device = resolve_device(device)
        hd, Ld = cfg.resolved_head_dim, cfg.dec_layers

        def zeros(S):
            return torch.zeros((Ld, batch, cfg.n_kv_heads, S, hd),
                               dtype=cfg.compute_dtype, device=device)
        return {"k": zeros(max_len), "v": zeros(max_len),
                "cross_k": zeros(enc_len), "cross_v": zeros(enc_len), "len": 0}

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ModelConfig, params: Dict, batch: Dict):
        """Encode, then the teacher-forced decoder prefill -> (last-position
        logits, cache).  The cache is ``{"k", "v": [Ld, B, Hkv, S, hd],
        "cross_k", "cross_v": [Ld, B, Hkv, S_enc, hd], "len": S}``; ``len``
        is a Python int."""
        memory = encode(cfg, params, batch["enc_embeds"])
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = L.embed(cfg, params["embed"], tokens)
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
        ck, cv = _cross_kv(cfg, params, memory)
        ks, vs = [], []
        for lp, k, v in zip(params["dec_layers"], ck, cv):
            x, st = dec_layer_fwd(cfg, lp, x, k, v)
            ks.append(st["k"])
            vs.append(st["v"])
        hidden = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        logits = _unembed(cfg, params, hidden)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "cross_k": torch.stack(ck), "cross_v": torch.stack(cv), "len": S}
        return logits, cache

    @staticmethod
    @torch.no_grad()
    def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
        """tokens [B,1] + cache -> (logits [B,1,V], cache).

        The cache's ``k`` and ``v`` are written IN PLACE; the learned
        position embedding is sliced at the host-side ``len`` (the reference
        slices at the traced one).  A step past the end of that table raises
        (the reference clamps the slice's start, so every later token reuses
        its last row)."""
        tokens = batch["tokens"]
        S1 = tokens.shape[1]
        cur = cache["len"]
        table = params["pos_embed"].shape[0]
        if cur + S1 > cfg.max_target_positions:
            raise ValueError(
                f"decode at positions {cur}..{cur + S1 - 1} is past "
                f"max_target_positions {cfg.max_target_positions} (the learned "
                f"position table has {table} rows)")
        x = L.embed(cfg, params["embed"], tokens)
        x = x + params["pos_embed"][cur:cur + S1].to(x.dtype)[None]
        for i, lp in enumerate(params["dec_layers"]):
            st = {"k": cache["k"][i], "v": cache["v"][i], "len": cur}
            x, _ = dec_layer_fwd(cfg, lp, x, cache["cross_k"][i], cache["cross_v"][i],
                                 kv_state=st)
        hidden = L.apply_norm(cfg, params["final_norm"], x)
        logits = _unembed(cfg, params, hidden)
        out = dict(cache)
        out["len"] = cur + S1
        return logits, out
