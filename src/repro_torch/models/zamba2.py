"""Zamba2-style hybrid: a Mamba-2 backbone and one *shared* attention block
applied before every ``cfg.shared_attn_period`` Mamba layers
(arXiv:2411.15242).

* the shared block's input is ``concat([hidden, original_embedding])``
  projected 2d -> d (Zamba's concatenation trick), then a pre-norm GQA
  attention and a SwiGLU MLP with ONE weight bank reused at every
  application;
* Zamba2's per-application LoRA deltas on the shared block are rank-8
  additive adapters, one per application site (``lora_a`` / ``lora_b``
  stacked on a leading axis of applications).

Positions are consecutive from 0 (from the cache length when decoding), so
the shared attention passes ``None`` and its prefill and training take the
flash-attention kernel; the Mamba layers take the SSD-scan kernel.  The
reference passes ``arange(S)``, which is the same thing.  Params are plain
dictionaries; ``params["layers"]`` is a list with one Mamba layer each.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, register, resolve_device
from repro_torch.models.mamba2 import (CONV_KEYS, Mamba2LM, init_mamba_layer,
                                       mamba_layer_fwd)
from repro_torch.parallel.activations import shard_acts

_LORA_RANK = 8
_STATE_KEYS = ("ssm", *CONV_KEYS)


def _segments(num_layers: int, period: int) -> List[int]:
    """Layer counts between successive shared-block applications."""
    sizes = []
    done = 0
    while done < num_layers:
        sizes.append(min(period, num_layers - done))
        done += sizes[-1]
    return sizes


def n_applications(cfg: ModelConfig) -> int:
    return len(_segments(cfg.num_layers, cfg.shared_attn_period))


def init_shared_block(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    napp = n_applications(cfg)
    hd = cfg.resolved_head_dim
    lora_a = torch.randn((napp, cfg.d_model, _LORA_RANK), generator=generator,
                         dtype=torch.float32, device=device) * 0.01
    return {
        "in_proj": L.init_linear(generator, 2 * cfg.d_model, cfg.d_model,
                                 cfg.param_dtype, device=device),
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": L.init_attn(cfg, generator, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
        "ffn": L.init_ffn(cfg, generator, device=device),
        # per-application LoRA on the attention output (Zamba2's adapters);
        # lora_b starts at zero, as in the reference
        "lora_a": lora_a.to(cfg.param_dtype),
        "lora_b": torch.zeros((napp, _LORA_RANK, cfg.n_heads * hd),
                              dtype=cfg.param_dtype, device=device),
    }


def shared_block_fwd(cfg: ModelConfig, sp: Dict, x: torch.Tensor, x0: torch.Tensor,
                     app_idx: int, kv_state=None):
    """The shared block at application ``app_idx`` -> (x + block, kv state)."""
    dt = x.dtype
    h = torch.cat([x, x0], dim=-1) @ sp["in_proj"].to(dt)
    hn = L.apply_norm(cfg, sp["ln1"], h)
    a, new_state = L.attn_block(cfg, sp["attn"], hn, None, causal=True,
                                kv_state=kv_state)
    # the LoRA delta, sliced to d_model as the reference does (its width is
    # n_heads * head_dim)
    la = sp["lora_a"][app_idx].to(dt)
    lb = sp["lora_b"][app_idx].to(dt)
    a = a + ((hn @ la) @ lb)[..., :cfg.d_model]
    h = h + a
    h = h + L.ffn(cfg, sp["ffn"], L.apply_norm(cfg, sp["ln2"], h))
    return shard_acts(x + h), new_state


@register("hybrid")
class Zamba2LM:
    """Public API: init / forward / logits / loss / prefill / decode_step /
    init_cache.

    The inference methods run under ``torch.no_grad()``; ``loss`` runs the
    grad-enabled ``_forward`` and ``_logits``.  Under autograd each Mamba
    layer runs under ``cfg.remat`` (as ``Mamba2LM``'s); the shared block
    does not, as in the reference, whose checkpoint covers the scan over the
    Mamba layers only."""

    @staticmethod
    def init(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> Dict:
        """Random parameters from ``generator``, which lives on ``device``.

        With no card, ``device`` left at its default raises: the CPU is taken
        only when the caller asks for it."""
        device = resolve_device(device)
        return {
            "embed": L.init_embed(cfg, generator, device),
            "layers": [init_mamba_layer(cfg, generator, device)
                       for _ in range(cfg.num_layers)],
            "shared": init_shared_block(cfg, generator, device),
            "final_norm": L.init_norm(cfg, cfg.d_model, device),
            "lm_head": L.init_linear(generator, cfg.d_model, cfg.vocab_size,
                                     cfg.param_dtype, device=device),
        }

    @staticmethod
    def _forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D], differentiable."""
        x0 = L.embed(cfg, params["embed"], tokens)
        x = x0
        whole_layer = cfg.remat in ("comm", "comm_lite")
        start = 0
        for app, size in enumerate(_segments(cfg.num_layers, cfg.shared_attn_period)):
            x, _ = shared_block_fwd(cfg, params["shared"], x, x0, app)
            for lp in params["layers"][start:start + size]:
                def body(x, lp=lp):
                    return mamba_layer_fwd(cfg, lp, x)[0]
                x = L.remat_wrap(cfg, body, sublayer=whole_layer)(x)
            start += size
        return L.apply_norm(cfg, params["final_norm"], x)

    @staticmethod
    def _logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return L.unembed(cfg, params["embed"], params.get("lm_head"), hidden)

    @staticmethod
    @torch.no_grad()
    def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D]."""
        return Zamba2LM._forward(cfg, params, tokens)

    @staticmethod
    @torch.no_grad()
    def logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return Zamba2LM._logits(cfg, params, hidden)

    @staticmethod
    def loss(cfg: ModelConfig, params: Dict, batch: Dict):
        """Next-token cross-entropy with z-loss -> (loss, {"loss": loss})."""
        hidden = Zamba2LM._forward(cfg, params, batch["tokens"])
        loss = L.softmax_xent(Zamba2LM._logits(cfg, params, hidden), batch["labels"])
        return loss, {"loss": loss}

    # -- inference ----------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda") -> Dict:
        """The Mamba layers' state and conv windows, and the shared
        attention's K and V for each application."""
        cache = Mamba2LM.init_cache(cfg, batch, max_len, device)
        shape = (n_applications(cfg), batch, cfg.n_kv_heads, max_len,
                 cfg.resolved_head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.compute_dtype,
                                      device=cache["ssm"].device)
        cache["attn_v"] = torch.zeros_like(cache["attn_k"])
        return cache

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ModelConfig, params: Dict, batch: Dict):
        """Full forward returning (last-position logits, cache).

        The cache is ``Mamba2LM``'s plus ``"attn_k"``, ``"attn_v"``:
        [n_applications, B, Hkv, S, hd]; ``len`` is a Python int."""
        tokens = batch["tokens"]
        x0 = L.embed(cfg, params["embed"], tokens)
        x = x0
        states = {key: [] for key in _STATE_KEYS}
        attn_k, attn_v = [], []
        start = 0
        for app, size in enumerate(_segments(cfg.num_layers, cfg.shared_attn_period)):
            x, st = shared_block_fwd(cfg, params["shared"], x, x0, app)
            attn_k.append(st["k"])
            attn_v.append(st["v"])
            for lp in params["layers"][start:start + size]:
                x, st = mamba_layer_fwd(cfg, lp, x)
                for key, val in states.items():
                    val.append(st[key])
            start += size
        hidden = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        logits = Zamba2LM.logits(cfg, params, hidden)
        cache = {key: torch.stack(val) for key, val in states.items()}
        cache.update(attn_k=torch.stack(attn_k), attn_v=torch.stack(attn_v),
                     len=tokens.shape[1])
        return logits, cache

    @staticmethod
    @torch.no_grad()
    def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
        """tokens [B,1] + cache -> (logits [B,1,V], cache).

        Every cache tensor is written IN PLACE (the JAX package returns new
        arrays); the returned dictionary holds the same tensors and the new
        ``len``."""
        tokens = batch["tokens"]
        cur = cache["len"]
        x0 = L.embed(cfg, params["embed"], tokens)
        x = x0
        start = 0
        for app, size in enumerate(_segments(cfg.num_layers, cfg.shared_attn_period)):
            kv = {"k": cache["attn_k"][app], "v": cache["attn_v"][app], "len": cur}
            x, _ = shared_block_fwd(cfg, params["shared"], x, x0, app, kv_state=kv)
            for i in range(start, start + size):
                st = {key: cache[key][i] for key in _STATE_KEYS}
                x, new = mamba_layer_fwd(cfg, params["layers"][i], x, state=st)
                for key, val in st.items():
                    val.copy_(new[key])
            start += size
        hidden = L.apply_norm(cfg, params["final_norm"], x)
        logits = Zamba2LM.logits(cfg, params, hidden)
        out = {key: cache[key] for key in (*_STATE_KEYS, "attn_k", "attn_v")}
        out["len"] = cur + tokens.shape[1]
        return logits, out
