"""Meta-tensor stand-ins for every (architecture × input-shape) cell.

Nothing is allocated: every tensor lives on the ``meta`` device (the port's
``jax.eval_shape``).  Shape semantics per the assignment:
  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> prefill_step
  decode_32k   seq=32768  global_batch=128   -> decode_step (1 new token, KV cache=seq)
  long_500k    seq=524288 global_batch=1     -> decode_step; sub-quadratic archs only

Whisper convention: assigned seq = encoder frames; decoder length =
seq // 4; decode cells use self-KV seq//4 + cross-KV seq.

``params_shapes`` runs the model's own ``init`` on ``meta`` with no
generator (a ``torch.Generator`` cannot live on ``meta``, and a meta tensor
holds no values to draw), so mixtral-8x22b's 140.6 B parameters take no
memory.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig, get_model

SHAPES: Dict[str, Tuple[str, int, int]] = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}

# archs with sub-quadratic attention state (SSM / hybrid / SWA) — the only
# ones that run long_500k
LONG_OK = {"mamba2-1.3b", "zamba2-1.2b", "mixtral-8x22b"}

META = torch.device("meta")


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, "pure full-attention arch: 500k KV infeasible (skip per brief)"
    return True, ""


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Abstract batch for the given cell (the model-input side)."""
    kind, S, B = SHAPES[shape_name]
    if cfg.family == "encdec":
        Sd = max(S // 4, 8)
        if kind == "train":
            return {"enc_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                    "tokens": _meta((B, Sd)), "labels": _meta((B, Sd))}
        if kind == "prefill":
            return {"enc_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                    "tokens": _meta((B, Sd))}
        return {"tokens": _meta((B, 1))}
    if kind == "train":
        out = {"tokens": _meta((B, S)), "labels": _meta((B, S))}
        if cfg.family == "vlm":
            out["positions"] = _meta((B, 3, S))
        return out
    if kind == "prefill":
        return {"tokens": _meta((B, S))}
    return {"tokens": _meta((B, 1))}


def cache_specs(cfg: ModelConfig, shape_name: str):
    """Abstract KV/state cache for decode cells (meta tensors)."""
    kind, S, B = SHAPES[shape_name]
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} cell, not a decode cell")
    model = get_model(cfg)
    if cfg.family == "encdec":
        return model.init_cache(cfg, B, max(S // 4, 8), enc_len=S, device=META)
    return model.init_cache(cfg, B, S, device=META)


def params_shapes(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors."""
    return get_model(cfg).init(cfg, None, META)


def default_grad_accum(cfg: ModelConfig, shape_name: str) -> int:
    """Microbatch count: keep per-µb logits+activations modest."""
    kind, S, B = SHAPES[shape_name]
    if kind != "train":
        return 1
    if cfg.arch == "mixtral-8x22b":
        return 16          # halves the per-µb activation footprint
    return 8 if B >= 64 else 1
