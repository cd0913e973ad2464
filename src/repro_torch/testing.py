"""Bridges between the JAX package's data and the port's, for the tests and
for anyone holding one package against the other.  Takes numpy arrays only,
so it imports no JAX."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, resolve_device


def to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor of the same type.  bfloat16 (which numpy
    holds as ``ml_dtypes.bfloat16``) goes through float32, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a copy: writable


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a float32 (or integer) numpy array."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i].contiguous()


def layer_lists(cfg: ModelConfig) -> Dict[str, int]:
    """The keys of the parameter tree that the JAX package stacks on a
    leading layer axis and the port keeps as lists, and their lengths."""
    if cfg.family in ("dense", "vlm", "ssm", "hybrid"):
        return {"layers": cfg.num_layers}
    if cfg.family == "encdec":
        return {"enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers}
    raise NotImplementedError(
        f"parameter bridge for family {cfg.family!r} is not ported yet")


def from_jax_params(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (nested dicts of numpy arrays) as the
    port's.  The JAX tree stacks the layers on a leading axis (``layers``;
    Whisper's ``enc_layers`` and ``dec_layers``); the port keeps a list of
    per-layer dicts.  Everything else keeps its layout: Zamba2's shared block
    with its ``lora_a`` / ``lora_b`` stacked per application, Whisper's
    ``pos_embed``.  Linear weights are ``[d_in, d_out]`` on both sides, and
    every leaf keeps its type (the fp32 ``dt_bias``, ``A_log`` and ``D`` of a
    Mamba-2 block stay fp32 in a bf16 config).  The parameters land on
    ``device`` (``cuda`` unless the caller names another; no card then
    raises)."""
    device = resolve_device(device)
    lists = layer_lists(cfg)
    params = _convert(tree, device)
    for key, n in lists.items():
        stacked = params[key]
        params[key] = [_unstack(stacked, i) for i in range(n)]
    return params


def from_jax_opt_state(cfg: ModelConfig, state: dict, device="cuda") -> dict:
    """The JAX package's AdamW state (``m`` and ``v`` in the parameter tree's
    layout, layers stacked; ``step``) as the port's: ``m`` and ``v`` as
    ``from_jax_params`` lays out parameters (fp32), ``step`` an int32 scalar
    tensor."""
    device = resolve_device(device)
    return {"m": from_jax_params(cfg, state["m"], device),
            "v": from_jax_params(cfg, state["v"], device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=device)}


def to_jax_layout(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameter tree (or a tree of the same structure: grads,
    moments) in the JAX package's layout: nested dicts of float32 numpy
    arrays, each per-layer list stacked on a leading axis of its length, so
    it can be compared leaf by leaf with a JAX tree."""
    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return to_numpy(tree)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    lists = layer_lists(cfg)
    for key, n in lists.items():
        if len(params[key]) != n:
            raise ValueError(f"{len(params[key])} {key}, config has {n}")
    out = {k: convert(v) for k, v in params.items() if k not in lists}
    for key in lists:
        out[key] = stack([convert(lp) for lp in params[key]])
    return out


def rel_err(a, b) -> float:
    """max|a - b| / (max|b| + 1e-9), in float32."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    a, b = a.astype(np.float32), b.astype(np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))
