"""Bridges between the JAX package's data and the port's, for the tests and
for anyone holding one package against the other.  Takes numpy arrays only,
so it imports no JAX."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.layout import layer_lists, stack_layers, unstack_layers
from repro_torch.models.common import ModelConfig, resolve_device

__all__ = ["to_torch", "to_numpy", "layer_lists", "from_jax_params",
           "from_jax_opt_state", "to_jax_layout", "rel_err"]


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
    return unstack_layers(cfg, _convert(tree, device))


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
    return convert(stack_layers(cfg, params))


def rel_err(a, b) -> float:
    """max|a - b| / (max|b| + 1e-9), in float32."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    a, b = a.astype(np.float32), b.astype(np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))
