"""Bridges between the JAX package's data and the port's, for the tests and
for anyone holding one package against the other.  Takes numpy arrays only,
so it imports no JAX."""
from __future__ import annotations

from typing import Any

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


def from_jax_params(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The JAX package's parameter tree (nested dicts of numpy arrays) as the
    port's.  The JAX tree stacks the layers on a leading axis of length
    ``num_layers``; the port keeps a list of per-layer dicts.  Linear weights
    are ``[d_in, d_out]`` on both sides, and every leaf keeps its type (the
    fp32 ``dt_bias``, ``A_log`` and ``D`` of a Mamba-2 block stay fp32 in a
    bf16 config).  The parameters land on ``device``
    (``cuda`` unless the caller names another; no card then raises)."""
    device = resolve_device(device)
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"parameter bridge for family {cfg.family!r} is not ported yet")
    params = _convert(tree, device)
    stacked = params["layers"]
    params["layers"] = [_unstack(stacked, i) for i in range(cfg.num_layers)]
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
    arrays, the per-layer list stacked on a leading axis of length
    ``num_layers``, so it can be compared leaf by leaf with a JAX tree."""
    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return to_numpy(tree)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} layers, config has "
                         f"{cfg.num_layers}")
    out = {k: convert(v) for k, v in params.items() if k != "layers"}
    out["layers"] = stack([convert(lp) for lp in params["layers"]])
    return out


def rel_err(a, b) -> float:
    """max|a - b| / (max|b| + 1e-9), in float32."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = to_numpy(b) if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    a, b = a.astype(np.float32), b.astype(np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))
