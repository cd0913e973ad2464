"""The JAX package's layout of a parameter tree and of a training state.

The JAX package stacks the layers on a leading axis (``layers/wq`` of shape
``[L, ...]``); the port keeps a list of per-layer dicts (``layers/0/wq``).
Training state is checkpointed in the JAX layout, ``{"params", "opt": {"m",
"v", "step"}}`` with every per-layer list stacked, so that either package
restores what the other saved.  Leaves keep their type and device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig


def layer_lists(cfg: ModelConfig) -> Dict[str, int]:
    """The keys of the parameter tree that the JAX package stacks on a
    leading layer axis and the port keeps as lists, and their lengths.  An
    MoE model's ``dense_layers`` (DeepSeek's first layers, with a plain FFN)
    are a list in both packages and are not stacked."""
    if cfg.family in ("dense", "vlm", "ssm", "hybrid"):
        return {"layers": cfg.num_layers}
    if cfg.family == "moe":
        return {"layers": cfg.num_layers - cfg.n_dense_layers}
    if cfg.family == "encdec":
        return {"enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers}
    raise ValueError(f"unknown model family {cfg.family!r}")


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i].contiguous()


def stack_layers(cfg: ModelConfig, tree: dict) -> dict:
    """A tree in the parameters' structure (parameters, gradients, moments)
    in the JAX layout: each per-layer list stacked on a leading axis of its
    length.  Everything else is the same tensors."""
    lists = layer_lists(cfg)
    for key, n in lists.items():
        if len(tree[key]) != n:
            raise ValueError(f"{len(tree[key])} {key}, config has {n}")
    return {k: _stack(v) if k in lists else v for k, v in tree.items()}


def unstack_layers(cfg: ModelConfig, tree: dict) -> dict:
    """The inverse of ``stack_layers``: each stacked leaf split into the
    port's list of per-layer dicts (views of the stacked tensors)."""
    lists = layer_lists(cfg)
    return {k: [_index(v, i) for i in range(lists[k])] if k in lists else v
            for k, v in tree.items()}


def to_jax_train_state(cfg: ModelConfig, params: dict, opt: dict) -> dict:
    """Parameters and AdamW state as the JAX package's launcher checkpoints
    them: ``{"params", "opt": {"m", "v", "step"}}``, layers stacked.  The
    stacked leaves are new tensors on the state's device."""
    return {"params": stack_layers(cfg, params),
            "opt": {"m": stack_layers(cfg, opt["m"]),
                    "v": stack_layers(cfg, opt["v"]), "step": opt["step"]}}


def from_jax_train_state(cfg: ModelConfig, state: dict) -> Tuple[dict, dict]:
    """(params, opt) in the port's layout from ``to_jax_train_state``'s."""
    opt = state["opt"]
    return (unstack_layers(cfg, state["params"]),
            {"m": unstack_layers(cfg, opt["m"]), "v": unstack_layers(cfg, opt["v"]),
             "step": opt["step"]})
