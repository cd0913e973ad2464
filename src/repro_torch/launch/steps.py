"""Step factories: train / prefill / decode, shared by the launchers, the
examples and ``chip_smoke.py``.

``train_step`` does gradient accumulation over ``grad_accum`` microbatches:
the framework analogue of the paper's map tasks (each microbatch is one "map
task"; the optimizer update is the "reduce" phase).  The JAX package's
``dp_entry`` and ``grad_specs`` (sharding constraints for a data-parallel
mesh) have no counterpart until the port has a mesh (ROADMAP M12).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.models.common import (ModelConfig, get_model, tree_leaves,
                                       tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_update


def loss_and_grads(cfg: ModelConfig, params, batch: Dict) -> Tuple[torch.Tensor, List]:
    """The model's loss on ``batch`` and its gradients, one per leaf of
    ``params`` (``tree_leaves`` order), in each leaf's dtype.  The params'
    tensors themselves are left as they are: the graph runs on detached
    views that require grad."""
    model = get_model(cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = model.loss(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (a parallel-residual block's ln2) has a
    # zero gradient, as in JAX
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, grad_accum: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss"}).

    Grads are cast to fp32; with ``grad_accum`` M > 1 the batch is split into
    M microbatches along its first axis, their grads summed in fp32 and
    divided by M, and their losses averaged.  The update is
    ``adamw_update``'s, in place."""

    def train_step(params, opt_state, batch):
        M = grad_accum
        if M <= 1:
            loss, grads = loss_and_grads(cfg, params, batch)
            grads = [g.float() for g in grads]
        else:
            mbs = [{k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(M)]
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for mb in mbs:
                lm, gm = loss_and_grads(cfg, params, mb)
                for acc, g in zip(grads, gm):
                    acc += g.float()
                loss = loss + lm
            grads = [g / M for g in grads]
            loss = loss / M
        params, opt_state = adamw_update(opt_cfg, params,
                                         tree_unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    model = get_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = get_model(cfg)

    def decode_step(params, cache, batch):
        return model.decode_step(cfg, params, cache, batch)

    return decode_step
