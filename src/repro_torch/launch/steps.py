"""Step factories: train / prefill / decode, shared by the launchers, the
examples and ``chip_smoke.py``.

``train_step`` does gradient accumulation over ``grad_accum`` microbatches:
the framework analogue of the paper's map tasks (each microbatch is one "map
task"; the gradient reduce-scatter + optimizer update is the "reduce" phase).

On a device mesh the params are DTensors (``parallel.sharding.
distribute_params``) and the step runs the model on DTensors: each
microbatch's batch dim is sharded over ``dp_entry``, and each microbatch's
gradients are redistributed to the params' placements (``grad_specs``, or
each param's own), the JAX package's ``constrain_grads``, which turns the
data-parallel all-reduce into a reduce-scatter onto FSDP shards.

The steps open spans (``repro_torch.spans``): ``prefill_step`` and
``decode_step`` around the whole step, ``train_step.forward`` around a train
step's forward and loss.  ``prefill_step`` and ``train_step.forward`` carry
the step's number in the process (``batch``, ``step``), a count kept on the
host.  The main thread opens no span while it waits for the backward, which
the autograd engine's thread runs: what the host was doing then is named by
that thread's op.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch import spans
from repro_torch.models.common import (ModelConfig, get_model, tree_leaves,
                                       tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.parallel.activations import is_dtensor


def loss_and_grads(cfg: ModelConfig, params, batch: Dict,
                   **ids) -> Tuple[torch.Tensor, List]:
    """The model's loss on ``batch`` and its gradients, one per leaf of
    ``params`` (``tree_leaves`` order), in each leaf's dtype.  The params'
    tensors themselves are left as they are: the graph runs on detached
    views that require grad.  ``ids`` go on the span ``train_step.forward``."""
    model = get_model(cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        with spans.span("train_step.forward", **ids):
            loss, _ = model.loss(cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (a parallel-residual block's ln2) has a
    # zero gradient, as in JAX
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    dp_entry=None, grad_specs=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss"}).

    Grads are cast to fp32; with ``grad_accum`` M > 1 the batch is split into
    M microbatches along its first axis, their grads summed in fp32 and
    divided by M, and their losses averaged.  The update is
    ``adamw_update``'s, in place.

    With DTensor params (a mesh) the batch holds the global batch, the same
    on every rank (plain tensors or DTensors); microbatch i is its rows
    ``[i*B/M, (i+1)*B/M)`` with the batch dim over ``dp_entry`` (default
    ``"data"``), as the JAX package constrains it.  The loss is a replicated
    DTensor."""

    def train_step(params, opt_state, batch):
        step = spans.count("train_step") - 1
        leaves = tree_leaves(params)
        if is_dtensor(leaves[0]):
            return _mesh_step(params, opt_state, batch, leaves, step)
        M = grad_accum
        if M <= 1:
            loss, grads = loss_and_grads(cfg, params, batch, step=step)
            grads = [g.float() for g in grads]
        else:
            mbs = [{k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(M)]
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for mb in mbs:
                lm, gm = loss_and_grads(cfg, params, mb, step=step)
                for acc, g in zip(grads, gm):
                    acc += g.float()
                loss = loss + lm
            grads = [g / M for g in grads]
            loss = loss / M
        params, opt_state = adamw_update(opt_cfg, params,
                                         tree_unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss}

    def _mesh_step(params, opt_state, batch, leaves, step):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.parallel.sharding import (PartitionSpec, placements,
                                                   shard_batch, spec_leaves)
        mesh = leaves[0].device_mesh
        targets = ([p.placements for p in leaves] if grad_specs is None else
                   [placements(s, mesh) for s in spec_leaves(grad_specs)])
        batch = {k: v.full_tensor() if is_dtensor(v) else v for k, v in batch.items()}
        M = max(grad_accum, 1)
        B = next(iter(batch.values())).shape[0]
        spec = PartitionSpec(dp_entry or "data")
        with implicit_replication():
            local, loss = None, 0.0
            for i in range(M):
                mb = {k: shard_batch(v[i * (B // M):(i + 1) * (B // M)], spec, mesh)
                      for k, v in batch.items()}
                lm, gm = loss_and_grads(cfg, params, mb, step=step)
                # constrain_grads: onto the params' shards, then summed there
                gm = [g.float().redistribute(mesh, t).to_local()
                      for g, t in zip(gm, targets)]
                local = gm if local is None else [a + g for a, g in zip(local, gm)]
                loss = loss + lm
            if M > 1:
                local = [g / M for g in local]
                loss = loss / M
            grads = [DTensor.from_local(g, mesh, t, run_check=False)
                     for g, t in zip(local, targets)]
            params, opt_state = adamw_update(opt_cfg, params,
                                             tree_unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    model = get_model(cfg)

    def prefill_step(params, batch):
        with spans.span("prefill_step", batch=spans.count("prefill_step") - 1):
            return model.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = get_model(cfg)

    def decode_step(params, cache, batch):
        with spans.span("decode_step"):
            return model.decode_step(cfg, params, cache, batch)

    return decode_step
