"""Plain PyTorch pieces shared by the reference model families.

Everything here is written from the published descriptions and computes in
float32 with TF32 off (``strict_fp32``).  ``precision("fp8")`` turns every
product of the reference into one on float8 (e4m3) operands, each scaled by
its own largest magnitude: the control, a step below the bf16 that the
configurations state.  Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_STATE = {"precision": "fp32"}
_FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


@contextlib.contextmanager
def precision(name: str):
    """``fp32`` or ``fp8`` for the products inside the block."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {name!r}")
    saved = _STATE["precision"]
    _STATE["precision"] = name
    try:
        yield
    finally:
        _STATE["precision"] = saved


@contextlib.contextmanager
def strict_fp32():
    """float32 products in float32: no TF32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a scale that maps its largest magnitude to the
    format's; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = _FP8_MAX / amax
    q = (x.detach() * scale).to(_FP8).float() / scale
    return x + (q - x.detach())


def operand(x: torch.Tensor) -> torch.Tensor:
    """A product's operand at the current precision."""
    return _q8(x) if _STATE["precision"] == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return operand(a) @ operand(b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, H, S, D] by positions [S], the two halves
    of D rotated together (``rotate_half``)."""
    D = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                            dtype=torch.float32) / D)
    ang = positions.float()[:, None] * inv_freq[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention_rows(q, k, v, q0: int, scale: float):
    Sq, Skv = q.shape[2], k.shape[2]
    logits = mm(q, k.transpose(-1, -2)) * scale
    rows = torch.arange(q0, q0 + Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    logits = logits.masked_fill(cols > rows, float("-inf"))
    return mm(torch.softmax(logits, dim=-1), v)


def causal_attention(q, k, v, scale: float, block: int = 1024) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v over blocks of query rows, each
    recomputed in the backward pass: q, k [B, H, S, D], v [B, H, S, Dv]."""
    S = q.shape[2]
    outs = []
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        args = (q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1])
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attention_rows, *args, q0, scale, use_reentrant=False))
        else:
            outs.append(_attention_rows(*args, q0, scale))
    return torch.cat(outs, dim=2)


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return mm(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def _xent_rows(h, head, labels, z_weight):
    logits = mm(h, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    return torch.stack([((lse - gold) * mask).sum(), (lse.square() * mask).sum(),
                        mask.sum()])


def xent(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
         z_weight: float, block: int = 2048) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``z_weight`` times the mean squared
    log-partition, labels < 0 left out; the logits are made a block of rows
    at a time and recomputed in the backward pass."""
    h = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1)
    total = h.new_zeros(3)
    for r0 in range(0, h.shape[0], block):
        args = (h[r0:r0 + block], head, y[r0:r0 + block], z_weight)
        total = total + (checkpoint(_xent_rows, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _xent_rows(*args))
    denom = total[2].clamp_min(1.0)
    return total[0] / denom + z_weight * total[1] / denom


def layer(fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward pass when grad is on."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# trees and AdamW
# ---------------------------------------------------------------------------


def named(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf): dict keys sorted, lists in order, joined by ``/``."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = ([(k, tree[k]) for k in sorted(tree)] if isinstance(tree, dict)
             else list(enumerate(tree)))
    out = []
    for key, sub in items:
        out += named(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def rebuild(tree, fn: Callable, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], fn, f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    return [rebuild(v, fn, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio`` of ``lr`` at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    scale = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * scale


def train(loss_fn: Callable, weights, batches: List[dict], opt: dict, device,
          sample: Dict[str, torch.Tensor]) -> dict:
    """AdamW (decoupled weight decay, global-norm clipping) over ``batches``
    from ``weights`` (host tensors in their stored dtypes).  The master
    weights are float32 and are rounded to each leaf's stored dtype after
    every update, as the configuration stores them; the moments are float32.

    Returns each step's loss; each leaf's gradient at step 1 as the optimizer
    takes it (after clipping): its norm, its norm before clipping and its
    elements at ``sample``'s flat indices; each leaf's change over all the
    steps: its norm and its elements at the same indices."""
    names = [n for n, _ in named(weights)]
    stored = {n: w.dtype for n, w in named(weights)}
    params = [w.to(device, torch.float32, copy=True).requires_grad_()
              for _, w in named(weights)]
    index = {n: i for i, n in enumerate(names)}
    tree = rebuild(weights, lambda n, _: params[index[n]])
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, grad_norms, raw_norms, grad_sample = [], {}, {}, {}
    for t, batch in enumerate(batches, start=1):
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
        clip = torch.clamp_max(opt["clip_norm"] / gnorm.clamp_min(1e-9), 1.0)
        if t == 1:
            for n, g in zip(names, grads):
                raw_norms[n] = float(g.norm())
                grad_norms[n] = float(g.norm() * clip)
                grad_sample[n] = (g.reshape(-1)[sample[n].to(device)] * clip).cpu()
        lr = lr_at(opt, t)
        with torch.no_grad():
            for p, g, mi, vi, n in zip(params, grads, m, v, names):
                g = g * clip
                mi.mul_(b1).add_((1 - b1) * g)
                vi.mul_(b2).add_((1 - b2) * g.square())
                step = (mi / (1 - b1 ** t)) / (torch.sqrt(vi / (1 - b2 ** t)) + eps)
                p.sub_(lr * (step + wd * p))
                p.copy_(p.to(stored[n]).float())
        del grads
    change, change_sample = {}, {}
    with torch.no_grad():
        for (n, w0), p in zip(named(weights), params):
            d = p - w0.to(device).float()
            change[n] = float(d.norm())
            change_sample[n] = d.reshape(-1)[sample[n].to(device)].cpu()
    return {"losses": losses, "grad_norms": grad_norms, "raw_grad_norms": raw_norms,
            "grad_sample": grad_sample, "change_norms": change,
            "change_sample": change_sample}
