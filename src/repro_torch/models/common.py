"""Shared model configuration and registry for the port.

Every model family is a class of static methods over plain dictionaries of
tensors:

* ``init(cfg, generator, device="cuda")``    -> params (a list of per-layer dicts)
* ``prefill(cfg, params, batch)``            -> (logits, cache)
* ``decode_step(cfg, params, cache, batch)`` -> (logits, cache)

``ModelConfig`` has the fields and defaults of the JAX package's, with torch
dtypes; ``attn_impl`` is ``"kernel"`` (the hand-written CUDA kernels wherever
they apply: attention and the SSD scan) or ``"dense"`` (torch ops only).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) else None
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return resolved


def resolve_device(device: Any = "cuda") -> torch.device:
    """The device to run on: ``cuda`` unless the caller names another.  A CUDA
    device that is not there raises; nothing carries on on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device 'cpu' (--device cpu) "
            "to run on the CPU on purpose")
    return device


@dataclass(frozen=True)
class ModelConfig:
    """Superset config covering all model families."""

    arch: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # -- attention ----------------------------------------------------------
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0        # stablelm partial rotary
    mrope_sections: Optional[Tuple[int, int, int]] = None   # qwen2-vl M-RoPE
    window: Optional[int] = None      # sliding-window attention (mixtral)
    attn_logit_softcap: Optional[float] = None

    # -- FFN ----------------------------------------------------------------
    act: str = "swiglu"               # swiglu | relu2 | gelu
    norm: str = "rms"                 # rms | ln
    parallel_residual: bool = False

    # -- embeddings ---------------------------------------------------------
    tie_embeddings: bool = False
    use_abs_pos: bool = False         # learned absolute positions (whisper dec)

    # -- MoE ------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0           # deepseek: first k layers use dense FFN
    d_ff_dense: int = 0               # width of those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_dispatch_groups: int = 16

    # -- MLA (deepseek) -------------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- SSM (mamba2 / zamba2) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # -- hybrid (zamba2) --------------------------------------------------------
    shared_attn_period: int = 0       # apply shared attn block every k layers

    # -- enc-dec (whisper) ------------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    max_target_positions: int = 8192

    # -- numerics ---------------------------------------------------------------
    # torch dtypes; their names ("float32") are accepted and resolved
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    # activation-checkpoint policy of the training path: none|full|dots
    remat: str = "full"
    # implementation of the kernel-backed cores: "kernel" (the hand-written
    # CUDA kernels wherever they apply: flash attention for prefill, the SSD
    # scan for a Mamba-2 prefill; decode and the cases they do not cover run
    # in torch ops) or "dense" (torch ops everywhere)
    attn_impl: str = "kernel"
    attn_row_parallel: bool = False
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    # logits in fp32 for loss stability
    logits_fp32: bool = True

    def __post_init__(self):
        object.__setattr__(self, "param_dtype", resolve_dtype(self.param_dtype))
        object.__setattr__(self, "compute_dtype",
                           resolve_dtype(self.compute_dtype))

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Any] = {}


def register(family: str):
    def deco(cls):
        _REGISTRY[family] = cls
        return cls
    return deco


def get_model(cfg: ModelConfig):
    """Return the model implementation class for ``cfg.family``."""
    # import for side-effect registration
    from repro_torch.models import (mamba2, moe, transformer, whisper,  # noqa: F401
                                    zamba2)
    if cfg.family in _REGISTRY:
        return _REGISTRY[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}; "
                     f"have {sorted(_REGISTRY)}")


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in JAX's order: dict keys
    sorted, lists in order.  Two trees of one structure give their leaves in
    the same order whatever order their dicts were built in."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    children = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else tree
    return [leaf for c in children for leaf in tree_leaves(c)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, visited in ``tree_leaves`` order; a new tree of the
    results."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def param_count(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))
