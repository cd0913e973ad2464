"""Mamba-2 (state-space duality / SSD) language model.

The chunked SSD algorithm of arXiv:2405.21060 section 6: within a chunk the
recurrence is computed in its "attention" (quadratic) dual form, and chunk
boundary states are passed on by a linear scan.  Decode is the O(1) recurrent
update on a ``[B, H, P, N]`` state.

The scan of prefill and of training goes through the hand-written CUDA SSD
kernels (``kernels/ssd_scan``: the forward, which also returns the final state
that decode starts from, and under autograd the backward) when
``cfg.attn_impl == "kernel"``; with ``"dense"`` it runs the plain chunked
function in torch ops, and autograd differentiates those.  Params are plain
dictionaries; ``params["layers"]`` is a list with one dictionary per layer.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig, register, resolve_device
from repro_torch.parallel.activations import is_dtensor, shard_acts

# the plain chunked scan: (y [B,S,H,P], final_state [B,H,P,N] fp32)
ssd_chunked = ssd_chunked_ref

CONV_KEYS = ("conv_x", "conv_B", "conv_C")


def ssd_decode_step(
    x: torch.Tensor,       # [B, 1, H, P]
    dt: torch.Tensor,      # [B, 1, H]
    A: torch.Tensor,       # [H]
    B_: torch.Tensor,      # [B, 1, G, N]
    C: torch.Tensor,       # [B, 1, G, N]
    state: torch.Tensor,   # [B, H, P, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: (y [B,1,H,P] in x's type, new state fp32)."""
    H = x.shape[2]
    rep = H // B_.shape[2]
    xb = x[:, 0].float()                                        # [B,H,P]
    dtb = dt[:, 0].float()                                      # [B,H]
    Bb = torch.repeat_interleave(B_[:, 0], rep, dim=1).float()  # [B,H,N]
    Cb = torch.repeat_interleave(C[:, 0], rep, dim=1).float()
    decay = torch.exp(dtb * A.float()[None])                    # [B,H]
    new_state = (state * decay[..., None, None]
                 + (xb * dtb[..., None])[..., :, None] * Bb[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cb)
    return y[:, None].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------


def init_mamba_block(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    H, gn = cfg.ssm_heads, cfg.ssm_groups * cfg.ssm_state
    cw = cfg.ssm_conv_width
    pd, f32 = cfg.param_dtype, torch.float32
    # inverse softplus of dt in [1e-3, 0.1]
    dt_init = torch.log(torch.exp(torch.linspace(1e-3, 0.1, H, dtype=f32)) - 1.0)

    def linear(d_in, d_out, scale=None):
        return L.init_linear(generator, d_in, d_out, pd, scale, device=device)

    def conv(width):
        w = torch.randn((cw, width), generator=generator, dtype=f32, device=device)
        return (w / math.sqrt(cw)).to(pd)

    return {
        "w_z": linear(d, di),
        "w_x": linear(d, di),
        "w_B": linear(d, gn),
        "w_C": linear(d, gn),
        "w_dt": linear(d, H),
        "dt_bias": dt_init.to(device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),   # A = -exp(A_log)
        "D": torch.ones((H,), dtype=f32, device=device),
        "conv_x": conv(di),
        "conv_B": conv(gn),
        "conv_C": conv(gn),
        "gate_norm": {"scale": torch.ones((di,), dtype=pd, device=device)},
        "w_out": linear(di, d, 1.0 / math.sqrt(di * 2 * cfg.num_layers)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv as shifted multiply-adds in x's type (no
    ``F.conv1d``, which runs fp32 in TF32 on the card).  x [B,S,Cd], w [K,Cd].

    Returns (silu(y), new_state) where the state is the trailing K-1 inputs."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else None
    return F.silu(y.float()).to(x.dtype), new_state


def mamba_block_fwd(cfg: ModelConfig, p: Dict, u: torch.Tensor,
                    state: Optional[Dict] = None):
    """u: [B,S,d].  Prefill and training (state None) scan the whole
    sequence; decode (state {"ssm": [B,H,P,N] fp32, "conv_*": trailing
    inputs}) takes one token.  Returns (out [B,S,d], new state); training
    reads only ``out``, and the causal conv, softplus and the gated norm
    differentiate as the torch ops they are."""
    if cfg.attn_impl not in ("kernel", "dense"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    Bsz, S, _ = u.shape
    H, G, N, P = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_headdim
    dt_ = u.dtype
    z = u @ p["w_z"].to(dt_)
    x = u @ p["w_x"].to(dt_)
    Bp = u @ p["w_B"].to(dt_)
    Cp = u @ p["w_C"].to(dt_)
    dt = (u @ p["w_dt"].to(dt_)).float()
    dt = F.softplus(dt + p["dt_bias"][None, None])

    cs = {} if state is None else state
    x, cx = _causal_conv(x, p["conv_x"], cs.get("conv_x"))
    Bp, cB = _causal_conv(Bp, p["conv_B"], cs.get("conv_B"))
    Cp, cC = _causal_conv(Cp, p["conv_C"], cs.get("conv_C"))

    xh = x.reshape(Bsz, S, H, P)
    Bh = Bp.reshape(Bsz, S, G, N)
    Ch = Cp.reshape(Bsz, S, G, N)
    A = -torch.exp(p["A_log"])

    if state is not None:
        if S != 1:
            raise ValueError(f"decode takes one token at a time, got {S}")
        y, hT = ssd_decode_step(xh, dt, A, Bh, Ch, state["ssm"])
    elif cfg.attn_impl == "kernel" and is_dtensor(xh):
        y, hT = _mesh_ssd(cfg, xh, dt, A, Bh, Ch)
    elif cfg.attn_impl == "kernel":
        y, hT = ssd(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk, return_state=True)
    else:
        y, hT = ssd_chunked(xh, dt, A, Bh, Ch, chunk=cfg.ssm_chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = L.rms_norm(y * F.silu(z.float()).to(dt_), p["gate_norm"]["scale"])
    out = y @ p["w_out"].to(dt_)
    return out, {"ssm": hT, "conv_x": cx, "conv_B": cB, "conv_C": cC}


def _mesh_ssd(cfg: ModelConfig, x, dt, A, B_, C):
    """The SSD kernel on DTensors: each rank scans its batch rows (over dp)
    and, when the heads divide tp and the groups either are one or divide
    tp too, its heads (over tp).  One group shared by every head stays whole
    on each tp rank, and its gradient there is a partial sum over tp."""
    from repro_torch.parallel import activations as A_
    from repro_torch.parallel.sharding import PartitionSpec as P
    H, G = x.shape[2], B_.shape[2]
    tp, tps = A_._STATE["tp"], A_._STATE["tp_size"]
    dp = A_._entry("dp", x.shape[0])
    heads = tp is not None and tps > 1 and H % tps == 0 and (G == 1 or G % tps == 0)
    th = tp if heads else None
    tg = tp if heads and G > 1 else None
    x_s, dt_s, a_s, bc_s = P(dp, None, th), P(dp, None, th), P(th), P(dp, None, tg)
    bc_g = A_.with_partial(bc_s, tp) if heads and G == 1 else bc_s

    def scan(xl, dtl, al, bl, cl):
        return ssd(xl, dtl, al, bl, cl, chunk=cfg.ssm_chunk, return_state=True)

    return A_.local_region(scan, (x, dt, A, B_, C),
                           (x_s, dt_s, a_s, bc_s, bc_s),
                           (x_s, P(dp, th)),
                           grad_specs=(None, None, None, bc_g, bc_g))


def init_mamba_layer(cfg: ModelConfig, generator: torch.Generator, device) -> Dict:
    return {"ln": L.init_norm(cfg, cfg.d_model, device),
            "mamba": init_mamba_block(cfg, generator, device)}


def mamba_layer_fwd(cfg: ModelConfig, lp: Dict, x: torch.Tensor, state=None):
    h = L.apply_norm(cfg, lp["ln"], x)
    y, new_state = mamba_block_fwd(cfg, lp["mamba"], h, state)
    return shard_acts(x + y), new_state


@register("ssm")
class Mamba2LM:
    """Public API: init / forward / logits / loss / prefill / decode_step /
    init_cache.

    The inference methods (``forward``, ``logits``, ``prefill``,
    ``decode_step``) run under ``torch.no_grad()``; ``loss`` runs the
    grad-enabled ``_forward`` and ``_logits``."""

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
            "final_norm": L.init_norm(cfg, cfg.d_model, device),
            "lm_head": L.init_linear(generator, cfg.d_model, cfg.vocab_size,
                                     cfg.param_dtype, device=device),
        }

    @staticmethod
    def _forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D], differentiable; each layer
        under ``cfg.remat`` when grad mode is on.  The layer is the unit of
        recompute: ``comm`` and ``comm_lite`` save only attention and FFN
        outputs, which this layer has none of, so under them the whole layer
        is recomputed, as the reference's ``jax.checkpoint`` of it does."""
        x = L.embed(cfg, params["embed"], tokens)
        whole_layer = cfg.remat in ("comm", "comm_lite")
        for lp in params["layers"]:
            def body(x, lp=lp):
                return mamba_layer_fwd(cfg, lp, x)[0]
            x = L.remat_wrap(cfg, body, sublayer=whole_layer)(x)
        return L.apply_norm(cfg, params["final_norm"], x)

    @staticmethod
    def _logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return L.unembed(cfg, params["embed"], params.get("lm_head"), hidden)

    @staticmethod
    @torch.no_grad()
    def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B,S] -> final hidden [B,S,D]."""
        return Mamba2LM._forward(cfg, params, tokens)

    @staticmethod
    @torch.no_grad()
    def logits(cfg: ModelConfig, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        return Mamba2LM._logits(cfg, params, hidden)

    @staticmethod
    def loss(cfg: ModelConfig, params: Dict, batch: Dict):
        """Next-token cross-entropy with z-loss of ``batch`` ({"tokens",
        "labels"}) -> (loss, {"loss": loss})."""
        hidden = Mamba2LM._forward(cfg, params, batch["tokens"])
        logits = Mamba2LM._logits(cfg, params, hidden)
        loss = L.softmax_xent(logits, batch["labels"])
        return loss, {"loss": loss}

    # -- inference ----------------------------------------------------------
    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device="cuda") -> Dict:
        """The recurrent state has no sequence axis: ``max_len`` is unused."""
        device = resolve_device(device)
        H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
        cw, di, gn = cfg.ssm_conv_width, cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
        Lr, cd = cfg.num_layers, cfg.compute_dtype
        return {
            "ssm": torch.zeros((Lr, batch, H, P, N), dtype=torch.float32,
                               device=device),
            "conv_x": torch.zeros((Lr, batch, cw - 1, di), dtype=cd, device=device),
            "conv_B": torch.zeros((Lr, batch, cw - 1, gn), dtype=cd, device=device),
            "conv_C": torch.zeros((Lr, batch, cw - 1, gn), dtype=cd, device=device),
            "len": 0,
        }

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ModelConfig, params: Dict, batch: Dict):
        """Full forward returning (last-position logits, cache).

        The cache is ``{"ssm": [L,B,H,P,N] fp32, "conv_x"/"conv_B"/"conv_C":
        [L,B,K-1,.], "len": S}``; ``len`` is a Python int."""
        tokens = batch["tokens"]
        x = L.embed(cfg, params["embed"], tokens)
        states = {key: [] for key in ("ssm", *CONV_KEYS)}
        for lp in params["layers"]:
            x, st = mamba_layer_fwd(cfg, lp, x)
            for key, val in states.items():
                val.append(st[key])
        hidden = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
        logits = Mamba2LM.logits(cfg, params, hidden)
        cache = {key: torch.stack(val) for key, val in states.items()}
        cache["len"] = tokens.shape[1]
        return logits, cache

    @staticmethod
    @torch.no_grad()
    def decode_step(cfg: ModelConfig, params: Dict, cache: Dict, batch: Dict):
        """tokens [B,1] + cache -> (logits [B,1,V], cache).

        The cache's ``ssm`` and ``conv_*`` tensors are written IN PLACE (the
        JAX package returns new arrays); the returned dictionary holds the
        same tensors and the new ``len``."""
        tokens = batch["tokens"]
        x = L.embed(cfg, params["embed"], tokens)
        for i, lp in enumerate(params["layers"]):
            st = {key: cache[key][i] for key in ("ssm", *CONV_KEYS)}
            x, new = mamba_layer_fwd(cfg, lp, x, state=st)
            for key, val in st.items():
                val.copy_(new[key])
        hidden = L.apply_norm(cfg, params["final_norm"], x)
        logits = Mamba2LM.logits(cfg, params, hidden)
        out = {key: cache[key] for key in ("ssm", *CONV_KEYS)}
        out["len"] = cache["len"] + tokens.shape[1]
        return logits, out
