"""Roofline-term assembly from dry-run records, on the port's hardware.

Hardware model: one NVIDIA H100 SXM5 at its 700 W limit, from NVIDIA's H100
Tensor Core GPU data sheet (the SXM column): 989 TFLOP/s dense bf16 on the
tensor cores (1,979 is the sparse figure), 3.35 TB/s of HBM3, and NVLink 4 at
900 GB/s a card, 450 GB/s each way.  A card set below 700 W runs slower.

Terms (seconds per step, per card):
  compute    = hlo.dot_flops / PEAK_FLOPS
               (dot_flops: per-device dot and convolution FLOPs of the step,
               ``analysis.flops`` counting on meta tensors, or the JAX
               package's HLO parser in its own records)
  memory     = achieved_bytes_for_cell / HBM_BW (modelled from the step's
               structure: the dry-run allocates nothing)
  collective = per-card wire bytes (ring model) / LINK_BW

MODEL_FLOPS (the useful-work yardstick):
  train:   6 · N_active · tokens   (fwd 2ND + bwd 4ND)
  prefill: 2 · N_active · tokens
  decode:  2 · N_active · tokens (+ KV-cache read bytes enter the memory
           term, not FLOPs)
divided across 256 cards (the roofline table is the 16x16 mesh of
``launch.mesh.make_production_mesh`` only).

Records of either package read alike: the JAX package's carry
``memory.temp_size_in_bytes`` from XLA's memory analysis; the port's meta
dry-run has no compiler and no temporaries to report, so its ``temp_gib`` is
the arguments' alone.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

PEAK_FLOPS = 989e12      # dense bf16 per card (H100 SXM5, 700 W)
HBM_BW = 3.35e12         # bytes/s per card (HBM3)
LINK_BW = 450e9          # bytes/s per card each way (NVLink 4: 900 GB/s both ways)
CHIPS_SINGLE_POD = 256

_LEVER = {
    "compute": "raise tensor-core utilization: the wgmma kernels' causal tile "
               "skipping, less remat recompute, larger µbatch",
    "memory": "cut HBM traffic: fused elementwise passes (AdamW, norms, RoPE, "
              "SwiGLU), bf16 grads, smaller remat window, KV-cache layout",
    "collective": "cut NVLink bytes: reshard (less FSDP gather), overlap NCCL "
                  "collectives with compute, int8 gradient compression, bf16 AR",
}


@dataclass
class RooflineRow:
    arch: str
    shape: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float
    min_bytes_per_chip: float         # analytic floor: params(+cache+opt) traffic
    hlo_flops_per_chip: float
    temp_gib: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """No-overlap upper bound = sum; perfect overlap = max.  We report
        the bottleneck term as the roofline step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops_per_chip / self.hlo_flops_per_chip
                if self.hlo_flops_per_chip else 0.0)

    @property
    def ideal_step_s(self) -> float:
        """Roofline floor: an ideal implementation is limited by useful
        FLOPs at tensor-core peak or the unavoidable HBM traffic, whichever
        larger."""
        return max(self.model_flops_per_chip / PEAK_FLOPS,
                   self.min_bytes_per_chip / HBM_BW)

    @property
    def roofline_fraction(self) -> float:
        """ideal_step / achieved_step — the score we hillclimb."""
        if self.step_s <= 0:
            return 0.0
        return min(self.ideal_step_s / self.step_s, 1.0)

    @property
    def lever(self) -> str:
        return _LEVER[self.bottleneck]


def model_flops_for_cell(arch: str, shape: str) -> float:
    """MODEL_FLOPS per step (global, all chips)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES
    from repro_torch.analysis.params import active_param_count

    cfg = get_config(arch)
    kind, S, B = SHAPES[shape]
    n_active = active_param_count(cfg)
    if cfg.family == "encdec":
        tokens = B * (S + max(S // 4, 8)) / 2   # enc+dec, rough half each
    else:
        tokens = B * S
    if kind == "train":
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * B                    # decode: 1 token per seq


def min_bytes_for_cell(arch: str, shape: str) -> float:
    """Analytic HBM-traffic floor per step (global bytes, all chips).

    train:   params bf16 read (fwd) + read (bwd) + grad fp32 w+r + m,v r+w
             + param write  ≈ N × 26 bytes
    prefill: params bf16 read + KV cache write
    decode:  params(active) bf16 read + full KV/state cache read per token
    """
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES
    from repro_torch.analysis.params import param_count, active_param_count

    cfg = get_config(arch)
    kind, S, B = SHAPES[shape]
    n_total = param_count(cfg)
    n_active = active_param_count(cfg)
    cache = cache_bytes(arch, S, B)
    if kind == "train":
        return 26.0 * n_total
    if kind == "prefill":
        return 2.0 * n_total + cache
    return 2.0 * n_active + cache


def cache_bytes(arch: str, S: int, B: int) -> float:
    """Decode-state bytes for one batch (bf16 KV / fp32 SSM states)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    hd = cfg.resolved_head_dim
    if cfg.family in ("dense", "vlm"):
        return 2.0 * cfg.num_layers * B * cfg.n_kv_heads * S * hd * 2
    if cfg.family == "moe":
        if cfg.kv_lora_rank:
            return cfg.num_layers * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        w = min(S, cfg.window or S)
        return 2.0 * cfg.num_layers * B * cfg.n_kv_heads * w * hd * 2
    if cfg.family == "ssm":
        return cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
    if cfg.family == "hybrid":
        ssm = cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        napp = -(-cfg.num_layers // max(cfg.shared_attn_period, 1))
        return ssm + 2.0 * napp * B * cfg.n_kv_heads * S * hd * 2
    if cfg.family == "encdec":
        sd = max(S // 4, 8)
        return 2.0 * cfg.dec_layers * B * cfg.n_kv_heads * (sd + S) * hd * 2
    return 0.0


def achieved_bytes_for_cell(arch: str, shape: str, *, grad_accum: int = 1,
                            remat: str = "full", fsdp: bool = True,
                            tp: int = 16, chips: int = CHIPS_SINGLE_POD) -> float:
    """Per-card HBM traffic of THIS implementation's step structure.

    The dry-run builds the step on meta tensors and measures no traffic, so
    the achieved memory term is modelled analytically from the step
    structure it built — microbatch count, remat policy, FSDP gathers,
    sharding — with documented coefficients:

      weights: FSDP-gathered per layer per µb; full remat re-gathers in bwd
               -> per µb: write+read fwd (2) + regather-write + dgrad/wgrad
               reads (3)  => 5 × W/tp  (no remat: 1 gather, 3 reads => 4)
      acts:    ~K_ACT passes over the [B_µb, S, d] residual stream per layer
               (qkv/o/ffn in+out, norms, + full-remat recompute)
      logits:  fp32 write + softmax read + grad write per µb
      opt:     26 B/param on the local shard (grads fp32 rw, m/v rw, p rw)
      kv:      decode reads the whole local cache per token
    """
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES
    from repro_torch.analysis.params import param_count, active_param_count

    cfg = get_config(arch)
    kind, S, B = SHAPES[shape]
    n_total = param_count(cfg)
    W_local = 2.0 * n_total / tp            # bf16 gathered weights per chip
    dp = chips // tp
    K_ACT = 12 if remat == "full" else 8

    if kind == "train":
        M = max(grad_accum, 1)
        Bl = B / dp / M                      # per-chip per-µb batch
        Sd = max(S // 4, 8) if cfg.family == "encdec" else S
        weight_factor = 5.0 if remat == "full" else 4.0
        if not fsdp:
            weight_factor = 3.0              # resident: fwd+dgrad+wgrad reads
        weights = M * weight_factor * W_local
        acts = M * cfg.num_layers * Bl * Sd * cfg.d_model * 2.0 * K_ACT
        logits = M * Bl * Sd * (cfg.vocab_size / tp) * 4.0 * 3.0
        opt = 26.0 * n_total / chips if fsdp else 26.0 * n_total / tp
        return weights + acts + logits + opt
    if kind == "prefill":
        Bl = B / dp
        Sd = max(S // 4, 8) if cfg.family == "encdec" else S
        weights = 2.0 * W_local
        acts = cfg.num_layers * Bl * Sd * cfg.d_model * 2.0 * (K_ACT / 2)
        cache = cache_bytes(arch, S, B) / chips
        return weights + acts + cache
    # decode
    n_active = active_param_count(cfg)
    return 2.0 * n_active / tp + cache_bytes(arch, S, B) / chips


def build_rows(records: List[dict]) -> List[RooflineRow]:
    rows = []
    for r in records:
        if r.get("status") != "ok" or r.get("mesh") != "16x16":
            continue
        hlo = r.get("hlo", {})
        dot = float(hlo.get("dot_flops", 0.0)) + float(hlo.get("conv_flops", 0.0))
        mem_bytes = achieved_bytes_for_cell(
            r["arch"], r["shape"], grad_accum=r.get("grad_accum", 1),
            remat=r.get("remat", "full"), fsdp=r.get("fsdp", True))
        coll = float(hlo.get("total_collective_bytes", 0.0))
        mf = model_flops_for_cell(r["arch"], r["shape"]) / CHIPS_SINGLE_POD
        mb = min_bytes_for_cell(r["arch"], r["shape"]) / CHIPS_SINGLE_POD
        rows.append(RooflineRow(
            arch=r["arch"], shape=r["shape"], kind=r["kind"],
            compute_s=dot / PEAK_FLOPS,
            memory_s=mem_bytes / HBM_BW,
            collective_s=coll / LINK_BW,
            model_flops_per_chip=mf,
            min_bytes_per_chip=mb,
            hlo_flops_per_chip=dot,
            temp_gib=(r["memory"].get("temp_size_in_bytes", 0)
                      + r["memory"]["argument_size_in_bytes"]) / 2**30,
        ))
    return rows


def load_rows(path: str | Path) -> List[RooflineRow]:
    recs = [json.loads(l) for l in Path(path).read_text().splitlines() if l.strip()]
    return build_rows(recs)


def to_markdown(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bottleneck "
           "| useful (6ND/counted) | roofline frac | mem GiB/card |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape)):
        out.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.bottleneck}** | {r.useful_ratio:.2f} "
            f"| {r.roofline_fraction:.1%} | {r.temp_gib:.1f} |\n")
    return "".join(out)
