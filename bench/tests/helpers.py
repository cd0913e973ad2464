"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second: the
same files, the widths and depths below, fp32."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.harness import cells  # noqa: E402

SMOKE = {
    "deepseek_v2": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                        n_shared_experts=1, moe_intermediate_size=32,
                        intermediate_size=128, vocab_size=256, moe_dispatch_groups=4),
}
TRAFFIC = {"train": dict(batch=2, seq_len=40),
           "prefill": dict(prompt_tokens=64, lengths=[16, 32])}


def smoke_cell(name: str) -> cells.Cell:
    cell = copy.deepcopy(cells.cell(name))
    cell.config.update(SMOKE[cell.family], param_dtype="float32")
    if cell.family == "deepseek_v2":      # the training stage at 3 layers, the full model at 8
        cell.config["num_hidden_layers"] = 3 if cell.mode == "train" else 8
    cell.traffic.update(TRAFFIC[cell.mode])
    return cell
