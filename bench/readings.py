#!/usr/bin/env python3
"""The readings that the limits of ``bench/limits/<cell>.json`` are set from.

    python3 bench/readings.py --workload <name> --seeds 1 2 3 ... [--control 3]

Needs the cards the cell asks for; the benchmark's own runs never run this.
For each seed it drives the cell's timed path as a run does (training: the
checked steps; prefill: a window long enough for the sampled batches) and
prints, as one JSON line, the numbers that decide ``correct``.  For the first
``--control`` seeds it also prints the control's numbers (the reference in
fp8 in the program's place) and each planted fault's: training on half of
each batch (the reference on its first half), prefill with every served token
the one the program ranks last.  A training step that leaves the state
unchanged reads 1 on the change by construction and needs no run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worst_leaves(prog: dict, ref: dict, n: int = 4) -> dict:
    """The leaves with the largest gaps of gradient and of change norms."""
    from bench.harness import session
    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = session.leaf_gaps(prog[key], ref[key])
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return out


def layer_errors(kept: dict, ref: dict) -> list:
    """Each layer's worst cache error over the kept batches: relative in
    norm over all tokens, and of the median token."""
    errs = []
    for i, (_, _, _, cache, _) in kept.items():
        for j, ((c, r), (rc, rr)) in enumerate(zip(cache, ref[i][1])):
            e = (max(float((c.float() - rc).norm() / rc.norm()),
                     float((r.float() - rr).norm() / rr.norm())),
                 max(float(((c.float() - rc).norm(dim=-1) / rc.norm(dim=-1)).median()),
                     float(((r.float() - rr).norm(dim=-1) / rr.norm(dim=-1)).median())))
            errs = errs + [(0.0, 0.0)] * (j + 1 - len(errs))
            errs[j] = tuple(max(a, b) for a, b in zip(errs[j], e))
    return [[round(a, 5), round(b, 5)] for a, b in errs]


def served_match(kept: dict, ref: dict) -> float:
    """The share of served tokens that are the reference's best."""
    hit = total = 0
    for i, (_, first, _, _, _) in kept.items():
        hit += int((ref[i][0].argmax(-1) == first[:, 0]).sum())
        total += first.shape[0]
    return hit / total


def train_readings(cell, mode, seed, device, control: bool) -> dict:
    from bench.harness import session
    prog = mode.Program(cell, seed, device)
    batches, stats = prog.checked_steps(mode.CHECKED_STEPS, seed)
    del prog
    session.free(device)
    ref = mode.reference(cell, seed, batches, device)
    out = {"program": mode.numbers(stats, ref), "losses": stats["losses"],
           "ref_losses": ref["losses"], "program_worst": worst_leaves(stats, ref)}
    if control:
        ctl = mode.reference(cell, seed, batches, device, "fp8")
        out["control"] = mode.numbers(ctl, ref)
        out["control_worst"] = worst_leaves(ctl, ref)
        out["half_batch"] = mode.numbers(
            mode.reference(cell, seed, batches, device, fault="half_batch"), ref)
    return out


def prefill_readings(cell, mode, seed, device, control: bool, seconds: float) -> dict:
    import torch
    from bench.harness import session
    prog = mode.Program(cell, seed, device, seconds)
    prog.warm_up()
    keep = mode.sample_plan(cell, prog.lengths, seed)
    lat, window_s, tokens, failed, kept = mode.window(prog, seconds, keep)
    params = prog.params
    del prog
    session.free(device)
    ref = mode.reference(cell, params, kept, device)
    out = {"program": mode.numbers(kept, ref), "kept": sorted(kept),
           "tokens_per_s": tokens / window_s, "program_layers": layer_errors(kept, ref),
           "program_match": served_match(kept, ref)}
    if control:
        ctl = mode.reference(cell, params, kept, device, "fp8")
        as_program = {i: (k[0], ctl[i][0].argmax(-1, keepdim=True), ctl[i][0], ctl[i][1], k[4])
                      for i, k in kept.items()}
        out["control"] = mode.numbers(as_program, ref)
        out["control_layers"] = layer_errors(as_program, ref)
        out["control_match"] = served_match(as_program, ref)
        last = {i: torch.argmin(k[2], -1) for i, k in kept.items()}
        out["altered_token"] = mode.numbers(kept, ref, tokens=last)
    del params
    session.free(device)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control and the faults on this many of the seeds")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="prefill: the window of each seed")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench.harness import cells
    cell = cells.cell(args.workload)
    device = torch.device("cuda", 0)
    mode = cells.mode_module(cell.mode)
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        control = n < args.control
        if cell.mode == "train":
            out = train_readings(cell, mode, seed, device, control)
        else:
            out = prefill_readings(cell, mode, seed, device, control, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)


if __name__ == "__main__":
    main()
