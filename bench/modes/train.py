"""Training: a closed loop of the port's train step.

Traffic keys: ``batch`` and ``seq_len`` (each step takes ``batch`` rows of
``seq_len`` tokens and their next tokens as labels, drawn from the seed
uniformly over the vocabulary).

Set-up builds one train step (``repro_torch.launch.steps.make_train_step``,
the configuration's AdamW), makes the weights and the optimizer state from
the seed, and drives it through the checked steps, reading the loss of each,
every leaf's gradient as the optimizer took it at step 1 (its first moment
over ``1 - b1``) and every leaf's change over the checked steps.  The window
goes on from there with the same object and the same feed: a step ends when
its loss reaches the host.

After the window the program's state is freed and the reference trains from
the same weights, made again from the seed, on the same checked batches.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch

from bench.harness import cells, session, weights

# the first steps, made in set-up and held against the reference: the limits
# of ``bench/limits`` were read at this number
CHECKED_STEPS = 3
# the steps of the traced window of ``--trace 1``
TRACE_STEPS = 2


class Program:
    """The port's train step and its state, from the seed."""

    def __init__(self, cell: cells.Cell, seed: int, device):
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.common import get_model
        from repro_torch.optim import AdamWConfig, adamw_init
        conf = cell.config
        self.cell, self.device = cell, device
        self.pcfg = cells.family_module(cell.family).port_config(conf)
        meta = get_model(self.pcfg).init(self.pcfg, torch.Generator(), "meta")
        self.params = weights.make(meta, seed, device, conf["num_hidden_layers"])
        self.opt_cfg = AdamWConfig(**conf["optimizer"])
        self.opt_state = adamw_init(self.params)
        self.step_fn = make_train_step(self.pcfg, self.opt_cfg)
        self.B, self.S = cell.traffic["batch"], cell.traffic["seq_len"]
        self.feed = weights.generator(seed, "tokens", device)
        self.steps = 0

    def batch(self) -> Dict[str, torch.Tensor]:
        t = torch.randint(0, self.pcfg.vocab_size, (self.B, self.S + 1),
                          generator=self.feed, device=self.device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def step(self, batch) -> float:
        self.params, self.opt_state, out = self.step_fn(self.params, self.opt_state, batch)
        self.steps += 1
        return float(out["loss"])

    def checked_steps(self, n: int, seed: int):
        """The first ``n`` steps -> (their batches on the host, the stats:
        the losses; each leaf's gradient at step 1 as the optimizer took it,
        its first moment over ``1 - b1``, and its change over the ``n``
        steps, each by its norm and by its elements at ``element_sample``)."""
        named = weights.named_leaves(self.params)
        start = {k: w.clone() for k, w in named}
        sample = element_sample(named, seed)
        batches, losses, grad_norms, grad_sample = [], [], {}, {}
        for i in range(n):
            b = self.batch()
            batches.append({k: v.cpu() for k, v in b.items()})
            losses.append(self.step(b))
            if i == 0:
                for k, m in weights.named_leaves(self.opt_state["m"]):
                    g = m / (1 - self.opt_cfg.b1)
                    grad_norms[k] = float(g.norm())
                    grad_sample[k] = g.reshape(-1)[sample[k].to(g.device)].cpu()
        change, change_sample = {}, {}
        for k, w in weights.named_leaves(self.params):
            d = w.float() - start[k].float()
            change[k] = float(d.norm())
            change_sample[k] = d.reshape(-1)[sample[k].to(d.device)].cpu()
        del start
        return batches, {"losses": losses, "grad_norms": grad_norms, "grad_sample": grad_sample,
                         "change_norms": change, "change_sample": change_sample}


def element_sample(named, seed: int, k: int = 4096):
    """``k`` flat indices of each leaf (all of a smaller one), drawn from the
    seed: the elements whose gradient and change are compared one by one."""
    gen = torch.Generator().manual_seed(weights.sub_seed(seed, "elements"))
    return {name: (torch.arange(w.numel()) if w.numel() <= k
                   else torch.randint(0, w.numel(), (k,), generator=gen))
            for name, w in named}


def reference(cell: cells.Cell, seed: int, batches: List[dict], device,
              precision: str = "fp32", fault: str = "") -> dict:
    """The reference's stats from the same weights and checked batches.
    ``fault`` ``half_batch`` trains it on the first half of each batch's
    rows, the mean taken over them (a fault for the check's test)."""
    from bench.reference.common import precision as prec, strict_fp32
    from repro_torch.models.common import get_model
    ref = cells.reference_module(cell.family)
    pcfg = cells.family_module(cell.family).port_config(cell.config)
    meta = get_model(pcfg).init(pcfg, torch.Generator(), "meta")
    host = weights.to_host(weights.make(meta, seed, device, cell.config["num_hidden_layers"]))
    session.free(device)
    sample = element_sample(weights.named_leaves(host), seed)
    if fault == "half_batch":
        batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
    with strict_fp32(), prec(precision):
        return ref.train_steps(cell.config, host, batches, device, sample)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, of the loss of each checked step, of each
    leaf's gradient at step 1 and of its change over the checked steps:

    * ``loss_gap``: the worst step's loss gap (relative);
    * ``grad_gap``, ``change_gap`` (and ``_median``): the gap between the
      program's norm and the reference's, of the worst (the median) leaf,
      against the reference's norm of that leaf or of the median leaf,
      whichever is larger (``session.leaf_gaps``);
    * ``grad_err``, ``change_err`` (and ``_median``): the norm of the
      difference over the sampled elements, against the same.

    The change leaves out leaves whose reference gradient is under a
    thousandth of the median leaf's."""
    loss_gap = max(session.rel_gap(a, b, 0.0) for a, b in zip(prog["losses"], ref["losses"]))
    raw = ref["raw_grad_norms"]
    med = statistics.median(raw.values())
    counted = [k for k, g in raw.items() if g >= 1e-3 * med]
    out = {"loss_gap": loss_gap}
    for part, leaves in (("grad", list(raw)), ("change", counted)):
        gaps = session.leaf_gaps(prog[part + "_norms"], ref[part + "_norms"], leaves)
        errs = session.leaf_errors(prog[part + "_sample"], ref[part + "_sample"], leaves)
        for name, per_leaf in ((part + "_gap", gaps), (part + "_err", errs)):
            out[name] = max(per_leaf.values())
            out[name + "_median"] = statistics.median(per_leaf.values())
    return out


def model_flops(cell: cells.Cell, steps: int) -> float:
    """Training counted as three forward passes (remat's recompute left out)."""
    ref = cells.reference_module(cell.family)
    t = cell.traffic
    return 3 * steps * ref.forward_flops(cell.config, t["batch"], t["seq_len"], t["seq_len"])


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    prog = Program(cell, seed, device)
    batches, stats = prog.checked_steps(CHECKED_STEPS, seed)
    session.reset_peak(device)
    start = time.perf_counter()
    setup_s = start - t0
    losses = []
    while True:
        losses.append(prog.step(prog.batch()))
        end = time.perf_counter()
        if end - start >= seconds:
            break
    peak = session.peak_bytes(device)
    tokens = len(losses) * prog.B * prog.S
    out = {"attempted": len(losses), "failed": sum(not math.isfinite(x) for x in losses),
           "device": session.device_info(cell.chips, peak, device)}
    if trace:
        n = TRACE_STEPS
        before = prog.steps
        metrics, extra, breakdown = session.traced(
            cell, lambda: [prog.step(prog.batch()) for _ in range(n)],
            lambda: prog.steps - before, lambda: model_flops(cell, prog.steps - before))
        out["device"].update(extra)
        out["breakdown"] = breakdown
    else:
        metrics = {"train_tokens_per_s": tokens / (end - start),
                   "peak_mem_gib": peak / session.GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    del prog
    session.free(device)
    ref = reference(cell, seed, batches, device)
    out["numbers"] = numbers(stats, ref)
    return out
