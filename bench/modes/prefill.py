"""A prefill pool: a closed loop with one batch in flight.

Traffic keys: ``prompt_tokens`` (the tokens of every batch) and ``lengths``
(the prompt lengths; batch i has length ``S`` and ``prompt_tokens / S``
prompts).  The lengths come in blocks that hold each length once, in an
order drawn from the seed for each block, so every seed sends the same mix
of work in another order.  Token ids are drawn from the seed uniformly over
the vocabulary.

A batch is what ``repro_torch.launch.serve.generate(..., gen=1)`` does for
it: ``make_prefill_step``'s step, ``pad_cache_to`` one position further and
greedy ``sample``; it ends when its first tokens reach the host.  Its time,
from its submission, is the time to first token of each of its prompts.

Set-up runs one batch of each length.  After the window the reference
prefills a sample of the batches completed among the first ``SAMPLE_FIRST``:
every batch of the shortest length (the most prompts) and one drawn from the
seed of each other length, the longest among them; of each, the first
tokens, the last logits and ``CACHE_ROWS`` token rows of every layer's cache,
drawn from the seed, are compared.
"""
from __future__ import annotations

import math
import random
import statistics
import time
from typing import Dict, List

import torch

from bench.harness import cells, session, weights

# what the check compares; the limits of ``bench/limits`` were read at these
SAMPLE_FIRST = 32
CACHE_ROWS = 512
# the batches of the traced window of ``--trace 1``
TRACE_BATCHES = 8


class Program:
    """The port's prefill step over the weights made from the seed."""

    def __init__(self, cell: cells.Cell, seed: int, device, seconds: float):
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models.common import get_model
        conf, t = cell.config, cell.traffic
        self.cell, self.device = cell, device
        self.fam = cells.family_module(cell.family)
        self.pcfg = self.fam.port_config(conf)
        meta = get_model(self.pcfg).init(self.pcfg, torch.Generator(), "meta")
        self.params = weights.make(meta, seed, device, conf["num_hidden_layers"])
        self.step_fn = make_prefill_step(self.pcfg)
        self.total = t["prompt_tokens"]
        # enough batches for the window at 20 a second
        n = max(SAMPLE_FIRST, int(seconds * 20)) + len(t["lengths"])
        rng = random.Random(weights.sub_seed(seed, "lengths"))
        self.lengths: List[int] = []
        while len(self.lengths) < n:
            block = list(t["lengths"])
            rng.shuffle(block)
            self.lengths += block
        self.pool = weights.tokens(seed, "tokens", (len(self.lengths), self.total),
                                   self.pcfg.vocab_size, device)
        self.warm = weights.tokens(seed, "warm-up", (len(t["lengths"]), self.total),
                                   self.pcfg.vocab_size, device)
        self.done = 0

    def prompts(self, i: int) -> torch.Tensor:
        S = self.lengths[i]
        return self.pool[i].view(self.total // S, S)

    def serve(self, prompts: torch.Tensor):
        """One batch -> (first tokens on the host, last logits, prefill cache)."""
        from repro_torch.launch.serve import pad_cache_to, sample
        logits, cache = self.step_fn(self.params, {"tokens": prompts})
        padded = pad_cache_to(cache, prompts.shape[1] + 1, self.pcfg.window)
        first = sample(logits, 0.0, None).cpu()
        del padded
        return first, logits, cache

    def warm_up(self) -> None:
        for j, S in enumerate(self.cell.traffic["lengths"]):
            self.serve(self.warm[j].view(self.total // S, S))


def sample_plan(cell: cells.Cell, lengths: List[int], seed: int) -> Dict[int, torch.Tensor]:
    """{batch: the token rows of its cache that are compared}: the batches
    of the shortest length among the first ``SAMPLE_FIRST`` and one of each
    other length, drawn from the seed, each with ``CACHE_ROWS`` of its
    ``prompt_tokens`` drawn from the seed."""
    first = lengths[:SAMPLE_FIRST]
    rng = random.Random(weights.sub_seed(seed, "sample"))
    shortest = min(first)
    plan = [i for i, S in enumerate(first) if S == shortest]
    for S in sorted(set(first) - {shortest}):
        plan.append(rng.choice([i for i, L in enumerate(first) if L == S]))
    gen = torch.Generator().manual_seed(weights.sub_seed(seed, "rows"))
    total, k = cell.traffic["prompt_tokens"], CACHE_ROWS
    return {i: torch.randperm(total, generator=gen)[:k].sort().values for i in sorted(plan)}


def _rows(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The rows ``rows`` of t [B, S, D] flattened over B and S."""
    return t.reshape(-1, t.shape[-1]).index_select(0, rows)


def window(prog: Program, seconds: float, keep: Dict[int, torch.Tensor]):
    """Batches until ``seconds`` have passed -> (latency and prompts of each
    batch, seconds, tokens, prompts served no valid token, {batch: what is
    kept for the check}).  Of a batch in ``keep`` the first tokens, the last
    logits and the cache's rows at ``keep[batch]`` are kept on the host."""
    kept: Dict[int, tuple] = {}
    lat: List[tuple] = []
    tokens = failed = 0
    start = time.perf_counter()
    while True:
        i = prog.done
        prompts = prog.prompts(i)
        t_sub = time.perf_counter()
        first, logits, cache = prog.serve(prompts)
        t_done = time.perf_counter()
        lat.append((t_done - t_sub, prompts.shape[0]))
        tokens += prompts.numel()
        failed += int(((first < 0) | (first >= prog.pcfg.vocab_size)).sum())
        prog.done += 1
        if i in keep:
            rows = keep[i]
            at = rows.to(logits.device)
            kept[i] = (prompts.cpu(), first, logits[:, -1].float().cpu(),
                       [(_rows(c, at).cpu(), _rows(r, at).cpu())
                        for c, r in prog.fam.cache_of(cache)], rows)
        del logits, cache
        if t_done - start >= seconds or prog.done == len(prog.lengths):
            return lat, t_done - start, tokens, failed, kept


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def _token_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row's relative error (the norm over the last dim)."""
    return (a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1).clamp_min(1e-30)


def reference(cell: cells.Cell, params, kept: Dict[int, tuple], device,
              precision: str = "fp32") -> Dict[int, tuple]:
    """The reference's last logits and cache rows of each kept batch."""
    from bench.reference.common import precision as prec, strict_fp32
    ref = cells.reference_module(cell.family)
    out = {}
    with strict_fp32(), prec(precision):
        for i, k in kept.items():
            logits, cache = ref.prefill(cell.config, params, k[0].to(device))
            at = k[-1].to(device)
            out[i] = (logits.cpu(), [(_rows(c, at).cpu(), _rows(r, at).cpu())
                                     for c, r in cache])
            del logits, cache
    return out


def numbers(kept: Dict[int, tuple], ref: Dict[int, tuple], tokens=None) -> Dict[str, float]:
    """The numbers compared, over every kept batch: the gap by which a
    served token's logit lies below the reference's best, the widest and the
    median prompt's (``tokens``: the served tokens, the program's unless
    given); the last logits' error, the
    largest relative to the reference's largest logit and the median prompt's
    (relative, in norm); each layer's cache error, in norm over all the
    batch's tokens and of the median token (relative), the worst layer's.
    Not a number where no batch was kept."""
    names = ("token_gap", "token_gap_median", "logit_err", "logit_err_median", "cache_err",
             "cache_err_median")
    if not kept:
        return {n: math.nan for n in names}
    logit_err = cache_err = cache_med = 0.0
    per_prompt, gaps = [], []
    for i, (_, first, logits, cache, _rows_) in kept.items():
        r_logits, r_cache = ref[i]
        served = first[:, 0] if tokens is None else tokens[i]
        best = r_logits.max(dim=-1).values
        gaps += (best - r_logits.gather(1, served[:, None].long())[:, 0]).tolist()
        logit_err = max(logit_err, float((logits - r_logits).abs().max()
                                         / r_logits.abs().max()))
        per_prompt += _token_rel(logits, r_logits).tolist()
        for (c, r), (rc, rr) in zip(cache, r_cache):
            cache_err = max(cache_err, _rel(c, rc), _rel(r, rr))
            cache_med = max(cache_med, float(_token_rel(c, rc).median()),
                            float(_token_rel(r, rr).median()))
    return dict(zip(names, (max(gaps), statistics.median(gaps), logit_err,
                            statistics.median(per_prompt), cache_err, cache_med)))


def model_flops(cell: cells.Cell, lengths: List[int]) -> float:
    """Each batch's forward pass, the head at each prompt's last position."""
    ref = cells.reference_module(cell.family)
    total = cell.traffic["prompt_tokens"]
    return sum(ref.forward_flops(cell.config, total // S, S, 1) for S in lengths)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    prog = Program(cell, seed, device, seconds)
    prog.warm_up()
    keep = sample_plan(cell, prog.lengths, seed)
    session.reset_peak(device)
    setup_s = time.perf_counter() - t0
    lat, window_s, tokens, failed, kept = window(prog, seconds, keep)
    peak = session.peak_bytes(device)
    requests = [t for t, n in lat for _ in range(n)]
    out = {"attempted": len(requests),
           "failed": failed,
           "device": session.device_info(cell.chips, peak, device),
           "requests": len(requests), "batches": len(lat)}
    if trace:
        n, first = TRACE_BATCHES, prog.done
        traced = [(first + j) % len(prog.lengths) for j in range(n)]
        metrics, extra, breakdown = session.traced(
            cell, lambda: [prog.serve(prog.prompts(i)) for i in traced], lambda: n,
            lambda: model_flops(cell, [prog.lengths[i] for i in traced]))
        out["device"].update(extra)
        out["breakdown"] = breakdown
    else:
        metrics = {"prefill_tokens_per_s": tokens / window_s,
                   "prefill_p95_ms": session.p95(requests) * 1e3,
                   "peak_mem_gib": peak / session.GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": metrics[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out["metrics"] = metrics
    params = prog.params
    del prog
    session.free(device)
    out["numbers"] = numbers(kept, reference(cell, params, kept, device))
    return out
