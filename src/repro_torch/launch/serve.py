"""Serving launcher: batched prefill, then decode from the KV cache (dense,
Qwen2-VL and Mixtral archs; DeepSeek's compressed MLA cache), the recurrent
state (mamba2-1.3b) or both (zamba2-1.2b), on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --preset full --batch 8 --prompt-len 1024 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --preset full --batch 8 --prompt-len 1024 --gen 64

Runs on ``cuda`` unless ``--device cpu`` is given; with no card and no such
request it raises.  Whisper (family ``encdec``) needs its frontend's frame
embeddings and is refused, as the reference's launcher refuses it;
``generate`` serves it with those embeddings in ``extra``.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.common import get_model, resolve_device

# cache entries whose second-to-last dim is the sequence: the KV cache,
# Zamba2's shared attention's and MLA's compressed cache; a Mamba-2 state and
# conv windows do not grow, and Whisper's cross K/V keep the encoder's
# length, so padding leaves them
SEQ_KEYS = ("k", "v", "attn_k", "attn_v", "c_kv", "k_rope")
ENCDEC_REFUSAL = ("whisper serving needs audio frontend inputs; "
                  "see tests/test_models_smoke.py for the API")


def pad_cache_to(cache: dict, max_len: int, window: Optional[int] = None) -> dict:
    """Grow the seq dim of a prefill cache so decode can append.  Under the
    config's sliding ``window`` it grows to the window at most: a cache of the
    window's length is a ring (slot = position % window) that decode writes
    in place, and a longer one would be read as positions 0, 1, ... (the JAX
    package's ``pad_cache_to`` pads the ring all the same)."""
    if window:
        max_len = min(max_len, window)
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            val = pad_cache_to(val, max_len)
        elif key in SEQ_KEYS and isinstance(val, torch.Tensor) and val.ndim >= 3:
            pad = max_len - val.shape[-2]
            if pad > 0:
                val = F.pad(val, (0, 0, 0, pad))
        out[key] = val
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """Next token ids [B, 1] from logits [B, S, V]: greedy at temperature 0."""
    last = logits[:, -1]
    if temperature <= 0:
        return torch.argmax(last, dim=-1, keepdim=True)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def generate(cfg, params, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             extra: Optional[dict] = None):
    """Prefill ``prompts`` [B, S] and decode ``gen`` tokens.  ``extra`` holds
    what else the prefill's batch takes (Whisper's ``enc_embeds``).

    Returns (tokens [B, gen], prefill seconds, decode seconds)."""
    device = prompts.device
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts, **(extra or {})})
    cache = pad_cache_to(cache, prompts.shape[1] + gen, cfg.window)
    sync(device)
    t_prefill = time.perf_counter() - t0

    tok = sample(logits, temperature, generator)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = sample(logits, temperature, generator)
        out.append(tok)
    sync(device)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ALL_ARCHS)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.preset == "smoke"
           else get_config(args.arch))
    if cfg.family == "encdec":
        raise SystemExit(ENCDEC_REFUSAL)
    model = get_model(cfg)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(cfg, generator, device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=generator, device=device)
    gen, t_prefill, t_decode = generate(
        cfg, params, prompts, args.gen, args.temperature, generator)
    steps = args.gen - 1
    rate = args.batch * steps / t_decode if steps else 0.0
    print(f"[serve] {args.arch} on {device}: prefill {args.batch}x"
          f"{args.prompt_len} in {t_prefill*1e3:.0f} ms; decode {steps} steps "
          f"in {t_decode*1e3:.0f} ms ({rate:.0f} tok/s)")
    print("[serve] sample:", gen[0, :16].tolist())


if __name__ == "__main__":
    main()
