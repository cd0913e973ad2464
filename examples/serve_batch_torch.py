"""Batched serving demo of the PyTorch/CUDA port: prefill a batch of prompts,
then decode with the KV cache.

    PYTHONPATH=src python examples/serve_batch_torch.py            # on the GPU
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate, resolve_device
from repro_torch.models.common import get_model


def main(device: str = "cuda", batch: int = 4, prompt_len: int = 48,
         gen_tokens: int = 32) -> None:
    dev = resolve_device(device)
    cfg = get_smoke_config("tinyllama-1.1b")
    model = get_model(cfg)
    generator = torch.Generator(device=dev).manual_seed(0)
    params = model.init(cfg, generator, dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=generator, device=dev)
    gen, t_prefill, t_decode = generate(cfg, params, prompts, gen_tokens)
    print(f"prefill: {batch}x{prompt_len} tokens in {t_prefill*1e3:.0f} ms")
    print(f"decode:  {gen_tokens-1} steps in {t_decode*1e3:.0f} ms "
          f"({batch*(gen_tokens-1)/t_decode:.0f} tok/s)")
    print("sample generated ids:", gen[0, :12].tolist())


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
