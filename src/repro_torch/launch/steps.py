"""Step factories: prefill / decode, shared by the launcher, the examples and
``chip_smoke.py``.  The training step comes with the training slice."""
from __future__ import annotations

from repro_torch.models.common import ModelConfig, get_model


def make_prefill_step(cfg: ModelConfig):
    model = get_model(cfg)

    def prefill_step(params, batch):
        return model.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    model = get_model(cfg)

    def decode_step(params, cache, batch):
        return model.decode_step(cfg, params, cache, batch)

    return decode_step
