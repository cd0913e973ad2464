"""Device milliseconds of the MoE layer (``repro_torch.models.moe``: ``route``,
``dispatch``, ``expert_products``, ``combine``) a training step: the operations
launched inside their spans and, in training, by the backward of each op
that ran inside them (remat's recompute included)."""

MODE = "train"
SPANS = {"moe": [("repro_torch.models.moe", "route"),
                 ("repro_torch.models.moe", "dispatch"),
                 ("repro_torch.models.moe", "expert_products"),
                 ("repro_torch.models.moe", "combine")]}


def read(t):
    ms = t.region_ms("moe")
    if t.mode != MODE or ms is None or not t.units:
        return None
    return ms / t.units
