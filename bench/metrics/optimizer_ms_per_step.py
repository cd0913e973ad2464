"""Device milliseconds of the optimizer a training step: the operations
launched inside ``repro_torch.launch.steps.adamw_update`` (the global norm,
the clipping and the update of every leaf and its moments)."""

SPANS = {"optimizer": [("repro_torch.launch.steps", "adamw_update")]}


def read(t):
    ms = t.region_ms("optimizer")
    if t.mode != "train" or ms is None or not t.units:
        return None
    return ms / t.units
