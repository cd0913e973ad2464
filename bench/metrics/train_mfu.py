"""The whole training step's share of the card's dense bf16 peak: the
model's operations in the traced window (three forward passes a step, the
active parameters and causal attention, remat's recompute left out; the
reference family's ``forward_flops``) over the window's seconds and 989
TFLOP/s."""
from bench.harness.yardstick import PEAK_BF16_FLOPS

MODE = "train"


def read(t):
    if t.mode != MODE or not t.units:
        return None
    return 100.0 * t.model_flops / t.window_s / PEAK_BF16_FLOPS
