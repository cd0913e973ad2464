"""The attention kernels' share of their roofline in training: for every call
of the forward (K1) and the backward (K1b) recorded in the traced window, the least time its shapes allow
(``bench.harness.yardstick``: operations over the bf16 peak or bytes over
3.35 TB/s, whichever is larger), summed, over the device time of the
kernels of those calls, found by their names."""
from bench.harness import yardstick

MODE = "train"
SPANS = {"attn_fwd": [("repro_torch.kernels.flash_attention.ops", "flash_attention_fwd")],
         "attn_bwd": [("repro_torch.kernels.flash_attention.ops", "flash_attention_bwd")]}
# region -> (the least time of one call, the names of its CUDA kernels)
BOUNDS = {"attn_fwd": (yardstick.attention_fwd_s, r"\bfa_fwd_"),
          "attn_bwd": (yardstick.attention_bwd_s, r"\bfa_bwd_")}


def read(t):
    if t.mode != MODE:
        return None
    least = device_ms = 0.0
    for region, (fn, kernels) in BOUNDS.items():
        if not t.calls.get(region):
            continue
        least += sum(yardstick.call_least_s(fn, c) for c in t.calls[region])
        device_ms += t.kernel_ms(kernels)
    if not device_ms:
        return None
    return 100.0 * least * 1e3 / device_ms
