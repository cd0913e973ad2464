"""The attention kernels' share of their roofline in prefill: for every call
of the forward (K1) recorded in the traced window, the least time its shapes allow
(``bench.harness.yardstick``: operations over the bf16 peak or bytes over
3.35 TB/s, whichever is larger), summed, over the device time of the
kernels of those calls, found by their names."""
from bench.harness import yardstick

MODE = "prefill"
SPANS = {"attn_fwd": [("repro_torch.kernels.flash_attention.ops", "flash_attention_fwd")]}
# region -> (the least time of one call, the names of its CUDA kernels)
BOUNDS = {"attn_fwd": (yardstick.attention_fwd_s, r"\bfa_fwd_")}


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
