"""The card's idle share of a traced window of prefill batches: 100 less the
share of the window in which some operation ran on it (the union of the
operations' intervals in the profiler's trace)."""

MODE = "prefill"


def read(t):
    if t.mode != MODE:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
