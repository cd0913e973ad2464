"""The cluster model of the paper: workloads, traces, the discrete-event
engine (pure Python on the host) and its batched fluid surrogate, whose
scan runs on the card."""
