"""The cluster model of the paper: workloads, traces and the batched fluid
surrogate of the event engine, whose scan runs on the card."""
